"""Backend placement, compile-cache and GPU card helpers.

The single-stream host streaming API (``G726Decoder`` etc.) decodes
small chunks one call at a time.  Each chunk's scan is far too small
to be worth a device dispatch and a host round trip, so these codecs
pin their jitted scans to the in-process CPU backend.  The
accelerator path is the *batched* decoders.
"""
from __future__ import annotations

import functools
import os
import subprocess
from pathlib import Path

#: in-checkout persistent compile cache, used when the environment
#: names none (a fixed path: the cache key includes it)
COMPILE_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


@functools.lru_cache(maxsize=1)
def cpu_device():
    import jax

    return jax.devices("cpu")[0]


def host_jit(fn):
    """jit ``fn`` pinned to the host CPU backend."""
    import jax

    jitted = jax.jit(fn)

    def wrapper(*args, **kwargs):
        with jax.default_device(cpu_device()):
            return jitted(*args, **kwargs)

    return wrapper


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  ``JAX_COMPILATION_CACHE_DIR``, when set, is left to
    JAX and nothing is changed; otherwise the cache lives in
    ``.jax_cache/`` at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    return str(COMPILE_CACHE_DIR)


def gpu_card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (a card may be capped below its maximum limit)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
