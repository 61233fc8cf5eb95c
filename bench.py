"""Plain runner: batched AAC-LC decode of 1024 distinct streams.

    python bench.py [--passes N] [--batches N]

Measures the flagship path per frame batch over 1024 stereo streams of
the corpus AAC-LC clip (``corpus/music_aac_lc_48k.aac``), lane i
decoding AU (t + i) mod n at step t so neighbouring lanes differ:

  C++ host syntax parse (ADTS AUs -> v4 wire: metadata + raw AU bytes,
  length-only spectral walk) + one jitted device step that decodes the
  spectral Huffman codes on device (ops/aac_entropy.py), then dequant,
  stereo, TNS, matmul IMDCT, windowing and overlap-add.

One warmup batch compiles the step; then ``--passes`` passes of
``--batches`` batches each are timed, each batch ending in
``block_until_ready``.  x realtime counts audio at the clip's own rate.
Prints the card and its power limit, then one JSON line with the
median pass, the spread and every pass.  Needs a GPU: on any other
backend it exits non-zero without a result.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

LANES = 1024
CLIP = "music_aac_lc_48k.aac"


def setup(batches: int):
    """The corpus clip's AUs and the jitted v4 step at LANES lanes.

    Returns (parse, step, max_steps, rate): ``parse(t)`` builds batch
    t's packed v4 wire (lane i decodes AU (t + i) mod n); the scan
    length is the worst of the first ``batches`` batches, rounded up to
    a power of two, so the step compiles once."""
    import jax

    from corpus import make_corpus as mc
    from soundkit_tpu.codecs.aac_lc import SAMPLE_RATES, AdtsStream
    from soundkit_tpu.codecs.aac_lc_native import (
        NativeAacParser,
        prepare_v4_batch_packed,
    )
    from soundkit_tpu.ops import aac_batch as ab

    stream = AdtsStream()
    aus = stream.push(mc.load(CLIP))
    n = len(aus)
    parser = NativeAacParser(stream.sr_index)
    step = jax.jit(ab.aac_decode_frame_device_v4_packed,
                   donate_argnums=(1, 2), static_argnums=(3,))

    def parse(t):
        buf, steps, overflow = prepare_v4_batch_packed(
            parser, [aus[(t + i) % n] for i in range(LANES)])
        if overflow:
            raise RuntimeError("v4 wire overflow on the corpus clip")
        return buf, steps

    max_steps = 256
    worst = max(parse(t)[1] for t in range(min(n, batches)))
    while max_steps < worst:
        max_steps *= 2
    return parse, step, max_steps, SAMPLE_RATES[stream.sr_index]


def init_state():
    import jax.numpy as jnp

    from soundkit_tpu.ops import aac_batch as ab

    return tuple(jnp.asarray(a) for a in ab.init_state(LANES))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--batches", type=int, default=46)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    from soundkit_tpu.utils.backend import enable_compile_cache, gpu_card

    enable_compile_cache()
    print(f"card: {gpu_card()}", flush=True)
    parse, step, max_steps, rate = setup(args.batches)

    def one_pass() -> float:
        saved, prev = init_state()
        t0 = time.perf_counter()
        for t in range(args.batches):
            buf, _ = parse(t)
            pcm, saved, prev = step(buf, prev, saved, max_steps)
            pcm.block_until_ready()
        return args.batches * LANES * 1024 / rate / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    saved, prev = init_state()
    step(parse(0)[0], prev, saved, max_steps)[0].block_until_ready()
    warmup_s = time.perf_counter() - t0
    passes = sorted(one_pass() for _ in range(args.passes))
    median = passes[len(passes) // 2]
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "aac_lc_1024_streams_x_realtime",
        "value": round(median, 1),
        "unit": "x_realtime",
        "spread": [round(passes[0], 1), round(passes[-1], 1)],
        "passes": [round(p, 1) for p in passes],
        "warmup_s": round(warmup_s, 2),
        "max_steps": max_steps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
