"""G.711 mu-law / A-law companding as branch-free vector ops.

Behavioral equivalent of the reference's scalar segment-based
companding (``soundkit-g711/src/lib.rs``: bias 0x84, clip 32635,
``SEGMENT_ENDS`` table at :5-14, encode/decode at :235-315), recast
for batching: every sample is decoded/encoded with pure elementwise
integer arithmetic instead of per-sample branching or a
table gather, so the op vectorizes over ``[streams, samples]`` batches
and fuses into surrounding XLA computations.

The same generic implementation serves numpy (host streaming path) and
jax.numpy (batched device path) by parameterizing on the array module.
"""
from __future__ import annotations

import numpy as np

try:  # jax is required for the device path, optional for host-only use
    import jax
    import jax.numpy as jnp
except Exception:  # pragma: no cover
    jax = None
    jnp = None

ULAW_BIAS = 0x84
ULAW_CLIP = 32635
SEGMENT_ENDS = np.array(
    [0x00FF, 0x01FF, 0x03FF, 0x07FF, 0x0FFF, 0x1FFF, 0x3FFF, 0x7FFF], dtype=np.int32
)


# ---------------------------------------------------------------------------
# generic (xp = numpy or jax.numpy), int32 domain
# ---------------------------------------------------------------------------

def _decode_mulaw(xp, codes):
    """u8 codes -> i16 samples (lib.rs:256-269), elementwise."""
    s = 255 - codes.astype(xp.int32)  # bitwise NOT within u8
    magnitude = ((s & 0x0F) << 3) + ULAW_BIAS
    magnitude = magnitude << ((s & 0x70) >> 4)
    negative = (s & 0x80) != 0
    decoded = xp.where(negative, ULAW_BIAS - magnitude, magnitude - ULAW_BIAS)
    return decoded.astype(xp.int16)


def _decode_alaw(xp, codes):
    """u8 codes -> i16 samples (lib.rs:296-315), elementwise."""
    s = codes.astype(xp.int32) ^ 0x55
    segment = (s & 0x70) >> 4
    magnitude = (s & 0x0F) << 4
    magnitude = xp.where(
        segment == 0,
        magnitude + 8,
        (magnitude + 0x108) << xp.maximum(segment - 1, 0),
    )
    return xp.where((s & 0x80) != 0, magnitude, -magnitude).astype(xp.int16)


def _segment_for(xp, pcm):
    """Index of first SEGMENT_ENDS >= pcm == count of ends < pcm (lib.rs:317-322)."""
    ends = xp.asarray(SEGMENT_ENDS, dtype=xp.int32)
    # pcm: [...,], ends: [8] -> count via comparisons, stays elementwise
    return xp.sum(pcm[..., None] > ends, axis=-1).astype(xp.int32)


def _encode_mulaw(xp, samples):
    """i16 samples -> u8 codes (lib.rs:235-254), elementwise."""
    pcm = samples.astype(xp.int32)
    negative = pcm < 0
    mask = xp.where(negative, 0x7F, 0xFF)
    pcm = xp.where(negative, ULAW_BIAS - pcm, pcm + ULAW_BIAS)
    pcm = xp.minimum(pcm, ULAW_CLIP)
    segment = _segment_for(xp, pcm)
    encoded = (segment << 4) | ((pcm >> (segment + 3)) & 0x0F)
    return ((encoded ^ mask) & 0xFF).astype(xp.uint8)


def _encode_alaw(xp, samples):
    """i16 samples -> u8 codes (lib.rs:271-294), elementwise."""
    pcm = samples.astype(xp.int32)
    negative = pcm < 0
    mask = xp.where(negative, 0x55, 0xD5)
    pcm = xp.where(negative, -pcm - 1, pcm)
    segment = _segment_for(xp, pcm)
    low = xp.where(segment < 2, (pcm >> 4) & 0x0F, (pcm >> (segment + 3)) & 0x0F)
    encoded = (segment << 4) | low
    return ((encoded ^ mask) & 0xFF).astype(xp.uint8)


# ---------------------------------------------------------------------------
# host (numpy) entry points
# ---------------------------------------------------------------------------

def decode_mulaw_np(codes: np.ndarray) -> np.ndarray:
    return _decode_mulaw(np, np.asarray(codes, dtype=np.uint8))


def decode_alaw_np(codes: np.ndarray) -> np.ndarray:
    return _decode_alaw(np, np.asarray(codes, dtype=np.uint8))


def encode_mulaw_np(samples: np.ndarray) -> np.ndarray:
    return _encode_mulaw(np, np.asarray(samples, dtype=np.int16))


def encode_alaw_np(samples: np.ndarray) -> np.ndarray:
    return _encode_alaw(np, np.asarray(samples, dtype=np.int16))


# ---------------------------------------------------------------------------
# device (jax) entry points — jittable, any leading batch shape
# ---------------------------------------------------------------------------

def decode_mulaw(codes):
    """``uint8[..., n] -> int16[..., n]`` on device."""
    return _decode_mulaw(jnp, codes)


def decode_alaw(codes):
    return _decode_alaw(jnp, codes)


def encode_mulaw(samples):
    return _encode_mulaw(jnp, samples)


def encode_alaw(samples):
    return _encode_alaw(jnp, samples)


def decode_g711(codes, is_alaw):
    """Law-selectable decode; ``is_alaw`` may be a traced bool scalar or a
    per-stream bool vector broadcastable against ``codes``'s batch dims."""
    mu = _decode_mulaw(jnp, codes)
    al = _decode_alaw(jnp, codes)
    is_alaw = jnp.asarray(is_alaw)
    while is_alaw.ndim < codes.ndim:
        is_alaw = is_alaw[..., None]
    return jnp.where(is_alaw, al, mu)
