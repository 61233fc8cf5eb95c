"""Batched FLAC LPC reconstruction on device.

North-star kernel (BASELINE.json names "FLAC LPC" among the codec
inner loops to run as batched device kernels; reference:
soundkit-flac's libFLAC decode loop).  The host C++ layer
(native/src/flac.cpp, skt_flac_next_parts) does bitstream + Rice
entropy decode only and emits a unified wire:

  resw  [B, 2, T] int32 — warmup samples for n < order, else residuals
                          (CONSTANT/VERBATIM become order-0 lanes whose
                          resw IS the sample stream)
  coef  [B, 2, 32] int32 — quantized LPC coefficients (FIXED orders use
                          the canonical integer sets with shift 0)
  order/shift/wasted [B, 2] int32, chan_assign/block_size [B] int32

The device runs the exact integer recurrence
    s[n] = ((sum_k coef[k] * s[n-1-k]) >> shift) + resw[n]
as a lax.scan over time with a carried [lanes, 32] history, then the
wasted-bit shift and stereo decorrelation (left/side, right/side,
mid/side).  Arithmetic is int64 (exact, under enable_x64) so lossless
output is bit-exact — verified against the host decoder in
tests/test_flac_device.py.

Requires x64: call through ``flac_frame_device_x64`` which wraps the
jitted kernel in ``jax.experimental.enable_x64``.
"""
from __future__ import annotations

import functools

import numpy as np

MAX_ORDER = 32


def flac_frame_device(resw, coef, order, shift, wasted, chan_assign,
                      block_size, lane_valid):
    """One FLAC frame for all lanes -> samples [B, 2, T] int32.

    All integer inputs must already be int64 (see module docstring).
    """
    import jax
    import jax.numpy as jnp

    B, C, T = resw.shape
    L = B * C

    r_tm = jnp.swapaxes(resw.reshape(L, T), 0, 1)        # [T, L]
    coef_l = coef.reshape(L, MAX_ORDER)
    order_l = order.reshape(L)
    shift_l = shift.reshape(L)

    def step(hist, xs):
        r, n = xs
        acc = jnp.sum(hist * coef_l, axis=1)
        pred = jnp.right_shift(acc, shift_l)             # arithmetic >>
        s = jnp.where(n < order_l, r, pred + r)
        hist = jnp.concatenate([s[:, None], hist[:, :-1]], axis=1)
        return hist, s

    hist0 = jnp.zeros((L, MAX_ORDER), dtype=resw.dtype)
    _, out_tm = jax.lax.scan(step, hist0, (r_tm, jnp.arange(T, dtype=resw.dtype)))
    s = jnp.swapaxes(out_tm, 0, 1).reshape(B, C, T)

    # wasted-bit shift (per subframe, before decorrelation — flac.cpp:267)
    s = jnp.left_shift(s, wasted[..., None].astype(s.dtype))

    # stereo decorrelation (flac.cpp decode_frame)
    a = chan_assign[:, None]
    c0, c1 = s[:, 0], s[:, 1]
    side = c1
    mid = jnp.left_shift(c0, 1) | (side & 1)
    new0 = jnp.where(a == 9, c1 + c0,
                     jnp.where(a == 10, jnp.right_shift(mid + side, 1), c0))
    new1 = jnp.where(a == 8, c0 - c1,
                     jnp.where(a == 10, jnp.right_shift(mid - side, 1), c1))
    s = jnp.stack([new0, new1], axis=1)

    n_idx = jnp.arange(T, dtype=s.dtype)
    s = jnp.where(n_idx[None, None, :] < block_size[:, None, None], s, 0)
    s = jnp.where(lane_valid[:, None, None], s, 0)
    return s.astype(jnp.int32)


@functools.lru_cache(maxsize=4)
def _jitted():
    import jax

    return jax.jit(flac_frame_device)


def flac_frame_device_x64(resw, coef, order, shift, wasted, chan_assign,
                          block_size, lane_valid) -> np.ndarray:
    """Host-convenience entry: numpy int32 wire in, int32 samples out;
    runs the jitted kernel under the x64 context for exact int64."""
    import jax

    with jax.enable_x64():
        out = _jitted()(
            np.asarray(resw, np.int64), np.asarray(coef, np.int64),
            np.asarray(order, np.int64), np.asarray(shift, np.int64),
            np.asarray(wasted, np.int64), np.asarray(chan_assign, np.int64),
            np.asarray(block_size, np.int64), np.asarray(lane_valid, bool),
        )
        return np.asarray(out)


@functools.lru_cache(maxsize=4)
def _jitted_i32():
    """jit of the frame kernel over an int32 wire: the widening to
    int64 happens ON DEVICE, halving the h2d bytes of the residual
    wire (the dominant transfer of the FLAC path)."""
    import jax
    import jax.numpy as jnp

    def kern(resw, coef, order, shift, wasted, chan_assign,
             block_size, lane_valid):
        c = lambda a: a.astype(jnp.int64)  # noqa: E731
        return flac_frame_device(
            c(resw), c(coef), c(order), c(shift), c(wasted),
            c(chan_assign), c(block_size), lane_valid,
        )

    return jax.jit(kern)


def flac_frames_device_batch(resw, coef, order, shift, wasted,
                             chan_assign, block_size, lane_valid,
                             device_out: bool = False,
                             n_keep: int | None = None):
    """Serving entry: MANY frames in ONE device call.

    FLAC frames are independent (no carried device state), so lockstep
    rounds fold straight into the lane axis: the caller collapses
    [rounds, B] to one leading dim of ``rounds*B`` lanes.  int32 wire
    h2d in sub-cliff chunks, int64 math on device, and either a
    chunked d2h fetch (host np.int32 out) or ``device_out=True`` (the
    samples stay device-resident for downstream stages; no d2h).

    (The per-round path it replaced paid a synchronous ~2.4 MB fetch
    per round.)
    """
    import jax

    from soundkit_tpu.utils.wire import (
        WIRE_CHUNK_BYTES,
        from_device_chunked,
        to_device_chunked,
    )

    def h2d(a, dt):
        a = np.ascontiguousarray(np.asarray(a, dt))
        flat = a.reshape(-1)
        return to_device_chunked(
            flat, chunk_bytes=WIRE_CHUNK_BYTES // a.itemsize
        ).reshape(a.shape)

    with jax.enable_x64():
        out = _jitted_i32()(
            h2d(resw, np.int32), h2d(coef, np.int32),
            h2d(order, np.int32), h2d(shift, np.int32),
            h2d(wasted, np.int32), h2d(chan_assign, np.int32),
            h2d(block_size, np.int32), np.asarray(lane_valid, bool),
        )
    if n_keep is not None and n_keep < out.shape[0]:
        out = out[:n_keep]  # device-side slice: never fetch the pad
    if device_out:
        # returned WITHOUT blocking: callers staging several codec
        # groups (fleet collect) must be able to dispatch them all
        # before anything waits; benches block explicitly
        return out
    return from_device_chunked(out)
