"""Batched FLAC encode ANALYSIS on device.

The device-batched encode path the reference has no analog of (its pure
frame encoder, soundkit-flac/src/frame_codec.rs:42-278, is a
single-stream scalar loop): the expensive per-block analysis — stereo
decorrelation search, fixed-predictor order selection, Welch-windowed
autocorrelation + Levinson-Durbin LPC fit, coefficient quantization,
and the exact integer prediction residuals — runs as ONE jitted map
over [B] lanes with no sequential scan at all (encode prediction is
feed-forward over known samples, unlike the decode recurrence in
ops/flac_lpc.py).  The host keeps only the entropy stage: Rice
parameter/partition search and bit packing (codecs/flac_encode.py),
which is numpy-vectorized per frame.

Exactness: residuals are computed with the decoder's integer
semantics (int64 products, arithmetic >> shift) under
``jax.experimental.enable_x64``, so the emitted stream round-trips
bit-exactly regardless of which backend ran the analysis.

Wire back to host per block: residuals [B, 2, N] int32, plans
(assign/kind/order/shift [B, 2], qlp [B, 2, 8]) — ~32 KB + 8·B bytes
per 4096-sample block at B=16.
"""
from __future__ import annotations

import functools

import numpy as np

LPC_ORDER = 8
LPC_PRECISION = 14
MAX_FIXED = 4

# stereo assignment codes (FLAC frame header) -> candidate-channel
# indices in the (L, R, S, M) stack
ASSIGN_CODES = (1, 8, 9, 10)           # LR, LS, RS, MS
ASSIGN_SLOTS = ((0, 1), (0, 2), (2, 1), (3, 2))


def _rice_est_cost(res, n_valid, jnp):
    """Estimated Rice cost of ``res`` [..., N] over its first
    ``n_valid`` samples: k from the folded-mean magnitude (the same
    starting estimate _best_rice_k refines), cost = sum(u>>k)+n(k+1)."""
    u = (res << 1) ^ (res >> 63)                    # zigzag, int64
    tot = jnp.sum(u, axis=-1)
    mean = tot // jnp.maximum(n_valid, 1)
    # k = bit_length(mean) - 1  (0 when mean < 1)
    k = jnp.maximum(63 - _clz64(mean, jnp) - 1, 0)
    cost = jnp.sum(u >> k[..., None], axis=-1) + n_valid * (1 + k)
    return cost


def _clz64(v, jnp):
    """Count leading zeros of a non-negative int64 via float64 log2
    (exact for the magnitudes here: predictor sums < 2^40)."""
    f = jnp.where(v > 0, v, 1).astype(jnp.float64)
    bl = jnp.floor(jnp.log2(f)).astype(jnp.int64) + 1   # bit_length
    return jnp.where(v > 0, 64 - bl, 64)


def flac_analyze_device(x, n_valid, bits):
    """Plan one FLAC block for every lane.

    x        [B, 2, N] int64 samples (channel 1 ignored for mono)
    n_valid  scalar int64 — samples actually present (<= N, same for
             all lanes; ragged lanes are handled by the host model)
    bits     python int (static): declared bit depth

    Returns (assign, kind, order, shift, qlp, res):
      assign [B]       int32 frame-header channel assignment code
      kind   [B, 2]    int32 0=fixed 1=lpc   (slot 1 unused for mono)
      order  [B, 2]    int32
      shift  [B, 2]    int32 (lpc only)
      qlp    [B, 2, 8] int32 quantized LPC coefficients
      res    [B, 2, N] int32 residuals, aligned at [order:n_valid]
    """
    import jax.numpy as jnp

    B, C, N = x.shape
    L, R = x[:, 0, :], x[:, 1, :]
    side = L - R
    mid = (L + R) >> 1
    cand = jnp.stack([L, R, side, mid], axis=1)        # [B, 4, N]
    nc = cand.shape[1]

    valid = jnp.arange(N) < n_valid                     # [N]
    cand = jnp.where(valid[None, None, :], cand, 0)

    # ---- fixed predictors 0..4: order by min sum|diff| (libFLAC's
    # heuristic), residual kept for every order, cost for the winner
    diffs = [cand]
    for _ in range(MAX_FIXED):
        d = diffs[-1]
        diffs.append(d[..., 1:] - d[..., :-1])
    # pad to N and mask to the valid residual span [order, n_valid)
    fixed_res = []
    fixed_abs = []
    for o, d in enumerate(diffs):
        pad = jnp.zeros((B, nc, o), dtype=d.dtype)
        r = jnp.concatenate([pad, d], axis=-1)
        span = (jnp.arange(N) >= o) & valid
        r = jnp.where(span[None, None, :], r, 0)
        fixed_res.append(r)
        fixed_abs.append(jnp.sum(jnp.abs(r), axis=-1))
    fixed_abs = jnp.stack(fixed_abs, axis=-1)           # [B, 4, 5]
    fixed_order = jnp.argmin(fixed_abs, axis=-1)        # [B, 4]
    fixed_stack = jnp.stack(fixed_res, axis=2)          # [B, 4, 5, N]
    fres = jnp.take_along_axis(
        fixed_stack, fixed_order[:, :, None, None], axis=2
    )[:, :, 0, :]                                       # [B, 4, N]
    fcost = _rice_est_cost(fres, n_valid - fixed_order, jnp) \
        + fixed_order * bits + 8 + 6

    # ---- LPC order 8: Welch window autocorr + Levinson (f64)
    xf = cand.astype(jnp.float64)
    t = (2.0 * jnp.arange(N) - (n_valid - 1)) / jnp.maximum(n_valid - 1, 1)
    w = jnp.where(valid, 1.0 - t * t, 0.0)
    xw = xf * w[None, None, :]
    ac = jnp.stack(
        [jnp.sum(xw[..., : N - i] * xw[..., i:], axis=-1)
         for i in range(LPC_ORDER + 1)],
        axis=-1,
    )                                                   # [B, 4, 9]

    a = jnp.zeros((B, nc, LPC_ORDER), jnp.float64)
    err = ac[..., 0]
    ok = err > 0
    for i in range(LPC_ORDER):
        if i:
            hist = a[..., :i][..., ::-1]                # a reversed
            acc = ac[..., i + 1] - jnp.sum(hist * ac[..., 1 : i + 1], axis=-1)
        else:
            acc = ac[..., 1]
        k = jnp.where(ok & (err != 0), acc / jnp.where(err != 0, err, 1.0), 0.0)
        new = a[..., :i] - k[..., None] * a[..., :i][..., ::-1]
        a = a.at[..., :i].set(new).at[..., i].set(k)
        err = err * (1.0 - k * k)
        ok = ok & (err > 0)

    # quantize (codecs/flac_encode._quantize_lpc semantics)
    cmax = jnp.max(jnp.abs(a), axis=-1)
    log2cmax = jnp.floor(jnp.log2(jnp.where(cmax > 0, cmax, 1.0))) + 1.0
    shift = jnp.clip(LPC_PRECISION - log2cmax.astype(jnp.int64) - 1, 0, 15)
    lim = 1 << (LPC_PRECISION - 1)
    qlp = jnp.clip(
        jnp.round(a * (2.0 ** shift[..., None].astype(jnp.float64))),
        -lim, lim - 1,
    ).astype(jnp.int64)                                 # [B, 4, 8]
    ok = ok & jnp.any(qlp != 0, axis=-1) & (n_valid > 2 * LPC_ORDER)

    # exact integer residual: pred[i] = sum_j qlp[j]*x[i-1-j], i>=8
    pred = jnp.zeros((B, nc, N - LPC_ORDER), jnp.int64)
    for j in range(LPC_ORDER):
        pred = pred + qlp[..., j : j + 1] \
            * cand[..., LPC_ORDER - 1 - j : N - 1 - j]
    lres = cand[..., LPC_ORDER:] - (pred >> shift[..., None])
    lres = jnp.concatenate(
        [jnp.zeros((B, nc, LPC_ORDER), jnp.int64), lres], axis=-1
    )
    span = (jnp.arange(N) >= LPC_ORDER) & valid
    lres = jnp.where(span[None, None, :], lres, 0)
    lcost = _rice_est_cost(lres, n_valid - LPC_ORDER, jnp) \
        + LPC_ORDER * bits + 8 + 6 + 4 + 5 + LPC_ORDER * LPC_PRECISION
    lcost = jnp.where(ok, lcost, jnp.int64(1) << 50)

    # ---- choose kind per candidate, then the stereo assignment
    kind = (lcost < fcost).astype(jnp.int64)            # [B, 4]
    ccost = jnp.minimum(fcost, lcost)                   # [B, 4]
    if C == 2:
        combos = jnp.stack(
            [ccost[:, s0] + ccost[:, s1] for s0, s1 in ASSIGN_SLOTS],
            axis=-1,
        )                                               # [B, 4]
        best = jnp.argmin(combos, axis=-1)              # [B]
        assign = jnp.asarray(ASSIGN_CODES, jnp.int64)[best]
        slots = jnp.asarray(ASSIGN_SLOTS, jnp.int64)[best]  # [B, 2]
    else:
        assign = jnp.zeros((B,), jnp.int64)
        slots = jnp.zeros((B, 2), jnp.int64)

    def pick(arr):
        return jnp.take_along_axis(
            arr, slots.reshape(B, 2, *([1] * (arr.ndim - 2))), axis=1
        )

    res = jnp.where(
        pick(kind)[..., None].astype(bool), pick(lres), pick(fres)
    )
    order = jnp.where(pick(kind).astype(bool), LPC_ORDER, pick(fixed_order))
    return (
        assign.astype(jnp.int32),
        pick(kind).astype(jnp.int32),
        order.astype(jnp.int32),
        pick(shift).astype(jnp.int32),
        pick(qlp).astype(jnp.int32),
        res.astype(jnp.int32),
    )


@functools.lru_cache(maxsize=None)
def _jitted(bits):
    import jax

    return jax.jit(
        functools.partial(flac_analyze_device, bits=bits),
    )


def flac_analyze_x64(x, n_valid, bits):
    """Host entry: numpy int in, numpy plans out, x64 scoped."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64():
        out = _jitted(bits)(
            jnp.asarray(np.asarray(x, np.int64)), jnp.asarray(int(n_valid))
        )
        return tuple(np.asarray(o) for o in out)


@functools.lru_cache(maxsize=None)
def _jitted_i32(bits, with_res=True):
    """jit over a narrow integer sample wire (int16 when the declared
    depth fits, else int32): widening to int64 happens ON DEVICE
    (samples are <= 25 bits incl. the side channel), halving/quartering
    the h2d bytes of the PCM wire.  ``with_res=False`` drops the
    [L, 2, N] residual plane from the outputs — XLA then dead-codes
    its materialization and only the ~50 B/frame plan rows cross the
    d2h link (the native packer recomputes residuals exactly,
    native/src/flac_pack.cpp) — and the five plan tensors come back
    PACKED into one [L, 23] int32 row per block (one d2h latency
    instead of five)."""
    import jax
    import jax.numpy as jnp

    def kern(x, n_valid):
        out = flac_analyze_device(x.astype(jnp.int64), n_valid, bits)
        if with_res:
            return out
        assign, kind, order, shift, qlp = out[:-1]
        L = assign.shape[0]
        return jnp.concatenate(
            [assign[:, None], kind, order, shift, qlp.reshape(L, -1)],
            axis=-1,
        )

    return jax.jit(kern)


def flac_analyze_batch(x, n_valid, bits, fetch_res=True):
    """Serving entry: MANY independent blocks in ONE device call.

    FLAC blocks carry no cross-block analysis state, so the caller
    folds every pending (lane, round) block into the leading dim of
    ``x`` [L, 2, N].  h2d ships the narrowest integer wire that holds
    the declared depth (int16 for <=16-bit streams — half the bytes),
    the analysis runs as one jitted map, and the plans come back as
    ONE packed [L, 23] int32 row per block instead of a synchronous
    ~4 MB h2d + ~4 MB d2h per block round.

    Returns the same tuple as :func:`flac_analyze_x64`; with
    ``fetch_res=False`` the residual plane is neither materialized on
    device nor fetched, and the final element is ``None`` (the native
    packer recomputes residuals host-side from the plans).
    """
    import jax

    from soundkit_tpu.utils.wire import (
        WIRE_CHUNK_BYTES,
        from_device_chunked,
        to_device_chunked,
    )

    dt = np.int16 if (bits <= 16 and not fetch_res) else np.int32
    x = np.ascontiguousarray(np.asarray(x, dt))
    wire = to_device_chunked(
        x.reshape(-1), chunk_bytes=WIRE_CHUNK_BYTES // x.itemsize
    ).reshape(x.shape)
    with jax.enable_x64():
        out = _jitted_i32(bits, fetch_res)(wire, np.int64(n_valid))
    if fetch_res:
        assign, kind, order, shift, qlp, res = out
        return (
            np.asarray(assign), np.asarray(kind), np.asarray(order),
            np.asarray(shift), np.asarray(qlp), from_device_chunked(res),
        )
    return flac_plans_unpack(np.asarray(out))


def flac_analyze_batch_dispatch(x, n_valid, bits):
    """Ship + dispatch the plan-only analysis and return the DEVICE
    [L, 23] int32 plans array WITHOUT fetching — the caller overlaps
    host work (MD5, bookkeeping) with the device pass, then fetches
    with ``np.asarray`` and splits via :func:`flac_plans_unpack`.
    ``x`` should already be the wire dtype (int16 for <=16-bit)."""
    import jax

    from soundkit_tpu.utils.wire import WIRE_CHUNK_BYTES, to_device_chunked

    dt = np.int16 if bits <= 16 else np.int32
    x = np.ascontiguousarray(np.asarray(x, dt))
    wire = to_device_chunked(
        x.reshape(-1), chunk_bytes=WIRE_CHUNK_BYTES // x.itemsize
    ).reshape(x.shape)
    with jax.enable_x64():
        return _jitted_i32(bits, False)(wire, np.int64(n_valid))


def flac_plans_unpack(plans):
    """[L, 23] int32 plan rows -> (assign, kind, order, shift, qlp,
    None) in :func:`flac_analyze_x64`'s tuple layout."""
    L = plans.shape[0]
    return (
        plans[:, 0], plans[:, 1:3], plans[:, 3:5], plans[:, 5:7],
        np.ascontiguousarray(plans[:, 7:23]).reshape(L, 2, LPC_ORDER),
        None,
    )
