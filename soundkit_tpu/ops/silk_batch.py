"""Device SILK synthesis: batched LTP/LPC scan + unmix + 48 kHz FIR.

Split of the SILK voice path: the host walk
(native/src/silk_parse.cpp skt_silk_parse_many) range-decodes every
lane's frame and exports the synthesis inputs; this module runs the
synthesis — the per-sample LTP/LPC predictor recursion, the stereo
mid/side unmix, and the oracle-matched polyphase resample to
48 kHz — as ONE jitted step over ``[B, 2, ...]`` lanes with carried
device state, the same shape ``ops/adpcm.py`` batches the G.72x
predictor scans.

The resampler is the table that ``utils/swr.SilkResampler`` evaluates
on the host (per-phase FIR taps, output offset and start-up
correction), laid out as static gather/tap matrices, so the device
reproduces the host stream sample-for-sample.

Numerics: with float64 inputs the scan matches the C++ synthesis to
FMA-contraction level (<1e-12); serving runs float32 (≥90 dB vs the
host, tests/test_silk_device.py).

Reference role: the libopus SILK decode inside soundkit-opus
(soundkit-opus/src/lib.rs:295-430), re-split host-parse/device-synth
for the stream-batch architecture.
"""
from __future__ import annotations

import functools
import numpy as np

from soundkit_tpu.utils.swr import _table

LTP_ORDER = 5
HIST = 322            # silk_parse.cpp SILK_HISTORY
MAXLAG = 290          # silk_parse.cpp SILK_MAX_LAG
SUBFRAMES = 4         # 20 ms packets (the batched serving shape)
FRAME48 = 960

# per-bandwidth static geometry: internal rate, subframe length
SFL = (40, 60, 80)
ORDER = (10, 10, 16)
RATE = (8000, 12000, 16000)

#: full-precision products: the LTP/LPC synthesis is recursive, so a
#: float32 product rounded to TF32 (the GPU's default for f32 matmul
#: and einsum) would accumulate into the carried state
HI = "highest"


def _resample_plan(bw: int):
    """Static gather/tap matrices for one frame's 960-sample slot.

    Slot f covers y[960f + off_, 960(f+1) + off_) with
    off_ = min(off, 0); the first slot's leading |off_| samples are
    stream-invalid (the model accounts for them in lengths)."""
    taps, off, _, _ = _table(bw)
    R, J = taps.shape
    off_ = min(off, 0)
    s = np.arange(FRAME48)
    q = (off_ + s - off) // R
    p = (off_ + s - off) % R
    T = max(0, int(-(q.min() - (J - 1))))  # input tail length
    idx = q[:, None] - np.arange(J)[None, :] + T          # [960, J]
    tap_m = taps[p]                                       # [960, J]
    lead_invalid = -off_
    return idx.astype(np.int32), tap_m, T, lead_invalid


@functools.lru_cache(maxsize=8)
def first_slot_correction(bw: int) -> np.ndarray:
    """Slot-0 correction ``C [960, K0]``.

    The resampler's stream start is linear but TIME-VARYING for the
    first few outputs (it emits before a full filter window of input
    exists — at NB the first 23 samples deviate up to 3e-4 from the
    steady-state FIR).  The table's start-up correction gives the
    exact start map; it is added once on each lane's first round:
        y_slot0 = plan(x) + x[:K0] @ C.T
    Rows of the stream-invalid lead stay zero."""
    corr = _table(bw)[3]                     # [stream outputs, inputs]
    lead = _resample_plan(bw)[3]
    K0 = min(corr.shape[1], RATE[bw] // 50)
    C = np.zeros((FRAME48, K0), np.float64)
    C[lead:] = corr[: FRAME48 - lead, :K0]
    return C


def synth_frame(dtype, sfl: int, order: int):
    """Pure-jax single-frame synthesis for one channel axis.

    All arrays carry a leading [B, C] batch; returns the new
    (out_buf, lpch_tail) where out_buf is [B, C, HIST + flen] (old
    history + this frame's clamped output)."""
    import jax.numpy as jnp
    from jax import lax

    flen = sfl * SUBFRAMES

    def run(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
            out_hist, lpch_tail):
        B, C = exc.shape[:2]
        one = jnp.asarray(1.0, dtype)
        dst = jnp.concatenate(
            [out_hist, jnp.zeros((B, C, flen), dtype)], axis=-1)
        res = jnp.concatenate(
            [jnp.zeros((B, C, MAXLAG), dtype), exc[..., :flen]], axis=-1)
        voi = voiced[..., None].astype(bool)
        lead = has_leadin[..., None].astype(bool)

        for i in range(SUBFRAMES):
            r0 = MAXLAG + i * sfl
            d0 = HIST + i * sfl
            if i < 2:
                coeff = jnp.where(lead, coef[:, :, 0], coef[:, :, 1])
            else:
                coeff = coef[:, :, 1]
            g_i = gains[..., i]

            # --- re-whitening of past output into residual (voiced):
            # j in [-lag-2, out_end) relative to the subframe start;
            # an FIR over fixed history, vectorized over the maximal
            # window [-W, 0) and masked per lane (max lag 288, so
            # start >= -290 = -MAXLAG)
            W = MAXLAG
            seg = dst[..., d0 - W : d0]                   # [B,C,W]
            hist_w = jnp.stack(
                [dst[..., d0 - W - 1 - k : d0 - 1 - k]
                 for k in range(order)], axis=-1)          # [B,C,W,order]
            v = seg - jnp.einsum("bcwk,bck->bcw", hist_w,
                                 coeff[..., :order], precision=HI)
            v = jnp.clip(v, -one, one)
            if i < 2:
                out_end = jnp.full((B, C), -i * sfl, jnp.int32)
                rescale = ltpscale
            else:
                out_end = jnp.where(has_leadin != 0, -(i - 2) * sfl,
                                    -i * sfl).astype(jnp.int32)
                rescale = jnp.where(has_leadin != 0, one, ltpscale)
            jgrid = jnp.arange(-W, 0)
            start = (-lags[..., i] - LTP_ORDER // 2)[..., None]
            m_new = (voi & (jgrid >= start)
                     & (jgrid < out_end[..., None]))
            new_res = v * (rescale / g_i)[..., None]
            old = res[..., r0 - W : r0]
            merged = jnp.where(m_new, new_res, old)
            if i > 0:
                m_sc = voi & (jgrid >= out_end[..., None])
                ratio = (gains[..., i - 1] / g_i)[..., None]
                merged = jnp.where(m_sc, merged * ratio, merged)
            res = lax.dynamic_update_slice_in_dim(
                res, merged, r0 - W, axis=-1)

            # --- fused LTP + LPC scan over the subframe
            lag_i = lags[..., i]                           # [B,C] i32
            taps_i = ltp[:, :, i]                          # [B,C,5]
            gath_base = (r0 - lag_i + LTP_ORDER // 2)[..., None] \
                - jnp.arange(LTP_ORDER)                    # [B,C,5]

            def body(carry, j):
                res_c, tail = carry
                idx = gath_base + j
                past = jnp.take_along_axis(res_c, idx, axis=-1)
                e_j = lax.dynamic_index_in_dim(
                    res_c, r0 + j, axis=-1, keepdims=False)
                ltp_v = jnp.einsum("bck,bck->bc", taps_i, past,
                                   precision=HI)
                r_j = e_j + jnp.where(voiced.astype(bool), ltp_v, 0.0)
                res_c = lax.dynamic_update_index_in_dim(
                    res_c, r_j, r0 + j, axis=-1)
                u = r_j * g_i + jnp.einsum(
                    "bck,bck->bc", coeff[..., :order],
                    tail[..., :order], precision=HI)
                tail = jnp.concatenate(
                    [u[..., None], tail[..., :-1]], axis=-1)
                return (res_c, tail), (u, jnp.clip(u, -one, one))

            (res, lpch_tail), (_, dvals) = lax.scan(
                body, (res, lpch_tail), jnp.arange(sfl))
            dst = lax.dynamic_update_slice_in_dim(
                dst, jnp.moveaxis(dvals, 0, -1), d0, axis=-1)
        return dst, lpch_tail

    return run


@functools.lru_cache(maxsize=16)
def _round_fn(bw: int, stereo: bool, dtype_name: str):
    """Raw (un-jitted) serving round for one bandwidth group:
    synthesis for both coded channels, unmix, resample, with per-lane
    validity/coded masks and frozen state for inactive lanes.  Jitted
    directly by :func:`_jitted_step` and scanned over stacked rounds
    by :func:`_jitted_scan` (the hybrid chunk path)."""
    import jax.numpy as jnp

    from soundkit_tpu.codecs.opus_tables import tables

    dtype = jnp.dtype(dtype_name)
    sfl, order = SFL[bw], ORDER[bw]
    flen = sfl * SUBFRAMES
    idx_np, taps_np, T, _ = _resample_plan(bw)
    corr_np = first_slot_correction(bw)
    n1 = int(tables()["silk_stereo_interp_len"][bw])
    run = synth_frame(dtype, sfl, order)

    def step(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
             ch_coded, unmix, side_reset, stereo_w, gain48, valid,
             fresh, out_hist, lpch_tail, rs_tail):
        one = jnp.asarray(1.0, dtype)
        # fresh lanes (first round after recycle) start from zero state
        fr = (fresh != 0)[:, None, None]
        out_hist = jnp.where(fr, 0.0, out_hist)
        lpch_tail = jnp.where(fr, 0.0, lpch_tail)
        rs_tail = jnp.where(fr, 0.0, rs_tail)
        zero_side = (side_reset != 0)[:, None, None]
        out_hist = jnp.where(
            zero_side & (jnp.arange(2) == 1)[None, :, None],
            0.0, out_hist)
        lpch_tail = jnp.where(
            zero_side & (jnp.arange(2) == 1)[None, :, None],
            0.0, lpch_tail)

        dst, lpch2 = run(exc, gains, coef, has_leadin, voiced, lags,
                         ltp, ltpscale, out_hist, lpch_tail)
        act = ((ch_coded != 0) & valid[:, None])[..., None]
        new_hist = jnp.where(act, dst[..., flen:], out_hist)
        new_lpch = jnp.where(act, lpch2, lpch_tail)

        # mono path: the 2-sample-delayed mid channel
        mono = dst[:, 0, HIST - 2 : HIST - 2 + flen]
        if stereo:
            # windows [B, flen+2] over the post-shift history; frozen
            # channels read their (unshifted) carried history instead
            def win(c):
                live = dst[:, c, HIST - 2 : HIST + flen]
                froz = out_hist[:, c, HIST - flen - 2 : HIST]
                return jnp.where(act[:, c], live, froz)

            mid, side = win(0), win(1)
            cgrid = jnp.arange(flen)
            w0p, w1p = stereo_w[:, 0:1], stereo_w[:, 1:2]
            w0, w1 = stereo_w[:, 2:3], stereo_w[:, 3:4]
            t = jnp.minimum(cgrid, n1).astype(dtype) / n1
            i0 = w0p + t * (w0 - w0p)
            i1 = w1p + t * (w1 - w1p)
            p0 = 0.25 * (mid[:, :-2] + 2.0 * mid[:, 1:-1] + mid[:, 2:])
            m1 = mid[:, 1:-1]
            s1 = side[:, 1:-1]
            left = jnp.clip((1.0 + i1) * m1 + s1 + i0 * p0, -one, one)
            right = jnp.clip((1.0 - i1) * m1 - s1 - i0 * p0, -one, one)
            # packet-coded-stereo drives the unmix: a midonly packet
            # (side frame absent, ch_coded[:,1]==0) still unmixes with
            # the zeroed side history (opus_silk.py:149-160)
            st_flag = (unmix != 0)[:, None]
            pcm = jnp.stack(
                [jnp.where(st_flag, left, mono),
                 jnp.where(st_flag, right, mono)], axis=1)
        else:
            # mono group: duplicate across the fixed 2-channel state
            # axis (the model slices its output channel count)
            pcm = jnp.stack([mono, mono], axis=1)

        # polyphase resample to 48 kHz (the swr table's taps), plus its
        # time-varying stream-start correction on fresh lanes
        x_ext = jnp.concatenate([rs_tail, pcm], axis=-1)
        wins = x_ext[..., jnp.asarray(idx_np + 0)]         # [B,C,960,J]
        y = jnp.einsum("bcsj,sj->bcs", wins,
                       jnp.asarray(taps_np, dtype), precision=HI)
        K0 = corr_np.shape[1]
        y = y + fresh[:, None, None] * jnp.einsum(
            "bck,sk->bcs", pcm[..., :K0], jnp.asarray(corr_np, dtype),
            precision=HI)
        y = y * gain48[:, None, None]
        new_tail = x_ext[..., x_ext.shape[-1] - (T):]
        v3 = valid[:, None, None]
        return (jnp.where(v3, y, 0.0),
                jnp.where(v3, new_hist, out_hist),
                jnp.where(v3, new_lpch, lpch_tail),
                jnp.where(v3, new_tail, rs_tail))

    return step


@functools.lru_cache(maxsize=16)
def _jitted_step(bw: int, stereo: bool, dtype_name: str):
    import jax

    return jax.jit(_round_fn(bw, stereo, dtype_name),
                   donate_argnums=(15, 16, 17))


@functools.lru_cache(maxsize=16)
def _jitted_scan(bw: int, stereo: bool, dtype_name: str):
    """R stacked rounds as ONE jitted lax.scan over the round axis
    (the hybrid chunk path: one dispatch per R rounds instead of R).
    Per-round inputs carry a leading [R] axis; ``gain48`` is
    round-invariant; the three state planes scan through."""
    import jax
    from jax import lax

    step = _round_fn(bw, stereo, dtype_name)

    def scan(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
             ch_coded, unmix, side_reset, stereo_w, gain48, valid,
             fresh, out_hist, lpch_tail, rs_tail):
        xs = (exc, gains, coef, has_leadin, voiced, lags, ltp,
              ltpscale, ch_coded, unmix, side_reset, stereo_w, valid,
              fresh)

        def body(carry, x):
            oh, lp, rt = carry
            (e, g, c, hl, vo, la, lt, ls, cc, um, sr, sw, va, fr) = x
            y, oh, lp, rt = step(e, g, c, hl, vo, la, lt, ls, cc, um,
                                 sr, sw, gain48, va, fr, oh, lp, rt)
            return (oh, lp, rt), y

        (oh, lp, rt), ys = lax.scan(
            body, (out_hist, lpch_tail, rs_tail), xs)
        return ys, oh, lp, rt

    return jax.jit(scan, donate_argnums=(15, 16, 17))


def silk_round(bw: int, stereo: bool, exc, gains, coef, has_leadin,
               voiced, lags, ltp, ltpscale, ch_coded, unmix,
               side_reset, stereo_w, gain48, valid, fresh, out_hist,
               lpch_tail, rs_tail):
    """Dispatch one lockstep round for one bandwidth group.

    Array args are host or device arrays; dtype follows ``exc``;
    ``unmix`` flags lanes whose packet coded stereo this round (a
    midonly packet still unmixes, with zeroed side history); ``fresh``
    flags lanes on their first stream round (stream-start resampler
    correction).  Returns (pcm48 [B, C, 960] device, new
    out_hist/lpch_tail/rs_tail device arrays)."""
    import jax.numpy as jnp

    dtype = jnp.asarray(exc).dtype
    step = _jitted_step(bw, stereo, str(dtype))
    return step(exc, gains, coef, has_leadin, voiced, lags, ltp,
                ltpscale, ch_coded, unmix, side_reset, stereo_w,
                gain48, valid, jnp.asarray(fresh, dtype), out_hist,
                lpch_tail, rs_tail)


def init_state(B: int, bw: int, dtype=np.float32):
    """Zero carried state for one bandwidth group: (out_hist
    [B,2,HIST], lpch_tail [B,2,16], rs_tail [B,2,T])."""
    _, _, T, _ = _resample_plan(bw)
    return (np.zeros((B, 2, HIST), dtype),
            np.zeros((B, 2, 16), dtype),
            np.zeros((B, 2, T), dtype))


def lead_invalid(bw: int) -> int:
    """Stream-invalid leading samples in a lane's FIRST 48 kHz slot
    (negative resampler offset at this bandwidth)."""
    return _resample_plan(bw)[3]
