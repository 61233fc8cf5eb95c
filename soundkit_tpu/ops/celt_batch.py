"""Batched device CELT synthesis: IMDCT + overlap-add + comb postfilter
+ de-emphasis for 20 ms Opus CELT frames.

Device half of the Opus path (SURVEY §2.3 names the CELT path as
batchable).  The host layer (codecs/opus_celt.py with
``parse_only=True``) runs the range decoder, allocation, PVQ and
anti-collapse, and emits denormalized spectra; this module jits the
synthesis over ``[B, C, 960]`` lanes:

- long (960) and short (8x120) low-overlap IMDCTs as matmuls,
  selected per lane by the transient flag
- overlap-add with a carried 120-sample lap per channel
- the comb postfilter (old->current crossfade over the first 120
  samples, current->new over the rest) and the one-pole de-emphasis,
  fused into one ``lax.scan`` over 8-sample blocks: the comb lookback
  is >= 13 samples (min period 15, taps +-2), so all reads of a block
  land strictly before it — each step does two contiguous 12-wide
  gathers per lane (old/new period) instead of per-sample indexing,
  and the de-emphasis recurrence becomes a lower-triangular [8, 8]
  matmul (120 scan steps instead of 960)

Matmul precision pinned to float32 (see aac_batch: the GPU's TF32
default would cap accuracy far below the oracle bars).
Parity reference: the in-place comb/deemph chain of
soundkit-opus's libopus backend (soundkit-opus/src/lib.rs).
"""
from __future__ import annotations

import functools

import numpy as np

from soundkit_tpu.codecs.opus_celt import (
    CELT_EMPH_COEFF,
    OVERLAP,
    _imdct_matrix,
    tables,
)

N = 960          # 20 ms at 48 kHz
NB_SHORT = 120
HIST = 1200      # comb history (> max period 1024 + taps)


@functools.lru_cache(maxsize=1)
def _bases():
    """(long [960, 1080], short [120, 240]) IMDCT bases as f32."""
    return (
        _imdct_matrix(N).astype(np.float32),
        _imdct_matrix(NB_SHORT).astype(np.float32),
    )


@functools.lru_cache(maxsize=1)
def _win2():
    w = tables()["celt_window"].astype(np.float32)
    return (w * w).astype(np.float32)


def celt_synth_step(freq, short_flag, comb_params, ola, hist, emph):
    """One lockstep 20 ms frame for all lanes.

    freq:        [B, C, 960] f32 denormalized spectra (short frames
                 carry the 8 interleaved MDCTs, as decoded)
    short_flag:  [B] int32, 1 = transient (8 short blocks)
    comb_params: [B, 10] f32 — per lane:
                 [Ta0, Ta1, ga0, ga1, ga2, gb0, gb1, gb2, Tb, gbflag]
                 encoded as produced by pack_comb_params()
    ola:         [B, C, 120] f32 carried overlap
    hist:        [B, C, 1200] f32 carried filtered history
    emph:        [B, C] f32 de-emphasis memory

    Returns (pcm [B, C, 960] f32 in [-1, 1], new_ola, new_hist,
    new_emph).
    """
    import jax

    with jax.default_matmul_precision("float32"):
        return _celt_synth_step(freq, short_flag, comb_params, ola,
                                hist, emph)


def pack_comb_params(pf_state, pf_period, pf_gain, pf_tapset,
                     taps) -> np.ndarray:
    """Per-lane comb parameter vector for one frame.

    pf_state = (period_old, period, gain_old, gain, tapset_old,
    tapset) captured BEFORE the frame's rotation (the
    codecs/opus_celt.py ``last_parse['pf_state']`` tuple); pf_* are
    this frame's decoded values. Layout (16 floats):
      [T_a0, T_a1, ga0*, gb0*] stage A old/current periods + 2x3
      premultiplied tap gains, then [T_b0, T_b1, gc0*, gd0*] for
      stage B (current -> new).
    """
    p_old, p_cur, g_old, g_cur, t_old, t_cur = pf_state
    out = np.zeros(16, dtype=np.float32)
    out[0] = max(p_old, 15)
    out[1] = max(p_cur, 15)
    out[2:5] = g_old * taps[t_old]
    out[5:8] = g_cur * taps[t_cur]
    out[8] = max(p_cur, 15)
    out[9] = max(pf_period, 15)
    out[10:13] = g_cur * taps[t_cur]
    out[13:16] = pf_gain * taps[pf_tapset]
    return out


def _celt_synth_step(freq, short_flag, comb_params, ola, hist, emph):
    import jax
    import jax.numpy as jnp
    from jax import lax

    B, C, _ = freq.shape
    long_m, short_m = _bases()
    ML = jnp.asarray(long_m)        # [960, 1080]
    MS = jnp.asarray(short_m)       # [120, 240]

    flat = freq.reshape(B * C, N)
    full_long = flat @ ML           # [B*C, 1080]

    # short blocks: deinterleave (block b = bins b::8), 8 IMDCTs at
    # hop 120 overlap-added into the same 1080 span
    blocks = flat.reshape(B * C, NB_SHORT, 8)   # [.., bin, block]
    short_pcm = jnp.einsum("ikb,kt->ibt", blocks, MS)  # [.., 8, 240]
    full_short = jnp.zeros((B * C, N + OVERLAP), freq.dtype)
    for b in range(8):
        full_short = full_short.at[:, b * NB_SHORT : b * NB_SHORT + 2 * NB_SHORT].add(
            short_pcm[:, b]
        )

    full = jnp.where(
        (short_flag == 1)[:, None, None].repeat(C, 1).reshape(B * C, 1),
        full_short,
        full_long,
    ).reshape(B, C, N + OVERLAP)

    full = full.at[..., :OVERLAP].add(ola)
    new_ola = full[..., N:]
    frame = full[..., :N]

    # fused comb postfilter + de-emphasis, blocked scan (8/step)
    BLK = 8
    x = jnp.concatenate([hist, frame], axis=-1)   # [B, C, HIST+960]
    w2 = _win2()
    cp = comb_params                               # [B, 16]
    Ta0 = cp[:, 0].astype(jnp.int32)
    Ta1 = cp[:, 1].astype(jnp.int32)
    ga = cp[:, 2:5]
    gb = cp[:, 5:8]
    Tb0 = cp[:, 8].astype(jnp.int32)
    Tb1 = cp[:, 9].astype(jnp.int32)
    gc = cp[:, 10:13]
    gd = cp[:, 13:16]

    # crossfade factor per sample: stage A uses w2[j] (j < 120), stage
    # B uses w2[j - 120] then saturates at 1
    fvec = jnp.asarray(
        np.concatenate([w2, w2, np.ones(N - 2 * OVERLAP, np.float32)])
    )
    # de-emphasis y[k] = x[k] + c*y[k-1] as lower-triangular powers
    kk = np.arange(BLK)
    lower = np.tril(
        np.power(np.float32(CELT_EMPH_COEFF), (kk[:, None] - kk[None, :]))
    ).astype(np.float32)                           # [BLK, BLK]
    Lmat = jnp.asarray(lower.T)                    # x_blk @ Lmat.T form
    cpow = jnp.asarray(
        np.power(np.float32(CELT_EMPH_COEFF), kk + 1).astype(np.float32)
    )                                              # [BLK]

    nsteps = N // BLK
    swA = OVERLAP // BLK                           # blocks in stage A

    def tap5(win12, g3):
        """5-tap comb from a contiguous 12-sample window centered on
        [2:10]: g0*x[j-T] + g1*(x+-1) + g2*(x+-2), per lane/channel."""
        return (g3[:, None, 0:1] * win12[:, :, 2:10]
                + g3[:, None, 1:2] * (win12[:, :, 1:9] + win12[:, :, 3:11])
                + g3[:, None, 2:3] * (win12[:, :, 0:8] + win12[:, :, 4:12]))

    def gather12(xbuf, start):
        """xbuf[b, c, start[b] : start[b]+12] as [B, C, 12]."""
        ix = start[:, None] + jnp.arange(12)[None, :]       # [B, 12]
        ix = jnp.broadcast_to(ix[:, None, :], (B, C, 12))
        return jnp.take_along_axis(xbuf, ix, axis=2)

    def step(carry, k):
        xbuf, em = carry
        j0 = k * BLK
        inA = k < swA
        T0 = jnp.where(inA, Ta0, Tb0)
        T1 = jnp.where(inA, Ta1, Tb1)
        G0 = jnp.where(inA, ga, gc)
        G1 = jnp.where(inA, gb, gd)
        f = lax.dynamic_slice(fvec, (j0,), (BLK,))          # [BLK]
        x_blk = lax.dynamic_slice(
            xbuf, (0, 0, HIST + j0), (B, C, BLK))
        w0 = gather12(xbuf, HIST + j0 - T0 - 2)
        w1 = gather12(xbuf, HIST + j0 - T1 - 2)
        y = (x_blk
             + (1.0 - f)[None, None, :] * tap5(w0, G0)
             + f[None, None, :] * tap5(w1, G1))
        xbuf = lax.dynamic_update_slice(xbuf, y, (0, 0, HIST + j0))
        out = y @ Lmat + em[:, :, None] * cpow[None, None, :]
        em = out[:, :, BLK - 1]
        return (xbuf, em), out

    (xbuf, new_emph), outs = lax.scan(
        step, (x, emph), jnp.arange(nsteps)
    )
    # outs [nsteps, B, C, BLK] -> [B, C, 960]
    pcm = jnp.moveaxis(outs, 0, 2).reshape(B, C, N) / 32768.0
    new_hist = xbuf[..., -HIST:]
    return pcm, new_ola, new_hist, new_emph
