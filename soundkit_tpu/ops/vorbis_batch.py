"""Batched device Vorbis synthesis: IMDCT + window + overlap-add.

Device half of the Vorbis path (north star names the Vorbis MDCT among
the batched device kernels, SURVEY.md:18-24).  The host entropy layer
(codecs/vorbis_core.py) emits per-packet spectra; this module jits the
synthesis over ``[B, C, n1/2]`` lanes:

- IMDCT as matmuls for both block sizes, selected per lane
- Vorbis windows (long/short slope combinations from the per-packet
  prev/next window flags)
- overlap-add with carried lap state; block-size transitions handled
  with static case shifts (4 cases, masked select)

Lanes advance in lockstep, one packet per step; frames return a fixed
[B, C, n1/2] buffer plus per-lane valid lengths (packet output length
depends on the neighboring block sizes).
"""
from __future__ import annotations

import functools

import numpy as np

from soundkit_tpu.codecs.vorbis_core import imdct_matrix, vorbis_window


@functools.lru_cache(maxsize=8)
def window_bank(n0: int, n1: int) -> np.ndarray:
    """[5, n1] windows: rows 0-3 = long block with (prev_flag,
    next_flag) in (0,0),(0,1),(1,0),(1,1); row 4 = short block
    (zero-padded to n1)."""
    bank = np.zeros((5, n1), dtype=np.float32)
    long_slope = vorbis_window(n1 // 2)
    short_slope = vorbis_window(n0 // 2)
    for pf in (0, 1):
        for nf in (0, 1):
            w = np.ones(n1)
            if pf:
                w[: n1 // 2] = long_slope
            else:
                s = n0 // 2
                start = n1 // 4 - n0 // 4
                w[:start] = 0.0
                w[start : start + s] = short_slope
                w[start + s : n1 // 2] = 1.0
            if nf:
                w[n1 // 2 :] = long_slope[::-1]
            else:
                s = n0 // 2
                start = 3 * n1 // 4 - n0 // 4
                w[n1 // 2 : start] = 1.0
                w[start : start + s] = short_slope[::-1]
                w[start + s :] = 0.0
            bank[pf * 2 + nf] = w
    ws = np.zeros(n1)
    ws[: n0 // 2] = short_slope
    ws[n0 // 2 : n0] = short_slope[::-1]
    bank[4] = ws
    return bank


def vorbis_synth_step(spec, n_flag, prev_flag, next_flag, valid, primed,
                      carry, carry_flag, n0: int, n1: int):
    """One lockstep packet for all lanes.

    spec:      [B, C, n1//2] f32 (short spectra padded with zeros)
    n_flag:    [B] int32, 1 = long block (n1), 0 = short (n0)
    prev/next_flag: [B] int32 window flags (long blocks only)
    valid:     [B] bool — lane has a packet this step
    primed:    [B] bool — lane has synthesized at least one packet
    carry:     [B, C, n1//2] f32 lap state
    carry_flag:[B] int32 previous block's n_flag

    Returns (out [B, C, n1//2], out_len [B], new_carry, new_carry_flag).
    out[:, :, :out_len[b]] are lane b's finished samples.

    Matmul precision pinned to float32 (see aac_batch: the GPU's TF32
    default would cap IMDCT accuracy well below the oracle bars).
    """
    import jax

    with jax.default_matmul_precision("float32"):
        return _vorbis_synth_step(spec, n_flag, prev_flag, next_flag,
                                  valid, primed, carry, carry_flag,
                                  n0=n0, n1=n1)


def _vorbis_synth_step(spec, n_flag, prev_flag, next_flag, valid, primed,
                       carry, carry_flag, n0: int, n1: int):
    import jax.numpy as jnp

    B, C, _ = spec.shape
    h1 = n1 // 2

    M1 = jnp.asarray(imdct_matrix(n1).astype(np.float32))
    M0 = jnp.asarray(imdct_matrix(n0).astype(np.float32))
    flat = spec.reshape(B * C, h1)
    pcm1 = flat @ M1.T  # [B*C, n1]
    pcm0 = flat[:, : n0 // 2] @ M0.T  # [B*C, n0]
    pcm0 = jnp.pad(pcm0, ((0, 0), (0, n1 - n0)))

    bank = jnp.asarray(window_bank(n0, n1))  # [5, n1]
    widx = jnp.where(n_flag == 1, prev_flag * 2 + next_flag, 4)  # [B]
    w = bank[widx]  # [B, n1]
    pcm = jnp.where(
        (n_flag == 1)[:, None, None],
        pcm1.reshape(B, C, n1),
        pcm0.reshape(B, C, n1),
    )
    pcm = pcm * w[:, None, :]

    # overlap-add: buf[k] = carry[k] + pcm[k - s] where s = d - n/2 and
    # d = prev_n/4 + n/4; four (prev, cur) size cases give three
    # distinct static shifts
    sL = (n1 - n0) // 4
    pcm_right = jnp.pad(pcm, ((0, 0), (0, 0), (sL, 0)))[..., :n1]   # shift +sL
    pcm_left = jnp.pad(pcm, ((0, 0), (0, 0), (0, sL)))[..., sL:]    # shift -sL
    prev_long = (carry_flag == 1)[:, None, None]
    cur_long = (n_flag == 1)[:, None, None]
    shifted = jnp.where(
        prev_long == cur_long, pcm,
        jnp.where(prev_long, pcm_right, pcm_left),
    )
    carry_full = jnp.pad(carry, ((0, 0), (0, 0), (0, n1 - h1)))
    buf = carry_full + shifted

    # d per lane (samples finished this step)
    prev_n = jnp.where(carry_flag == 1, n1, n0)
    n = jnp.where(n_flag == 1, n1, n0)
    d = prev_n // 4 + n // 4

    # out = buf[:d] (kept in place; caller slices by out_len);
    # new carry = buf[d : d + n/2], realigned to offset 0 via the three
    # static shifts
    dvals = [n0 // 2, (n0 + n1) // 4, n1 // 2]
    carry_cands = [buf[..., dv : dv + h1] if dv + h1 <= n1
                   else jnp.pad(buf[..., dv:], ((0, 0), (0, 0), (0, dv + h1 - n1)))
                   for dv in dvals]
    new_carry = carry_cands[0]
    for dv, cand in zip(dvals[1:], carry_cands[1:]):
        new_carry = jnp.where((d == dv)[:, None, None], cand, new_carry)

    # mask the carry's tail beyond n/2 (short current block)
    k = jnp.arange(h1, dtype=jnp.int32)[None, None, :]
    new_carry = jnp.where(k < (n // 2)[:, None, None], new_carry, 0.0)

    # unprimed lanes emit nothing; invalid lanes freeze state
    out_len = jnp.where(valid & primed, d, 0)
    v = valid[:, None, None]
    new_carry = jnp.where(v, new_carry, carry)
    new_carry_flag = jnp.where(valid, n_flag, carry_flag)
    out = jnp.where(v, buf[..., :h1], 0.0)
    return out, out_len, new_carry, new_carry_flag


def init_state(B: int, C: int, n1: int):
    return (
        np.zeros((B, C, n1 // 2), dtype=np.float32),  # carry
        np.ones(B, dtype=np.int32),  # carry_flag (long by default)
    )
