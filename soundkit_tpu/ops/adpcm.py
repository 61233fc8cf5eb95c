"""G.726 ADPCM predictor state machine as a batched scan.

Behavioral equivalent of the reference's Rust port of the Sun G.72x
reference code (``soundkit-g726/src/lib.rs``): quantizer tables per
rate (:33-68), ``G726Core`` two-pole/six-zero predictor (:181-430),
``fmult``/``quan`` float-format arithmetic (:432-462), ``quantize``
(:464-479) and ``reconstruct`` (:481-499).

Batched recast: the per-sample update is inherently sequential, so
the parallel axis is *streams*.  All state lives in ``[B]``-shaped
int32 arrays and one ``lax.scan`` step advances every stream by one
sample with pure elementwise arithmetic (every branch becomes a
``where``).  A per-step validity mask freezes state for padded lanes so
ragged batches decode correctly with fixed shapes.

The same generic code runs under numpy for scalar host verification.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np

POWER2 = np.array([1 << i for i in range(15)], dtype=np.int32)

# Per-rate tables, keyed by code bits (lib.rs:33-68)
_G726_TABLES = {
    2: dict(
        q=[261],
        dqln=[116, 365, 365, 116],
        wi=[-22, 439, 439, -22],
        fi=[0, 0xE00, 0xE00, 0],
    ),
    3: dict(
        q=[8, 218, 331],
        dqln=[-2048, 135, 273, 373, 373, 273, 135, -2048],
        wi=[-4, 30, 137, 582, 582, 137, 30, -4],
        fi=[0, 0x200, 0x400, 0xE00, 0xE00, 0x400, 0x200, 0],
    ),
    4: dict(
        q=[-124, 80, 178, 246, 300, 349, 400],
        dqln=[-2048, 4, 135, 213, 273, 323, 373, 425, 425, 373, 323, 273, 213, 135, 4, -2048],
        wi=[-12, 18, 41, 64, 112, 198, 355, 1122, 1122, 355, 198, 112, 64, 41, 18, -12],
        fi=[0, 0, 0, 0x200, 0x200, 0x200, 0x600, 0xE00,
            0xE00, 0x600, 0x200, 0x200, 0x200, 0, 0, 0],
    ),
    5: dict(
        q=[-122, -16, 68, 139, 198, 250, 298, 339, 378, 413, 445, 475, 502, 528, 553],
        dqln=[-2048, -66, 28, 104, 169, 224, 274, 318, 358, 395, 429, 459, 488, 514, 539,
              566, 566, 539, 514, 488, 459, 429, 395, 358, 318, 274, 224, 169, 104, 28,
              -66, -2048],
        wi=[14, 14, 24, 39, 40, 41, 58, 100, 141, 179, 219, 280, 358, 440, 529, 696,
            696, 529, 440, 358, 280, 219, 179, 141, 100, 58, 41, 40, 39, 24, 14, 14],
        fi=[0, 0, 0, 0, 0, 0x200, 0x200, 0x200, 0x200, 0x200, 0x400, 0x600, 0x800,
            0xA00, 0xC00, 0xC00, 0xC00, 0xC00, 0xA00, 0x800, 0x600, 0x400, 0x200,
            0x200, 0x200, 0x200, 0x200, 0, 0, 0, 0, 0],
    ),
}


def g726_tables(bits: int) -> Dict[str, np.ndarray]:
    t = _G726_TABLES[bits]
    return {k: np.asarray(v, dtype=np.int32) for k, v in t.items()}


class G726State(NamedTuple):
    """Batched predictor state; every leaf is int32 with leading dim B."""

    yl: np.ndarray
    yu: np.ndarray
    dms: np.ndarray
    dml: np.ndarray
    ap: np.ndarray
    a: np.ndarray  # [B, 2]
    b: np.ndarray  # [B, 6]
    pk: np.ndarray  # [B, 2]
    dq: np.ndarray  # [B, 6]
    sr: np.ndarray  # [B, 2]
    td: np.ndarray


def g726_init_state(batch: int, xp=np) -> G726State:
    """Default-reset state (lib.rs:196-212)."""
    i32 = xp.int32
    z = lambda *s: xp.zeros((batch, *s), dtype=i32)
    return G726State(
        yl=xp.full((batch,), 34816, dtype=i32),
        yu=xp.full((batch,), 544, dtype=i32),
        dms=z(),
        dml=z(),
        ap=z(),
        a=z(2),
        b=z(6),
        pk=z(2),
        dq=xp.full((batch, 6), 32, dtype=i32),
        sr=xp.full((batch, 2), 32, dtype=i32),
        td=z(),
    )


def _quan_power2(xp, value):
    """quan(value, POWER2): index of first 2^i > value (lib.rs:432-437)."""
    p2 = xp.asarray(POWER2)
    return xp.sum(value[..., None] >= p2, axis=-1).astype(xp.int32)


def _rshift(xp, v, n):
    """Arithmetic right shift with a possibly-traced nonneg amount."""
    return xp.right_shift(v, n)


def _fmult(xp, an, srn):
    """Float-format multiply (lib.rs:439-462)."""
    anmag = xp.where(an > 0, an, (-an) & 0x1FFF)
    anexp = _quan_power2(xp, anmag) - 6
    anmant = xp.where(
        anmag == 0,
        32,
        xp.where(
            anexp >= 0,
            xp.right_shift(anmag, xp.maximum(anexp, 0)),
            xp.left_shift(anmag, xp.maximum(-anexp, 0)),
        ),
    )
    wanexp = anexp + ((_rshift(xp, srn, 6)) & 0x0F) - 13
    wanmant = (anmant * (srn & 0x3F) + 0x30) >> 4
    retval = xp.where(
        wanexp >= 0,
        xp.left_shift(wanmant, xp.maximum(wanexp, 0)) & 0x7FFF,
        xp.right_shift(wanmant, xp.maximum(-wanexp, 0)),
    )
    return xp.where((an ^ srn) < 0, -retval, retval)


def _predictor_zero(xp, st: G726State):
    return xp.sum(_fmult(xp, st.b >> 2, st.dq), axis=-1).astype(xp.int32)


def _predictor_pole(xp, st: G726State):
    return (
        _fmult(xp, st.a[:, 1] >> 2, st.sr[:, 1])
        + _fmult(xp, st.a[:, 0] >> 2, st.sr[:, 0])
    ).astype(xp.int32)


def _step_size(xp, st: G726State):
    """lib.rs:282-297."""
    y = st.yl >> 6
    dif = st.yu - y
    al = st.ap >> 2
    mixed = xp.where(
        dif > 0,
        y + ((dif * al) >> 6),
        xp.where(dif < 0, y + ((dif * al + 0x3F) >> 6), y),
    )
    return xp.where(st.ap >= 256, st.yu, mixed)


def _reconstruct(xp, sign, dqln, y):
    """lib.rs:481-499; sign is a bool array."""
    dql = dqln + (y >> 2)
    dex = (dql >> 7) & 15
    dqt = 128 + (dql & 127)
    dq_pos = xp.right_shift(xp.left_shift(dqt, 7), 14 - dex)
    neg_case = xp.where(sign, -0x8000, 0)
    pos_case = xp.where(sign, dq_pos - 0x8000, dq_pos)
    return xp.where(dql < 0, neg_case, pos_case).astype(xp.int32)


def _float_format(xp, v):
    """Encode a magnitude into exp<<6|mant float format used for dq/sr."""
    exp = _quan_power2(xp, v)
    return (exp << 6) + xp.right_shift(xp.left_shift(v, 6), exp)


def _update(xp, st: G726State, y, wi, fi, dq, sr, dqsez, bits: int, valid=None) -> G726State:
    """State update (lib.rs:299-429), fully vectorized."""
    i32 = xp.int32
    pk0 = (dqsez < 0).astype(i32)
    mag = dq & 0x7FFF

    ylint = st.yl >> 15
    ylfrac = (st.yl >> 10) & 0x1F
    thr1 = xp.left_shift(32 + ylfrac, ylint)
    thr2 = xp.where(ylint > 9, 31 << 10, thr1)
    dqthr = (thr2 + (thr2 >> 1)) >> 1
    tr = ((st.td != 0) & (mag > dqthr)).astype(i32)

    yu = y + ((wi - y) >> 5)
    yu = xp.clip(yu, 544, 5120)
    yl = st.yl + yu + ((-st.yl) >> 6)

    # --- pole/zero adaptation (the tr==0 branch), then zeroed where tr ---
    pks1 = pk0 ^ st.pk[:, 0]
    a2p = st.a[:, 1] - (st.a[:, 1] >> 7)

    fa1 = xp.where(pks1 != 0, st.a[:, 0], -st.a[:, 0])
    a2p_adj = xp.where(
        fa1 < -8191,
        a2p - 0x100,
        xp.where(fa1 > 8191, a2p + 0xFF, a2p + (fa1 >> 5)),
    )
    pk0_x_pk1 = (pk0 ^ st.pk[:, 1]) != 0
    a2p_clamped = xp.where(
        pk0_x_pk1,
        xp.where(
            a2p_adj <= -12160,
            -12288,
            xp.where(a2p_adj >= 12416, 12288, a2p_adj - 0x80),
        ),
        xp.where(
            a2p_adj <= -12416,
            -12288,
            xp.where(a2p_adj >= 12160, 12288, a2p_adj + 0x80),
        ),
    )
    a2p_new = xp.where(dqsez != 0, a2p_clamped, a2p)

    a1 = st.a[:, 0] - (st.a[:, 0] >> 8)
    a1 = xp.where(dqsez != 0, xp.where(pks1 == 0, a1 + 192, a1 - 192), a1)
    a1ul = 15360 - a2p_new
    a1 = xp.clip(a1, -a1ul, a1ul)

    decay_shift = 9 if bits == 5 else 8
    b_decayed = st.b - (st.b >> decay_shift)
    dq_nonzero = ((dq & 0x7FFF) != 0)[:, None]
    same_sign = (dq[:, None] ^ st.dq) >= 0
    b_new = xp.where(
        dq_nonzero, xp.where(same_sign, b_decayed + 128, b_decayed - 128), b_decayed
    )

    tr_b = tr != 0
    a_new = xp.stack(
        [xp.where(tr_b, 0, a1), xp.where(tr_b, 0, a2p_new)], axis=-1
    ).astype(i32)
    b_new = xp.where(tr_b[:, None], 0, b_new).astype(i32)
    a2p_eff = xp.where(tr_b, 0, a2p_new)

    # --- dq history push (float format) ---
    exp_mag = _quan_power2(xp, mag)
    mant = xp.right_shift(xp.left_shift(mag, 6), exp_mag)
    val = (exp_mag << 6) + mant
    dq0 = xp.where(
        mag == 0,
        xp.where(dq >= 0, 0x20, -0x3E0),
        xp.where(dq >= 0, val, val - 0x400),
    )
    dq_hist = xp.concatenate([dq0[:, None], st.dq[:, :5]], axis=-1).astype(i32)

    # --- sr history push ---
    sr_mag = -sr
    sr0 = xp.where(
        sr == 0,
        0x20,
        xp.where(
            sr > 0,
            _float_format(xp, xp.maximum(sr, 0)),
            xp.where(
                sr > -32768,
                _float_format(xp, xp.maximum(sr_mag, 0)) - 0x400,
                -0x3E0,
            ),
        ),
    )
    sr_hist = xp.stack([sr0, st.sr[:, 0]], axis=-1).astype(i32)

    pk_hist = xp.stack([pk0, st.pk[:, 0]], axis=-1).astype(i32)

    td_new = xp.where(tr_b, 0, (a2p_eff < -11776).astype(i32))

    dms = st.dms + ((fi - st.dms) >> 5)
    dml = st.dml + (((fi << 2) - st.dml) >> 7)

    ap_up = st.ap + ((0x200 - st.ap) >> 4)
    ap_down = st.ap + ((-st.ap) >> 4)
    fast = (y < 1536) | (td_new != 0) | (xp.abs((dms << 2) - dml) >= (dml >> 3))
    ap_new = xp.where(tr_b, 256, xp.where(fast, ap_up, ap_down)).astype(i32)

    new = G726State(
        yl=yl.astype(i32),
        yu=yu.astype(i32),
        dms=dms.astype(i32),
        dml=dml.astype(i32),
        ap=ap_new,
        a=a_new,
        b=b_new,
        pk=pk_hist,
        dq=dq_hist,
        sr=sr_hist,
        td=td_new.astype(i32),
    )
    if valid is None:
        return new
    v = valid
    sel = lambda n, o: xp.where(
        v if n.ndim == 1 else v[:, None], n, o
    ).astype(i32)
    return G726State(*[sel(n, o) for n, o in zip(new, st)])


def g726_decode_step(
    xp, st: G726State, code, bits: int, valid=None
) -> Tuple[G726State, np.ndarray]:
    """One decode step for all streams (lib.rs:243-268). Returns (state, i16 pcm)."""
    t = g726_tables(bits)
    dqln_t, wi_t, fi_t = (xp.asarray(t[k]) for k in ("dqln", "wi", "fi"))
    code_mask = (1 << bits) - 1
    sign_bit = 1 << (bits - 1)

    i = (code & code_mask).astype(xp.int32)
    sezi = _predictor_zero(xp, st)
    sez = sezi >> 1
    se = (sezi + _predictor_pole(xp, st)) >> 1
    y = _step_size(xp, st)
    dq = _reconstruct(xp, (i & sign_bit) != 0, xp.take(dqln_t, i), y)
    dq_mask = 0x7FFF if bits == 5 else 0x3FFF
    sr = xp.where(dq < 0, se - (dq & dq_mask), se + dq)
    dqsez = sr - se + sez
    st2 = _update(
        xp, st, y, xp.take(wi_t, i) << 5, xp.take(fi_t, i), dq, sr, dqsez, bits, valid
    )
    pcm = xp.clip(sr << 2, -32768, 32767).astype(xp.int16)
    if valid is not None:
        pcm = xp.where(valid, pcm, 0).astype(xp.int16)
    return st2, pcm


def g726_encode_step(
    xp, st: G726State, sample, bits: int, valid=None
) -> Tuple[G726State, np.ndarray]:
    """One encode step for all streams (lib.rs:215-241). Returns (state, code u8)."""
    t = g726_tables(bits)
    q_t, dqln_t, wi_t, fi_t = (xp.asarray(t[k]) for k in ("q", "dqln", "wi", "fi"))
    code_mask = (1 << bits) - 1
    sign_bit = 1 << (bits - 1)

    sl = sample.astype(xp.int32) >> 2
    sezi = _predictor_zero(xp, st)
    sez = sezi >> 1
    se = (sezi + _predictor_pole(xp, st)) >> 1
    d = sl - se
    y = _step_size(xp, st)

    # quantize (lib.rs:464-479)
    dqm = xp.abs(d)
    exp = _quan_power2(xp, dqm >> 1)
    mant = xp.right_shift(xp.left_shift(dqm, 7), exp) & 0x7F
    dln = (exp << 7) + mant - (y >> 2)
    qi = xp.sum(dln[..., None] >= q_t, axis=-1).astype(xp.int32)
    i = xp.where(d < 0, code_mask - qi, xp.where(qi == 0, code_mask, qi))

    dq = _reconstruct(xp, (i & sign_bit) != 0, xp.take(dqln_t, i), y)
    dq_mask = 0x7FFF if bits == 5 else 0x3FFF
    sr = xp.where(dq < 0, se - (dq & dq_mask), se + dq)
    dqsez = sr + sez - se
    st2 = _update(
        xp, st, y, xp.take(wi_t, i) << 5, xp.take(fi_t, i), dq, sr, dqsez, bits, valid
    )
    code = (i & code_mask).astype(xp.uint8)
    if valid is not None:
        code = xp.where(valid, code, 0).astype(xp.uint8)
    return st2, code


# ---------------------------------------------------------------------------
# batched device scans
# ---------------------------------------------------------------------------

def g726_decode_scan(codes, state: G726State, bits: int, valid=None):
    """Decode ``codes[B, N]`` -> ``(pcm[B, N] i16, final_state)`` via lax.scan."""
    import jax.numpy as jnp
    from jax import lax

    def step(st, inp):
        if valid is None:
            c, v = inp, None
        else:
            c, v = inp
        st2, pcm = g726_decode_step(jnp, st, c, bits, v)
        return st2, pcm

    xs = codes.T if valid is None else (codes.T, valid.T)
    final, pcm_t = lax.scan(step, state, xs)
    return pcm_t.T, final


def g726_encode_scan(samples, state: G726State, bits: int, valid=None):
    """Encode ``samples[B, N] i16`` -> ``(codes[B, N] u8, final_state)``."""
    import jax.numpy as jnp
    from jax import lax

    def step(st, inp):
        if valid is None:
            s, v = inp, None
        else:
            s, v = inp
        st2, code = g726_encode_step(jnp, st, s, bits, v)
        return st2, code

    xs = samples.T if valid is None else (samples.T, valid.T)
    final, codes_t = lax.scan(step, state, xs)
    return codes_t.T, final
