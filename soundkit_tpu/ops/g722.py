"""G.722 sub-band ADPCM (64 kbit/s mode 1) as a batched scan.

Behavioral equivalent of the reference's ezk-g722/libg722 backend
(``soundkit-g722/src/lib.rs:1-216`` wraps ``Bitrate::Mode1_64000``,
unpacked, 16 kHz QMF path).  The algorithm is the classic public
G.722 reference structure: per byte, a 6-bit low-band and 2-bit
high-band ADPCM decode, a shared two-pole/six-zero predictor update
("block4"), log step-size adaptation, and a 24-tap QMF synthesis
producing 2 samples per byte.

Batched recast: state is ``[B, 2, ...]`` int32 (both bands updated by
one vectorized block4), a ``lax.scan`` step advances every stream by
one byte, and a validity mask freezes padded lanes (same pattern as
``soundkit_tpu.ops.adpcm``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

G722_SAMPLE_RATE = 16000

WL = np.array([-60, -30, 58, 172, 334, 538, 1198, 3042], dtype=np.int32)
RL42 = np.array([0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0], dtype=np.int32)
ILB = np.array(
    [2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599,
     2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
     3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008],
    dtype=np.int32,
)
WH = np.array([0, -214, 798], dtype=np.int32)
RH2 = np.array([2, 1, 2, 1], dtype=np.int32)
QM2 = np.array([-7408, -1616, 7408, 1616], dtype=np.int32)
QM4 = np.array(
    [0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
     20456, 12896, 8968, 6288, 4240, 2584, 1200, 0],
    dtype=np.int32,
)
QM6 = np.array(
    [-136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512,
     -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456,
     -4944, -4464, -4008, -3576, -3168, -2776, -2400, -2032, -1688, -1360,
     -1040, -728, 24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
     10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456, 4944, 4464, 4008, 3576,
     3168, 2776, 2400, 2032, 1688, 1360, 1040, 728, 432, 136, -432, -136],
    dtype=np.int32,
)
QMF_COEFFS = np.array(
    [3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11], dtype=np.int32
)

# encoder tables
Q6 = np.array(
    [0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650,
     714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980, 2195,
     2557, 2919, 0, 0],
    dtype=np.int32,
)
ILN = np.array(
    [0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
     16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0],
    dtype=np.int32,
)
ILP = np.array(
    [0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45,
     44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0],
    dtype=np.int32,
)
IHN = np.array([0, 1, 0], dtype=np.int32)
IHP = np.array([0, 3, 2], dtype=np.int32)


class G722State(NamedTuple):
    """int32 arrays; band dim: 0 = low, 1 = high."""

    x: np.ndarray  # [B, 24] QMF delay line
    s: np.ndarray  # [B, 2]
    sp: np.ndarray  # [B, 2]
    sz: np.ndarray  # [B, 2]
    r: np.ndarray  # [B, 2, 2] r[1], r[2]
    p: np.ndarray  # [B, 2, 2] p[1], p[2]
    a: np.ndarray  # [B, 2, 2] a[1], a[2]
    b: np.ndarray  # [B, 2, 6] b[1..6]
    d: np.ndarray  # [B, 2, 6] d[1..6]
    nb: np.ndarray  # [B, 2]
    det: np.ndarray  # [B, 2]


def g722_init_state(batch: int, xp=np) -> G722State:
    """Initial state matching ezk-g722/libg722: low-band det starts at 0
    (not spandsp's 32), high-band det at 8 — verified bit-exact against
    the reference golden decode."""
    i32 = xp.int32
    z = lambda *s: xp.zeros((batch, *s), dtype=i32)
    det = xp.tile(xp.asarray([[0, 8]], dtype=i32), (batch, 1))
    return G722State(
        x=z(24), s=z(2), sp=z(2), sz=z(2), r=z(2, 2), p=z(2, 2), a=z(2, 2),
        b=z(2, 6), d=z(2, 6), nb=z(2), det=det,
    )


def _sat(xp, v):
    return xp.clip(v, -32768, 32767)


def _block4(xp, st: G722State, d):
    """Shared predictor update for both bands; d: [B, 2]."""
    r0 = _sat(xp, st.s + d)
    p0 = _sat(xp, st.sz + d)

    # UPPOL2
    sg0 = p0 >> 15
    sg1 = st.p[:, :, 0] >> 15
    sg2 = st.p[:, :, 1] >> 15
    a1, a2 = st.a[:, :, 0], st.a[:, :, 1]
    wd1 = _sat(xp, a1 << 2)
    wd2 = xp.where(sg0 == sg1, -wd1, wd1)
    wd2 = xp.minimum(wd2, 32767)
    wd3 = (wd2 >> 7) + xp.where(sg0 == sg2, 128, -128)
    wd3 = wd3 + ((a2 * 32512) >> 15)
    ap2 = xp.clip(wd3, -12288, 12288)

    # UPPOL1
    wd1b = xp.where(sg0 == sg1, 192, -192)
    wd2b = (a1 * 32640) >> 15
    ap1 = _sat(xp, wd1b + wd2b)
    wd3b = _sat(xp, 15360 - ap2)
    ap1 = xp.clip(ap1, -wd3b, wd3b)

    # UPZERO
    wd1c = xp.where(d == 0, 0, 128)
    sgd0 = d >> 15
    sgd = st.d >> 15  # [B, 2, 6]
    wd2c = xp.where(sgd == sgd0[:, :, None], wd1c[:, :, None], -wd1c[:, :, None])
    wd3c = (st.b * 32640) >> 15
    bp = _sat(xp, wd2c + wd3c)

    # DELAY
    d_new = xp.concatenate([d[:, :, None], st.d[:, :, :5]], axis=-1)
    r_new = xp.stack([r0, st.r[:, :, 0]], axis=-1)
    p_new = xp.stack([p0, st.p[:, :, 0]], axis=-1)
    a_new = xp.stack([ap1, ap2], axis=-1)

    # FILTEP
    wd1d = (ap1 * _sat(xp, r_new[:, :, 0] * 2)) >> 15
    wd2d = (ap2 * _sat(xp, r_new[:, :, 1] * 2)) >> 15
    sp = _sat(xp, wd1d + wd2d)

    # FILTEZ
    sz = xp.sum((bp * _sat(xp, d_new * 2)) >> 15, axis=-1)
    sz = _sat(xp, sz)

    s = _sat(xp, sp + sz)
    return st._replace(
        s=s.astype(xp.int32), sp=sp.astype(xp.int32), sz=sz.astype(xp.int32),
        r=r_new.astype(xp.int32), p=p_new.astype(xp.int32),
        a=a_new.astype(xp.int32), b=bp.astype(xp.int32), d=d_new.astype(xp.int32),
    )


def _scale(xp, nb, band_is_high):
    """SCALEL/SCALEH: nb -> det."""
    wd1 = (nb >> 6) & 31
    wd2 = xp.where(band_is_high, 10, 8) - (nb >> 11)
    base = xp.take(xp.asarray(ILB), wd1)
    wd3 = xp.where(
        wd2 < 0,
        xp.left_shift(base, xp.maximum(-wd2, 0)),
        xp.right_shift(base, xp.maximum(wd2, 0)),
    )
    return wd3 << 2


def _masked(xp, valid, new, old):
    if valid is None:
        return new
    v = valid
    while v.ndim < new.ndim:
        v = v[..., None]
    return xp.where(v, new, old).astype(xp.int32)


def g722_decode_step(xp, st: G722State, code, valid=None) -> Tuple[G722State, np.ndarray]:
    """One byte -> two 16 kHz samples per stream. Returns (state, pcm[B, 2])."""
    code = code.astype(xp.int32)
    wd1 = code & 0x3F
    ihigh = (code >> 6) & 0x03
    ril = wd1 >> 2

    det_l, det_h = st.det[:, 0], st.det[:, 1]
    nb_l, nb_h = st.nb[:, 0], st.nb[:, 1]

    # low band: 6-bit inverse quantize for output, 4-bit for adaptation
    wd2 = (det_l * xp.take(xp.asarray(QM6), wd1)) >> 15
    rlow = xp.clip(st.s[:, 0] + wd2, -16384, 16383)
    dlowt = (det_l * xp.take(xp.asarray(QM4), ril)) >> 15

    il4 = xp.take(xp.asarray(RL42), ril)
    nb_l2 = xp.clip(((nb_l * 127) >> 7) + xp.take(xp.asarray(WL), il4), 0, 18432)
    det_l2 = _scale(xp, nb_l2, False)

    # high band
    dhigh = (det_h * xp.take(xp.asarray(QM2), ihigh)) >> 15
    rhigh = xp.clip(dhigh + st.s[:, 1], -16384, 16383)
    ih2 = xp.take(xp.asarray(RH2), ihigh)
    nb_h2 = xp.clip(((nb_h * 127) >> 7) + xp.take(xp.asarray(WH), ih2), 0, 22528)
    det_h2 = _scale(xp, nb_h2, True)

    st2 = _block4(xp, st, xp.stack([dlowt, dhigh], axis=-1))
    st2 = st2._replace(
        nb=xp.stack([nb_l2, nb_h2], axis=-1).astype(xp.int32),
        det=xp.stack([det_l2, det_h2], axis=-1).astype(xp.int32),
    )

    # QMF synthesis
    xq = xp.concatenate(
        [st.x[:, 2:], (rlow + rhigh)[:, None], (rlow - rhigh)[:, None]], axis=-1
    )
    h = xp.asarray(QMF_COEFFS)
    xout2 = xp.sum(xq[:, 0::2] * h[None, :], axis=-1)
    xout1 = xp.sum(xq[:, 1::2] * h[None, ::-1], axis=-1)
    pcm = xp.stack([_sat(xp, xout1 >> 11), _sat(xp, xout2 >> 11)], axis=-1)
    st2 = st2._replace(x=xq.astype(xp.int32))

    if valid is not None:
        st2 = G722State(*[_masked(xp, valid, n, o) for n, o in zip(st2, st)])
        pcm = xp.where(valid[:, None], pcm, 0)
    return st2, pcm.astype(xp.int16)


def g722_encode_step(xp, st: G722State, samples, valid=None) -> Tuple[G722State, np.ndarray]:
    """Two 16 kHz samples -> one byte per stream. samples: [B, 2] i16."""
    samples = samples.astype(xp.int32)
    xq = xp.concatenate([st.x[:, 2:], samples], axis=-1)
    h = xp.asarray(QMF_COEFFS)
    sumeven = xp.sum(xq[:, 0::2] * h[None, :], axis=-1)
    sumodd = xp.sum(xq[:, 1::2] * h[None, ::-1], axis=-1)
    xlow = (sumeven + sumodd) >> 14
    xhigh = (sumeven - sumodd) >> 14

    det_l, det_h = st.det[:, 0], st.det[:, 1]
    nb_l, nb_h = st.nb[:, 0], st.nb[:, 1]

    # low band quantize: 30-level decision ladder
    el = _sat(xp, xlow - st.s[:, 0])
    wd = xp.where(el >= 0, el, -(el + 1))
    thr = xp.right_shift(
        xp.asarray(Q6)[None, 1:30] * det_l[:, None], 12
    )  # [B, 29]
    i = 1 + xp.sum(wd[:, None] >= thr, axis=-1).astype(xp.int32)
    ilow = xp.where(el < 0, xp.take(xp.asarray(ILN), i), xp.take(xp.asarray(ILP), i))
    ril = ilow >> 2
    dlowt = (det_l * xp.take(xp.asarray(QM4), ril)) >> 15
    il4 = xp.take(xp.asarray(RL42), ril)
    nb_l2 = xp.clip(((nb_l * 127) >> 7) + xp.take(xp.asarray(WL), il4), 0, 18432)
    det_l2 = _scale(xp, nb_l2, False)

    # high band quantize
    eh = _sat(xp, xhigh - st.s[:, 1])
    wdh = xp.where(eh >= 0, eh, -(eh + 1))
    wd1h = (564 * det_h) >> 12
    mih = xp.where(wdh >= wd1h, 2, 1)
    ihigh = xp.where(eh < 0, xp.take(xp.asarray(IHN), mih), xp.take(xp.asarray(IHP), mih))
    dhigh = (det_h * xp.take(xp.asarray(QM2), ihigh)) >> 15
    ih2 = xp.take(xp.asarray(RH2), ihigh)
    nb_h2 = xp.clip(((nb_h * 127) >> 7) + xp.take(xp.asarray(WH), ih2), 0, 22528)
    det_h2 = _scale(xp, nb_h2, True)

    st2 = _block4(xp, st, xp.stack([dlowt, dhigh], axis=-1))
    st2 = st2._replace(
        nb=xp.stack([nb_l2, nb_h2], axis=-1).astype(xp.int32),
        det=xp.stack([det_l2, det_h2], axis=-1).astype(xp.int32),
        x=xq.astype(xp.int32),
    )

    code = ((ihigh << 6) | ilow).astype(xp.uint8)
    if valid is not None:
        st2 = G722State(*[_masked(xp, valid, n, o) for n, o in zip(st2, st)])
        code = xp.where(valid, code, 0).astype(xp.uint8)
    return st2, code


def g722_decode_scan(codes, state: G722State, valid=None):
    """codes[B, N] -> (pcm[B, 2N] i16, final state) via lax.scan."""
    import jax.numpy as jnp
    from jax import lax

    def step(st, inp):
        c, v = inp if valid is not None else (inp, None)
        st2, pcm = g722_decode_step(jnp, st, c, v)
        return st2, pcm

    xs = codes.T if valid is None else (codes.T, valid.T)
    final, pcm_t = lax.scan(step, state, xs)  # [N, B, 2]
    pcm = jnp.transpose(pcm_t, (1, 0, 2)).reshape(codes.shape[0], -1)
    return pcm, final


def g722_encode_scan(samples, state: G722State, valid=None):
    """samples[B, 2N] i16 -> (codes[B, N] u8, final state)."""
    import jax.numpy as jnp
    from jax import lax

    B, n2 = samples.shape
    pairs = samples.reshape(B, n2 // 2, 2)

    def step(st, inp):
        s, v = inp if valid is not None else (inp, None)
        st2, code = g722_encode_step(jnp, st, s, v)
        return st2, code

    xs = (
        jnp.transpose(pairs, (1, 0, 2))
        if valid is None
        else (jnp.transpose(pairs, (1, 0, 2)), valid.T)
    )
    final, codes_t = lax.scan(step, state, xs)
    return codes_t.T, final
