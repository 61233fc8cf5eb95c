"""Native FLAC bit-packer equivalence (native/src/flac_pack.cpp).

The native packer must emit byte-identical frames to the pure-Python
writer it replaces (codecs/flac_encode.write_frame_py) for every
subframe kind, bit depth, and stereo assignment — including the 5-bit
Rice2 escape that 24-bit side channels trigger (k > 14).
"""
import numpy as np
import pytest

import soundkit_tpu.codecs.flac_encode as fe
from soundkit_tpu.models.flac_encode_batch import BatchedFlacEncoder


def _plan(enc, x):
    """Replicate encode_frame's planning, return (assignment, plans)."""
    X = np.atleast_2d(np.asarray(x, np.int64))
    C, _ = X.shape
    assignment = C - 1
    chans = [(X[c], enc.bits) for c in range(C)]
    if C == 2:
        L, R = X[0], X[1]
        side = L - R
        mid = (L + R) >> 1
        rc = fe._residual_cost
        fr = fe._fixed_residual
        ci = rc(fr(L, 2)) + rc(fr(R, 2))
        cls_ = rc(fr(L, 2)) + rc(fr(side, 2))
        crs = rc(fr(side, 2)) + rc(fr(R, 2))
        cms = rc(fr(mid, 2)) + rc(fr(side, 2))
        bc = min(ci, cls_, crs, cms)
        if bc == cls_:
            assignment, chans = 8, [(L, enc.bits), (side, enc.bits + 1)]
        elif bc == crs:
            assignment, chans = 9, [(side, enc.bits + 1), (R, enc.bits)]
        elif bc == cms:
            assignment, chans = 10, [(mid, enc.bits), (side, enc.bits + 1)]
    plans = [fe._plan_subframe(ch, b, enc.profile) for ch, b in chans]
    return assignment, plans


def _cases(bits, rng):
    n = 4096
    t = np.arange(n)
    amp = (1 << (bits - 2)) - 1
    lim = (1 << (bits - 1)) - 1
    return [
        np.stack([(amp * np.sin(t * 0.01)).astype(np.int64),
                  (amp * np.sin(t * 0.013 + 1)).astype(np.int64)]),
        rng.integers(-lim - 1, lim, (2, n)).astype(np.int64),  # noise: Rice2
        np.stack([np.full(n, 123, np.int64), np.full(n, -7, np.int64)]),
        np.stack([t.astype(np.int64) % 17 - 8, (t % 5).astype(np.int64)]),
        np.stack([(amp * np.sin(t * 0.002)).astype(np.int64),
                  rng.integers(-50, 50, n).astype(np.int64)]),
    ]


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("profile", ["realtime", "balanced", "maximum"])
def test_write_frame_native_matches_python(bits, profile):
    if fe._native_lib() is None:
        pytest.skip("native host library unavailable")
    rng = np.random.default_rng(7)
    enc_n = fe.FlacFrameEncoder(44100, 2, bits, profile)
    enc_p = fe.FlacFrameEncoder(44100, 2, bits, profile)
    for x in _cases(bits, rng):
        assignment, plans = _plan(enc_n, x)
        a = enc_n.write_frame(x.shape[1], assignment, plans)
        b = enc_p.write_frame_py(x.shape[1], assignment, plans)
        assert a == b


def test_write_frame_native_mono_odd_block():
    if fe._native_lib() is None:
        pytest.skip("native host library unavailable")
    # non-standard block size (bs_code 7 -> explicit 16-bit field) +
    # odd sample rate (sr_code 14 x10 path) + large frame numbers
    enc_n = fe.FlacFrameEncoder(22000, 1, 16)
    enc_p = fe.FlacFrameEncoder(22000, 1, 16)
    enc_n._frame_no = enc_p._frame_no = 3_000_000  # multi-byte UTF-8
    t = np.arange(1000)
    x = (5000 * np.sin(t * 0.05)).astype(np.int64)[None, :]
    assignment, plans = _plan(enc_n, x)
    a = enc_n.write_frame(1000, assignment, plans)
    b = enc_p.write_frame_py(1000, assignment, plans)
    assert a == b


@pytest.mark.parametrize("bits", [16, 24])
def test_batched_pack_matches_python_writer(bits):
    """The batched native entry (skt_flac_pack_frames, plans from the
    device analysis) must match the per-frame Python fallback."""
    if fe._native_lib() is None:
        pytest.skip("native host library unavailable")
    rng = np.random.default_rng(11)
    n = 4096
    t = np.arange(3 * n)
    amp = (1 << (bits - 2)) - 1
    sig = np.stack([
        (amp * np.sin(t * 0.004)).astype(np.int64) + rng.integers(-9, 9, 3 * n),
        (amp * 0.7 * np.sin(t * 0.004 + 0.2)).astype(np.int64),
    ])
    m_native = BatchedFlacEncoder(2, 48000, 2, bits)
    m_py = BatchedFlacEncoder(2, 48000, 2, bits, use_native=False)
    for m in (m_native, m_py):
        m.push(0, sig)
        m.push(1, sig[:, : 2 * n] // 3)
        m.encode_pending()
    for lane in range(2):
        assert m_native.finish(lane) == m_py.finish(lane), f"lane {lane}"
