"""Device SILK synthesis (ops/silk_batch.py) + serving model.

The split of the SILK voice path: native parse-export
(silk_parse.cpp skt_silk_parse_many) + jitted batched LTP/LPC
synthesis, stereo unmix, and table-FIR 48 kHz resample.  In f64 the
device path matches the host engine (native synthesis + libswresample)
to the host resampler's own float32 arithmetic noise (~1.5e-7); the
f32 serving path holds >95 dB per lane.

Parity reference: soundkit-opus/src/lib.rs per-pipeline decode
(libopus wrapper role).
"""
import struct
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu.codecs.opus_core import parse_packet

CLIP = "A_Tusk_is_used_to_make_costly_gifts"
TESTDATA = Path("/root/reference/testdata")


def _fixture_silk_frames(bw=2, dur=20):
    data = (TESTDATA / "opus" / f"{CLIP}.opus").read_bytes()
    body = data[19:]
    out = []
    pos = 0
    while pos + 2 <= len(body):
        (n,) = struct.unpack_from("<H", body, pos)
        toc, frames = parse_packet(body[pos + 2 : pos + 2 + n])
        if toc.bandwidth == bw and int(toc.frame_duration) == dur:
            out.extend(frames)
        pos += 2 + n
    return out


def _enc_frames(bw, stereo, n_frames):
    """Owned-encoder SILK payloads (loud from sample 0 — exercises the
    resampler's time-varying stream start)."""
    from soundkit_tpu.codecs.silk_native import NativeSilkEncoder

    rng = np.random.default_rng(42 + bw)
    rate = (8000, 12000, 16000)[bw]
    flen = 20 * (bw + 2) * 4
    t = np.arange(flen * n_frames) / rate
    x = (0.4 * np.sin(2 * np.pi * 170 * t)
         * (1 + 0.6 * np.sin(2 * np.pi * 2.6 * t))
         + 0.015 * rng.standard_normal(len(t)))
    enc = NativeSilkEncoder(bw, 2 if stereo else 1)
    out = []
    if stereo:
        R = np.concatenate([np.zeros(8), 0.7 * x[:-8]])
        for i in range(0, len(x) - flen + 1, flen):
            out.append(enc.encode_frame(
                np.stack([x[i:i + flen], R[i:i + flen]], 1), 3.0))
    else:
        for i in range(0, len(x) - flen + 1, flen):
            out.append(enc.encode_frame(x[i:i + flen].reshape(-1, 1),
                                        3.0))
    return out


def _oracle_stream(frames, bw, coded, valid_rounds=None):
    """Per-stream host oracle: native decode + libswresample, f64."""
    from soundkit_tpu.codecs.silk_native import NativeSilkDecoder
    from soundkit_tpu.utils.swr import SilkResampler

    rate = (8000, 12000, 16000)[bw]
    C = max(coded) if hasattr(coded, "__len__") else coded
    dec = NativeSilkDecoder()
    rs = SilkResampler(rate, bw, C)
    out = []
    for i, f in enumerate(frames):
        c = coded[i] if hasattr(coded, "__len__") else coded
        pcm, _, _ = dec.decode_superframe(f, bw, c, 20, False)
        if c < C:
            pcm = np.repeat(pcm, C, axis=1)
        out.append(np.asarray(rs.process(pcm, 960), np.float64))
    return np.concatenate(out, axis=0)


def _device_stream(model, b, rounds_pcm, lengths):
    """Concatenate a lane's end-aligned valid slot samples."""
    parts = []
    for i in range(rounds_pcm.shape[0]):
        m = int(lengths[i, b])
        if m:
            parts.append(np.asarray(
                rounds_pcm[i, b, :, model.FRAME - m:], np.float64).T)
    return (np.concatenate(parts, axis=0) if parts
            else np.zeros((0, model.C)))


def _snr(ref, x):
    n = min(len(ref), len(x))
    e = ref[:n] - x[:n]
    p = float((ref[:n] ** 2).sum())
    return 10 * np.log10(p / max(float((e ** 2).sum()), 1e-300))


def test_device_silk_matches_host_engine_fixture_wb():
    """Fixture WB voice through the device model vs the host engine
    (BatchedSilkDecoder), including an idle round and a recycled lane
    (fresh-state zeroing in the step)."""
    from soundkit_tpu.models.opus_batch import (BatchedSilkDecoder,
                                                BatchedSilkDeviceDecoder)

    frames = _fixture_silk_frames()
    assert len(frames) > 40
    B = 4
    host = BatchedSilkDecoder(B, channels=1)
    dev = BatchedSilkDeviceDecoder(B, channels=1)
    for m in (host, dev):
        for b in range(B):
            m.push_packet(b, frames[b], 2, 1)
    hp, hl = host.decode_ready()
    dp, dl = dev.decode_ready()
    assert (hl == dl).all()
    # recycle lane 2 onto a different stream position, go on
    for m in (host, dev):
        m.reset_lane(2)
    h_acc, d_acc = [hp], [dp]
    hl_acc, dl_acc = [hl], [dl]
    for r in range(1, 9):
        for b in range(B):
            f = frames[(r + 5 * b) % len(frames)]
            if b == 1 and r == 4:
                continue  # idle round for lane 1
            for m in (host, dev):
                m.push_packet(b, f, 2, 1)
        hp, hl = host.decode_ready()
        dp, dl = dev.decode_ready()
        h_acc.append(hp)
        d_acc.append(np.asarray(dp))
        hl_acc.append(hl)
        dl_acc.append(dl)
    hp = np.concatenate(h_acc)
    dp = np.concatenate(d_acc)
    hl = np.concatenate(hl_acc)
    dl = np.concatenate(dl_acc)
    assert (hl == dl).all()  # WB: identical slot bookkeeping
    for b in range(B):
        h = _device_stream(host, b, hp, hl)
        d = _device_stream(dev, b, dp, dl)
        assert h.shape == d.shape
        assert _snr(h, d) > 95, f"lane {b}"


@pytest.mark.parametrize("bw,stereo", [(0, False), (1, True),
                                       (2, True)])
def test_device_silk_kernel_f64_matches_oracle(bw, stereo):
    """f64 device kernel vs per-stream oracle: equal to the host
    resampler's own f32 arithmetic noise, including NB's
    time-varying stream start (silk_batch.first_slot_correction)."""
    import jax
    import jax.numpy as jnp

    from soundkit_tpu.codecs.silk_native import NativeSilkBatch
    from soundkit_tpu.ops import silk_batch as sb

    with jax.enable_x64():
        rounds = 8
        frames = _enc_frames(bw, stereo, rounds)
        C = 2 if stereo else 1
        orc = _oracle_stream(frames, bw, C)
        parser = NativeSilkBatch(1, C)
        state = tuple(jnp.asarray(s)
                      for s in sb.init_state(1, bw, np.float64))
        dev = []
        for r, f in enumerate(frames):
            p = parser.parse_many([f], [bw], [C], [20], [1])
            y, *state = sb.silk_round(
                bw, stereo,
                p["exc"], p["gains"], p["coef"],
                np.ascontiguousarray(p["flags"][:, 7:9]),
                np.ascontiguousarray(p["flags"][:, 5:7]),
                p["lags"], p["ltp"], p["ltpscale"],
                np.ascontiguousarray(p["flags"][:, 9:11]),
                (p["flags"][:, 2] == 2).astype(np.int32),
                np.ascontiguousarray(p["flags"][:, 4]),
                p["stereo_w"], np.ones(1), np.ones(1, bool),
                np.asarray([1.0 if r == 0 else 0.0]), *state)
            dev.append(np.asarray(y)[0, :C].T)
        d = np.concatenate(dev, 0)[sb.lead_invalid(bw):]
        m = min(len(orc), len(d))
        assert m >= rounds * 960 - 24
        assert float(np.abs(orc[:m] - d[:m]).max()) < 3e-7


def test_device_silk_nb_lengths_and_preskip():
    """NB slot bookkeeping: first slot short by lead_invalid (23),
    pre-skip consumed off the front, stream content equal to the
    oracle."""
    from soundkit_tpu.models.opus_batch import BatchedSilkDeviceDecoder
    from soundkit_tpu.ops import silk_batch as sb

    rounds = 6
    frames = _enc_frames(0, False, rounds)
    lead = sb.lead_invalid(0)
    assert lead == 23
    skip = 100
    dev = BatchedSilkDeviceDecoder(1, channels=1)
    dev.configure_lane(0, pre_skip=skip)
    for f in frames:
        dev.push_packet(0, f, 0, 1)
    pcm, lengths = dev.decode_ready()
    assert lengths[0, 0] == 960 - lead - skip
    assert (lengths[1:, 0] == 960).all()
    d = _device_stream(dev, 0, pcm, lengths)[:, 0]
    orc = _oracle_stream(frames, 0, 1)[skip:, 0]
    m = min(len(orc), len(d))
    assert _snr(orc[:m], d[:m]) > 95


def test_device_silk_stereo_midonly_and_channel_switches():
    """libopus stereo voice with midonly packets and forced
    mono/stereo coding switches, served in-lane by the device model."""
    import ctypes

    op = ctypes.CDLL("libopus.so.0")
    op.opus_encoder_create.restype = ctypes.c_void_p
    op.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    op.opus_encode_float.restype = ctypes.c_int
    op.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    err = ctypes.c_int(0)
    enc = ctypes.c_void_p(op.opus_encoder_create(
        48000, 2, 2048, ctypes.byref(err)))
    for req, v in ((4024, 3001), (4002, 24000), (4004, 1103)):
        assert op.opus_encoder_ctl(enc, req, v) == 0
    rng = np.random.default_rng(9)
    n = 48000 * 2
    t = np.arange(n) / 48000.0
    base = (0.4 * np.sin(2 * np.pi * 180 * t)
            * (1 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
            + 0.01 * rng.standard_normal(n))
    R = base.copy()
    third = n // 3
    R[third:2 * third] = np.concatenate(
        [np.zeros(12), 0.6 * base[third:2 * third - 12]])
    x = np.stack([base, R], 1).astype(np.float32)
    items = []
    n_mid = 0
    for k, i in enumerate(range(0, n - 960, 960)):
        op.opus_encoder_ctl(enc, 4022, 1 if (k // 20) % 2 else 2)
        buf = ctypes.create_string_buffer(4000)
        r = op.opus_encode_float(
            enc, np.ascontiguousarray(x[i:i + 960]).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), 960, buf, 4000)
        toc, frames = parse_packet(buf.raw[:r])
        assert toc.mode == "silk" and toc.bandwidth == 2
        items.append((frames[0], 2 if toc.stereo else 1))
    codeds = [c for _, c in items]
    assert 1 in codeds and 2 in codeds  # both codings exercised

    from soundkit_tpu.models.opus_batch import BatchedSilkDeviceDecoder

    dev = BatchedSilkDeviceDecoder(1, channels=2)
    for f, c in items:
        dev.push_packet(0, f, 2, c)
    pcm, lengths = dev.decode_ready()
    d = _device_stream(dev, 0, pcm, lengths)
    orc = _oracle_stream([f for f, _ in items], 2, codeds)
    m = min(len(orc), len(d))
    assert m > 90 * 960
    assert _snr(orc[:m], d[:m]) > 95
