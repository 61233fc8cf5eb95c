"""Batched multi-stream model tests: telephony raggedness + golden
parity, AAC flagship sharded over the 8-device mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from soundkit_tpu.core.wav import parse_wav
from soundkit_tpu.models.telephony_batch import BatchedTelephonyDecoder

CLIP = "A_Tusk_is_used_to_make_costly_gifts"


def test_batched_g711_ragged_golden(testdata, golden):
    fixture = (testdata / "g711_ulaw" / f"{CLIP}.ulaw").read_bytes()
    gold = np.frombuffer(
        parse_wav((golden / "g711_ulaw" / f"{CLIP}.decoded.wav").read_bytes()).data, "<i2"
    )
    B = 8
    model = BatchedTelephonyDecoder("g711_mulaw", B, chunk_codes=4096)
    # ragged feeds
    feeds = [len(fixture), len(fixture) // 2, 100, len(fixture), 0, 5000, 1, len(fixture)]
    for i, n in enumerate(feeds):
        model.push(i, fixture[:n])
    got = [np.zeros(0, np.int16)] * B
    while True:
        pcm, lens = model.decode_step()
        if lens.sum() == 0:
            break
        for i in range(B):
            got[i] = np.concatenate([got[i], pcm[i, : lens[i]].astype(np.int16)])
    for i, n in enumerate(feeds):
        np.testing.assert_array_equal(got[i], gold[:n], err_msg=f"lane {i}")


def test_batched_g726_vs_streaming(testdata, golden):
    fixture = (testdata / "g726" / f"{CLIP}_32.g726").read_bytes()
    gold = np.frombuffer(
        parse_wav((golden / "g726" / f"{CLIP}_32.decoded.wav").read_bytes()).data, "<i2"
    )
    B = 4
    model = BatchedTelephonyDecoder("g726_32", B, chunk_codes=2048)
    for i in range(B):
        model.push(i, fixture)
    got = [np.zeros(0, np.int16)] * B
    while True:
        pcm, lens = model.decode_step()
        if lens.sum() == 0:
            break
        for i in range(B):
            got[i] = np.concatenate([got[i], pcm[i, : lens[i]].astype(np.int16)])
    for i in range(B):
        np.testing.assert_array_equal(got[i], gold, err_msg=f"lane {i}")


def test_batched_g722_golden(testdata, golden):
    fixture = (testdata / "g722" / f"{CLIP}.g722").read_bytes()
    gold = np.frombuffer(
        parse_wav((golden / "g722" / f"{CLIP}.decoded.wav").read_bytes()).data, "<i2"
    )
    model = BatchedTelephonyDecoder("g722", 2, chunk_codes=4096)
    model.push(0, fixture)
    model.push(1, fixture[: len(fixture) // 3])
    got = [np.zeros(0, np.int16)] * 2
    while True:
        pcm, lens = model.decode_step()
        if lens.sum() == 0:
            break
        for i in range(2):
            got[i] = np.concatenate([got[i], pcm[i, : lens[i]].astype(np.int16)])
    np.testing.assert_array_equal(got[0], gold)
    np.testing.assert_array_equal(got[1], gold[: len(got[1])])


def test_aac_flagship_sharded_8dev(golden):
    """The flagship step under stream-axis sharding must equal the
    unsharded result exactly."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from soundkit_tpu.codecs.aac_lc import AdtsStream
    from soundkit_tpu.ops import aac_batch as ab

    assert len(jax.devices()) == 8
    data = (golden / "aac" / f"{CLIP}_encoded.aac").read_bytes()
    stream = AdtsStream()
    aus = stream.push(data)
    frame = stream.decoder.decode_au(aus[8])

    B = 16
    fb = ab.prepare_frame_batch([frame] * B)
    saved, prev = ab.init_state(B)
    args = (fb.quant, fb.scale, fb.ms_mask, fb.int_factor, fb.perm, fb.filt_id,
            fb.lpc, fb.seq, fb.shape, prev, fb.chan_valid, saved)

    plain = jax.jit(ab.aac_decode_frame_device)(*[jnp.asarray(a) for a in args])

    mesh = Mesh(np.array(jax.devices()), ("streams",))
    def shard(a):
        return jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, P("streams", *([None] * (np.ndim(a) - 1))))
        )
    sharded = jax.jit(ab.aac_decode_frame_device)(*[shard(a) for a in args])

    np.testing.assert_allclose(np.asarray(plain[0]), np.asarray(sharded[0]), atol=1e-6)
    # output really is sharded across devices
    assert len(sharded[0].sharding.device_set) == 8


def test_batched_opus_decoder():
    """Host-parallel lockstep Opus serving model vs OpusStreamDecoder
    (float-identical; first slot short by the head's preskip)."""
    from soundkit_tpu.codecs.encoders import OpusEncoder
    from soundkit_tpu.codecs.opus import OpusStreamDecoder
    from soundkit_tpu.models.opus_batch import BatchedOpusDecoder

    t = np.arange(48000) / 48000.0
    pcm = (np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)], 1)
           .reshape(-1) * 12000).astype(np.int16)
    enc = OpusEncoder(48000, 2, 96000, backend="libopus")
    stream = enc.encode_to_soundkit_stream(pcm)
    ref = OpusStreamDecoder().decode_f32(stream)

    B = 3
    m = BatchedOpusDecoder(B, channels=2)
    m.push(0, stream)
    for i in range(0, len(stream), 501):  # chunked lane
        m.push(1, stream[i : i + 501])
    m.push(2, stream)
    out, lens = m.decode_ready()
    assert out.shape[2:] == (2, 960)
    assert lens[0, 0] < 960 <= lens[1, 0]  # preskip shortens slot 0
    parts = [out[i, 0, :, : lens[i, 0]] for i in range(out.shape[0])]
    got = np.concatenate(parts, axis=1).T.reshape(-1)
    n = min(len(got), len(ref))
    err = ref[:n] - got[:n]
    snr = 10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err**2), 1e-30))
    assert snr > 90, f"batched opus {snr:.1f} dB"
    assert np.array_equal(out[:, 0], out[:, 1])
    # drained
    out2, lens2 = m.decode_ready()
    assert out2.shape[0] == 0


def test_batched_celt_device_decoder(testdata):
    """Device-CELT serving model vs the owned host decoder on the
    fixture corpus: host range decode + one jitted synthesis step per
    lockstep round, ragged lanes frozen and resumed."""
    import struct as _struct

    from soundkit_tpu.codecs.opus import OggOpusDemuxer, OpusStreamDecoder
    from soundkit_tpu.models.opus_batch import BatchedCeltDecoder

    data = (testdata / "ogg_opus" / f"{CLIP}.ogg").read_bytes()
    dmx = OggOpusDemuxer()
    pkts = dmx.push(data)[:48]
    head = dmx.head
    wire = head.raw[:19] + b"".join(
        _struct.pack("<H", len(p)) + p for p in pkts
    )
    ref = OpusStreamDecoder().decode_f32(wire).astype(np.float64)

    B = 3
    m = BatchedCeltDecoder(B, channels=head.channels)
    m.push(0, wire)
    for i in range(0, len(wire), 313):  # chunked lane
        m.push(1, wire[i : i + 313])
    m.push(2, wire[:19])
    for p in pkts[:20]:
        m.push_packet(2, p)
    out, lens = m.decode_ready()
    assert out.shape == (len(pkts), B, head.channels, 960)
    assert lens[0, 0] == 960 - head.pre_skip  # preskip shortens slot 0
    assert lens[20:, 2].sum() == 0  # ragged lane froze

    def lane(b, outs, lenss):
        parts = [o[b, :, : l[b]] for o, l in zip(outs, lenss) if l[b]]
        return np.concatenate(parts, axis=1).T.reshape(-1)

    for b in (0, 1):
        got = lane(b, out, lens)
        n = min(len(got), len(ref))
        err = ref[:n] - got[:n]
        snr = 10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err**2), 1e-30))
        assert snr > 90, f"lane {b}: {snr:.1f} dB"

    # resume the frozen lane: state must pick up exactly where it froze
    for p in pkts[20:]:
        m.push_packet(2, p)
    out2, lens2 = m.decode_ready()
    got = np.concatenate(
        [lane(2, out, lens), lane(2, out2, lens2)]
    )
    n = min(len(got), len(ref))
    err = ref[:n] - got[:n]
    snr = 10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err**2), 1e-30))
    assert snr > 90, f"resumed lane: {snr:.1f} dB"


def test_batched_celt_i16_wire(testdata):
    """wire="i16" serving mode: the spectral wire ships int16 with
    per-(round, lane, band) f32 scales (skt_celt_parse_many_q) —
    half the h2d bytes of the exact f32 plane.  Must stay within
    ~quantization distance of the f32 path (>=90 dB, above the
    fleet's i16 output floor) and identical across lanes."""
    from soundkit_tpu.codecs.opus import OggOpusDemuxer
    from soundkit_tpu.models.opus_batch import BatchedCeltDecoder

    data = (testdata / "ogg_opus" / f"{CLIP}.ogg").read_bytes()
    dmx = OggOpusDemuxer()
    pkts = dmx.push(data)
    head = dmx.head

    out = {}
    for wire in ("f32", "i16"):
        m = BatchedCeltDecoder(2, channels=head.channels, wire=wire)
        if m._native is None:
            pytest.skip("native celt backend unavailable")
        for b in range(2):
            m.configure_lane(b, pre_skip=head.pre_skip)
            for p in pkts:
                m.push_packet(b, p)
        pcm, lens = m.decode_ready(device_out=True)
        out[wire] = np.asarray(pcm).astype(np.float64)
    ref, got = out["f32"], out["i16"]
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
    snr = 10 * np.log10(
        np.sum(ref**2) / max(np.sum((ref - got) ** 2), 1e-30))
    assert snr > 90, f"i16 wire vs f32 wire: {snr:.1f} dB"


def test_batched_celt_device_out(testdata):
    """device_out=True keeps pcm on device (no d2h in the hot path)
    and must equal the host path sample for sample — valid samples sit
    at the END of each slot under the device convention."""
    import struct as _struct

    from soundkit_tpu.codecs.opus import OggOpusDemuxer
    from soundkit_tpu.models.opus_batch import BatchedCeltDecoder

    data = (testdata / "ogg_opus" / f"{CLIP}.ogg").read_bytes()
    dmx = OggOpusDemuxer()
    pkts = dmx.push(data)[:24]
    head = dmx.head
    wire = head.raw[:19] + b"".join(
        _struct.pack("<H", len(p)) + p for p in pkts
    )
    B = 2
    m_host = BatchedCeltDecoder(B, channels=head.channels)
    m_dev = BatchedCeltDecoder(B, channels=head.channels)
    for m in (m_host, m_dev):
        m.push(0, wire)
        m.push(1, wire)
    out_h, len_h = m_host.decode_ready()
    out_d, len_d = m_dev.decode_ready(device_out=True)
    assert np.array_equal(len_h, len_d)
    out_d = np.asarray(out_d)
    assert out_d.shape == out_h.shape
    F = m_host.FRAME
    for i in range(out_h.shape[0]):
        for b in range(B):
            k = len_h[i, b]
            np.testing.assert_array_equal(
                out_h[i, b, :, :k], out_d[i, b, :, F - k:]
            )


def test_celt_synth_sharded_8dev(testdata):
    """celt_synth_step is sharding-invariant over the streams axis of
    the 8-device mesh (the serving scale-out path)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from soundkit_tpu.codecs.opus import OggOpusDemuxer
    from soundkit_tpu.codecs.opus_core import OpusDecoder, parse_packet
    from soundkit_tpu.codecs.opus_rc import RangeDecoder
    from soundkit_tpu.codecs.opus_celt import CeltDecoder, tables
    from soundkit_tpu.ops.celt_batch import (
        HIST,
        celt_synth_step,
        pack_comb_params,
    )

    data = (testdata / "ogg_opus" / f"{CLIP}.ogg").read_bytes()
    dmx = OggOpusDemuxer()
    pkts = dmx.push(data)
    t = tables()
    band_end = t["celt_band_end"].astype(int)
    taps = t["celt_postfilter_taps"].astype(np.float64)
    dec = CeltDecoder(1)
    rng = np.random.default_rng(0)
    B, C = 8, 1
    freqs, sflags, combs = [], [], []
    for p in pkts[:B]:
        toc, frames = parse_packet(p)
        rc = RangeDecoder(frames[0])
        dec.decode_frame(rc, 960, 0, int(band_end[toc.bandwidth]), 1,
                         parse_only=True)
        lp = dec.last_parse
        freqs.append(lp["freq"].astype(np.float32))
        sflags.append(int(bool(lp["shortBlocks"])))
        combs.append(pack_comb_params(lp["pf_state"], lp["pf_period"],
                                      lp["pf_gain"], lp["pf_tapset"], taps))
    args = (
        np.stack(freqs), np.asarray(sflags, np.int32),
        np.stack(combs).astype(np.float32),
        rng.normal(size=(B, C, 120)).astype(np.float32) * 0.01,
        rng.normal(size=(B, C, HIST)).astype(np.float32) * 0.01,
        rng.normal(size=(B, C)).astype(np.float32),
    )
    plain = jax.jit(celt_synth_step)(*args)

    mesh = Mesh(np.array(jax.devices()[:8]), ("streams",))

    def shard(a):
        return jax.device_put(
            jnp.asarray(a),
            NamedSharding(mesh, P("streams", *([None] * (np.ndim(a) - 1)))),
        )

    sharded = jax.jit(celt_synth_step)(*[shard(a) for a in args])
    for p, s in zip(plain, sharded):
        np.testing.assert_allclose(np.asarray(p), np.asarray(s), atol=1e-5)
    assert len(sharded[0].sharding.device_set) == 8


def test_no_recompilation_steady_state(testdata):
    """Device analog of the reference's zero-allocation steady-state test
    (soundkit-aac-lc/tests/no_alloc_decode.rs): after the first batch
    compiles, every further lockstep batch must hit the jit cache.  A
    retrace in the serving loop is the device equivalent of a
    per-frame allocation regression (a recompile stall)."""
    import logging

    import jax

    from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder

    class _CompileCounter(logging.Handler):
        def __init__(self, name):
            super().__init__()
            self.name, self.n = name, 0

        def emit(self, record):
            if f"Compiling jit({self.name}" in record.getMessage():
                self.n += 1

    lg = logging.getLogger("jax._src.interpreters.pxla")
    old_level = lg.level
    counters = [_CompileCounter("aac_decode_frame_device"),
                _CompileCounter("mp3_granule_device_compact")]
    for c in counters:
        lg.addHandler(c)
    lg.setLevel(logging.DEBUG)
    jax.config.update("jax_log_compiles", True)
    try:
        aac = (testdata.parent / "golden" / "aac" / f"{CLIP}_encoded.aac").read_bytes()
        m = BatchedAacLcDecoder(2, 2)
        m.push(0, aac)
        m.push(1, aac[: len(aac) // 2])
        # warmup: first batches may compile (and the sticky v4 scan
        # bucket may grow to the content's peak) — that's lifetime
        # O(log) work, not a steady-state property
        m.decode_ready(max_frames=40)
        n_warm = counters[0].n
        m.push(1, aac[len(aac) // 2 :])
        m.decode_ready()  # ragged + full drain: steady state
        steady = counters[0].n - n_warm
        # one late bucket growth is tolerated; per-batch retraces are
        # the regression this guards against (a 20-40 s stall per
        # frame on a real chip)
        assert steady <= 1, f"AAC step compiled {steady}x in steady state"

        mp3 = (testdata / "mp3" / f"{CLIP}.mp3").read_bytes()
        m2 = BatchedMp3Decoder(2, channels=1)
        m2.push(0, mp3)
        m2.push(1, mp3)
        m2.decode_ready(max_granules=5)
        m2.decode_ready()
        assert counters[1].n <= 1, f"MP3 step compiled {counters[1].n}x"
    finally:
        jax.config.update("jax_log_compiles", False)
        for c in counters:
            lg.removeHandler(c)
        lg.setLevel(old_level)


@pytest.mark.parametrize("codec", ["g711_mulaw", "g726_32", "g722"])
def test_batched_telephony_encoder_matches_single_stream(codec):
    """Batched encode wire bytes == single-stream encoder, ragged lanes."""
    from soundkit_tpu.models.telephony_batch import BatchedTelephonyEncoder

    rng = np.random.default_rng(2)
    n = 16000 if codec != "g722" else 32000
    rate = 8000 if codec != "g722" else 16000
    t = np.arange(n) / rate
    pcm = (np.sin(2 * np.pi * 440 * t) * 12000 + rng.standard_normal(n) * 200).astype(np.int16)

    enc = BatchedTelephonyEncoder(codec, 2)
    enc.push(0, pcm)
    enc.push(1, pcm[: n // 2])  # ragged
    wires = [b"", b""]
    while True:
        outs = enc.encode_step()
        if not any(outs):
            break
        for i in range(2):
            wires[i] += outs[i]

    if codec == "g711_mulaw":
        from soundkit_tpu.ops import companding

        ref = companding.encode_mulaw_np(pcm).astype(np.uint8).tobytes()
    elif codec == "g722":
        from soundkit_tpu.codecs.g722 import G722Encoder

        ref = G722Encoder().encode_i16(pcm)
    else:
        from soundkit_tpu.codecs.g726 import G726Encoder, G726Packing, G726Rate

        ref = G726Encoder(G726Rate.RATE_32000, G726Packing.LEFT).encode_i16(pcm)

    assert wires[0] == ref[: len(wires[0])] and len(wires[0]) >= len(ref) - 8
    assert wires[1] == ref[: len(wires[1])]  # ragged lane = prefix


def _snr(ref, test):
    n = min(len(ref), len(test))
    err = ref[:n] - test[:n]
    return 10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err**2), 1e-30))


def _tone_i16(rate, ch, seed):
    rng = np.random.default_rng(seed)
    n = rate
    t = np.arange(n) / rate
    sig = np.sin(2 * np.pi * 440 * t) * 0.5 + rng.standard_normal(n) * 0.05
    if ch == 2:
        r = np.sin(2 * np.pi * 660 * t) * 0.5 + rng.standard_normal(n) * 0.05
        sig = np.stack([sig, r], 1).reshape(-1)
    return (sig * 20000).clip(-32768, 32767).astype(np.int16)


def test_mixed_rate_aac_group_per_lane_banding():
    """Two ADTS streams at DIFFERENT sample rates share one batched
    group: each lane must be parsed with its own rate's scalefactor
    band tables (one C parse call per distinct sr_index) and report its
    own rate. Regression: a single group-wide parser mis-banded every
    lane whose rate differed from the first stream's."""
    import soundkit_tpu.ops.aac_dsp as dsp
    from soundkit_tpu.codecs.aac_lc import AacLcDecoder, AdtsStream
    from soundkit_tpu.codecs.encoders import AacEncoder
    from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder

    streams = []
    for rate, kbps, seed in ((48000, 96000, 1), (16000, 48000, 2)):
        pcm = _tone_i16(rate, 1, seed)
        enc = AacEncoder(rate, 1, kbps)
        streams.append(enc.encode_i16(pcm) + enc.flush())

    hosts = []
    for adts in streams:
        st = AdtsStream()
        aus = st.push(adts)
        dec = AacLcDecoder(st.sr_index)
        synth = dsp.AacLcSynth(st.sr_index)
        hosts.append(
            np.concatenate([synth.process_frame(dec.decode_au(au)) for au in aus], axis=1)[0]
        )

    m = BatchedAacLcDecoder(2, 1)
    m.push(0, streams[0])
    m.push(1, streams[1])
    assert m.lane_sample_rate(0) == 48000
    assert m.lane_sample_rate(1) == 16000
    out = m.decode_batches(max(m.lane_ready(0), m.lane_ready(1)))
    for lane, host in enumerate(hosts):
        got = out[:, lane, 0].reshape(-1)
        snr = _snr(host, got)
        assert snr > 90, f"lane {lane} ({m.lane_sample_rate(lane)} Hz): {snr:.1f} dB"


def test_mixed_rate_mp3_group_reports_per_lane_rates():
    """Mixed-rate MP3 lanes in one group: correct decode per lane and
    per-lane rate surfacing (the group-level .sample_rate only reports
    the first rate seen)."""
    from soundkit_tpu.codecs.encoders import Mp3Encoder
    from soundkit_tpu.codecs.mp3_native import Mp3NativeDecoder
    from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu.ops.mp3_dsp import Mp3Synth

    streams, hosts = [], []
    for rate, kbps, seed in ((44100, 128000, 3), (12000, 40000, 4)):
        pcm = _tone_i16(rate, 1, seed)
        e = Mp3Encoder(rate, 1, kbps)
        mp3 = e.encode_i16(pcm) + e.flush()
        streams.append(mp3)
        frames = Mp3NativeDecoder().push(mp3)
        synth = Mp3Synth()
        hosts.append(np.concatenate([synth.process_frame(f) for f in frames], axis=1)[0])

    m = BatchedMp3Decoder(2, channels=1)
    m.push(0, streams[0])
    m.push(1, streams[1])
    out = m.decode_batches(max(m.lane_ready(0), m.lane_ready(1)))
    assert m.lane_sample_rate(0) == 44100
    assert m.lane_sample_rate(1) == 12000
    for lane, host in enumerate(hosts):
        got = out[:, lane, 0].reshape(-1)
        snr = _snr(host, got)
        assert snr > 90, f"lane {lane} ({m.lane_sample_rate(lane)} Hz): {snr:.1f} dB"
    m.reset_lane(1)
    assert m.lane_sample_rate(1) is None


def test_aac_model_falls_back_when_v3_overflows(monkeypatch, golden):
    """When the v3 wire's escape/run budgets overflow, the serving
    model must silently fall back to the compact wire and keep
    decoding correctly."""
    import soundkit_tpu.models.aac_lc_batch as mod
    from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder

    golden_adts = (
        golden / "aac" / "A_Tusk_is_used_to_make_costly_gifts_encoded.aac"
    ).read_bytes()
    ref = BatchedAacLcDecoder(1)
    ref.push(0, golden_adts)
    want = np.asarray(ref.decode_batches(4))

    forced = BatchedAacLcDecoder(1)
    monkeypatch.setattr(
        mod.BatchedAacLcDecoder, "_try_v3", lambda self, aus: None
    )
    forced.push(0, golden_adts)
    got = np.asarray(forced.decode_batches(4))
    np.testing.assert_allclose(got, want, atol=1e-5)
