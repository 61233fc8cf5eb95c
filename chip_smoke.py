"""Smoke run of the serving path on one GPU.

    python chip_smoke.py

One process, one card.  Exits non-zero without a result when JAX finds
no GPU.  Phases, each of which raises on failure:

- ``aac_1024``: ``StreamFleet`` serving 1024 concurrent stereo AAC-LC
  streams of the corpus clip (lane i starts i ADTS frames in, wrapping
  around).  Every frame batch must ride the v4 device-entropy wire,
  and sampled lanes must agree with the owned numpy decoder
  (``codecs/aac_lc``), run on the CPU over the same bytes, at >= 90 dB.
- ``fleet_groups``: one fleet with 64 lanes in each batched group: AAC,
  MP3, FLAC, Vorbis, Opus (CELT, SILK and hybrid lanes), and G.711,
  G.722 and G.726 by explicit kind, every lane's bytes distinct and
  of its own length (``lane_units``).  Sampled lanes of each group are
  compared with the group's single-stream host decoder on the CPU, at
  the bar that group's CPU tests assert; no stream may leave its
  group for a host fallback.
- ``flac_encode``: the batched FLAC encoder at B=256 under x64; every
  stream must decode bit-exactly with a valid STREAMINFO MD5.

Each phase prints its compile seconds, wall seconds and x realtime of
the served path (audio seconds at each stream's own rate over wall
seconds); these are bring-up readings, not a benchmark.  The last
line is one JSON object naming the device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

AAC_CLIP = "music_aac_lc_48k.aac"
MP3_CLIP = "music_44k.mp3"
VORBIS_CLIP = "music_48k.ogg"
TELEPHONY = ("g711_mulaw", "g711_alaw", "g722",
             "g726_16", "g726_24", "g726_32", "g726_40")


class CompileMeter:
    """Seconds JAX spent tracing, lowering and compiling (or fetching
    from the persistent cache), read from ``jax.monitoring``."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, secs: float, **_) -> None:
        if event.startswith("/jax/core/compile/"):
            self.seconds += secs


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    n = min(ref.shape[-1], got.shape[-1])
    ref = np.asarray(ref[..., :n], np.float64)
    err = np.asarray(got[..., :n], np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2),
                                                       1e-30)))


def serve(fleet, streams: dict, keep, rounds: int = 4) -> dict:
    """Push each stream in ``rounds`` chunks (collecting after each
    round), end it, and collect until every lane has drained.

    ``streams`` maps stream id -> (bytes, explicit kind or None).
    Returns samples per stream, the PCM of the ``keep`` streams, the
    group each stream was served by, and the wall seconds."""
    samples = dict.fromkeys(streams, 0)
    kept = {sid: [] for sid in keep}

    def absorb(out):
        for sid, pcm in out.items():
            samples[sid] += pcm.shape[-1]
            if sid in kept:
                kept[sid].append(pcm)

    t0 = time.perf_counter()
    for r in range(rounds):
        for sid, (data, kind) in streams.items():
            a, b = len(data) * r // rounds, len(data) * (r + 1) // rounds
            fleet.push(sid, data[a:b], kind=kind if r == 0 else None)
            if r == rounds - 1:
                fleet.end_stream(sid)
        if r == rounds - 1:
            # every stream is routed and no lane is released before
            # the next collect: a stream off its lane went to a
            # per-stream host decoder
            groups = {sid: fleet.lane_group(sid) for sid in streams}
        absorb(fleet.collect())
    for _ in range(8):
        if not any(fleet.lane_group(sid) for sid in streams):
            break
        absorb(fleet.collect())
    else:
        raise RuntimeError("fleet did not drain")
    wall = time.perf_counter() - t0
    return {"samples": samples, "wall": wall, "groups": groups,
            "pcm": {sid: np.concatenate(p, axis=1) for sid, p in kept.items()}}


def _report(name: str, compile_s: float, wall: float, audio_s: float,
            **extra) -> dict:
    rec = {"phase": name, "compile_s": round(compile_s, 3),
           "wall_s": round(wall, 3),
           "audio_s": round(audio_s, 3),
           "x_realtime": round(audio_s / wall, 2), **extra}
    print(json.dumps(rec), flush=True)
    return rec


# -- aac_1024 ----------------------------------------------------------------

def aac_reference(data: bytes) -> np.ndarray:
    """Owned numpy AAC-LC decode of an ADTS stream -> [C, n] f32."""
    from soundkit_tpu.codecs.aac_lc import AacLcDecoder, AdtsStream
    from soundkit_tpu.ops.aac_dsp import AacLcSynth

    st = AdtsStream()
    aus = st.push(data)
    dec = AacLcDecoder(st.sr_index)
    synth = AacLcSynth(st.sr_index)
    return np.concatenate([synth.process_frame(dec.decode_au(au))
                           for au in aus], axis=1)


def rotated_aac(lanes: int, seconds: float = 0.0):
    """Lane i's stream: the corpus AAC clip starting i frames in."""
    from corpus import make_corpus as mc

    data = mc.load(AAC_CLIP)
    if seconds:
        data = mc.clip(AAC_CLIP, data, seconds)
    frames = mc.adts_frames(data)
    n = len(frames)
    return [b"".join(frames[i % n:] + frames[:i % n]) for i in range(lanes)], n


def phase_aac(meter: CompileMeter, lanes: int = 1024,
              seconds: float = 0.0) -> dict:
    from soundkit_tpu.models.fleet import StreamFleet

    streams, n_frames = rotated_aac(lanes, seconds)
    checked = sorted({0, 1, 2, lanes // 2 - 1, lanes // 2,
                      lanes - 3, lanes - 2, lanes - 1})
    compile0 = meter.seconds
    fleet = StreamFleet(capacity_per_group=lanes, channels=2)
    res = serve(fleet, {f"a{i}": (s, None) for i, s in enumerate(streams)},
                keep=[f"a{i}" for i in checked])
    compile_s = meter.seconds - compile0
    off_group = [s for s, g in res["groups"].items() if g != "aac"]
    if off_group:
        raise AssertionError(f"{len(off_group)} AAC streams left the aac "
                             f"group, e.g. {off_group[:4]}")
    counts = fleet.group_model("aac").wire_counts
    if counts["v4"] == 0 or any(counts[k] for k in ("v3", "compact", "full")):
        raise AssertionError(f"AAC batches off the v4 wire: {counts}")
    want = n_frames * 1024
    short = {s: n for s, n in res["samples"].items() if n != want}
    if short:
        raise AssertionError(f"lanes with {want} samples expected: "
                             f"{list(short.items())[:4]}")
    snrs = {}
    for i in checked:
        snrs[i] = snr_db(aac_reference(streams[i]), res["pcm"][f"a{i}"])
    worst = min(snrs.values())
    if worst < 90.0:
        raise AssertionError(f"AAC lanes below 90 dB: {snrs}")
    return _report("aac_1024", compile_s, res["wall"],
                   lanes * want / 48000, lanes=lanes, wire=counts,
                   min_snr_db=round(worst, 2),
                   checked_lanes=len(checked))


# -- fleet_groups ------------------------------------------------------------

def lane_units(units: list, i: int, lanes: int, wrap: bool = True) -> list:
    """Lane i's share of a base stream's whole units (frames, packets,
    pages, code blocks): rotated by i / lanes of the stream (or, with
    ``wrap=False``, started there), then shortened by 0-3 sixteenths,
    so that every lane's content differs from every other's and
    neighbouring lanes drain at different rounds."""
    n = len(units)
    r = i * n // lanes if wrap else i * n // (2 * lanes)
    units = units[r:] + units[:r] if wrap else units[r:]
    return units[: len(units) - (i % 4) * (n // 16)]


def group_streams(lanes: int, seconds: float) -> dict:
    """Per group: (kind passed to push, rate, lanes), each lane
    (bytes, source, label): ``source`` is the encoder's int16 input
    where the group is lossless, else None; ``label`` names the
    stream's kind within its group.  Every lane's bytes are distinct
    (see ``lane_units``)."""
    from corpus import make_corpus as mc
    from soundkit_tpu.demux.ogg import OggPacketizer

    aac = mc.adts_frames(mc.clip(AAC_CLIP, mc.load(AAC_CLIP), seconds))
    mp3 = mc.clip(MP3_CLIP, mc.load(MP3_CLIP), seconds)
    mp3 = [mp3[a:a + n] for a, n in mc.mp3_frames(mp3)]
    vorbis = mc.ogg_pages(mc.clip(VORBIS_CLIP, mc.load(VORBIS_CLIP),
                                  seconds))
    out = {
        "aac": (None, 48000, [
            (b"".join(lane_units(aac, i, lanes)), None, "aac")
            for i in range(lanes)]),
        "mp3": (None, 44100, [
            (b"".join(lane_units(mp3, i, lanes)), None, "mp3")
            for i in range(lanes)]),
        # the two header pages, then audio pages from a lane's own start
        "vorbis": (None, 48000, [
            (b"".join(vorbis[:2] + lane_units(vorbis[2:], i, lanes,
                                              wrap=False)), None, "vorbis")
            for i in range(lanes)]),
    }
    base = mc.music(48000, seconds, 10, 2)
    flac = []
    for i in range(lanes):
        pcm = np.roll(base, -i * base.shape[0] // lanes, axis=0)
        pcm = pcm[: pcm.shape[0] - (i % 4) * (pcm.shape[0] // 16)]
        flac.append((mc.flac_bytes(pcm, 48000), pcm, "flac"))
    out["flac"] = (None, 48000, flac)
    opus_kinds = ("opus_celt", "opus_silk", "opus_hybrid")
    opus = {}
    for kind in opus_kinds:
        data = mc.generate(kind, 20, seconds)[0]
        opus[kind] = [p for p, _ in OggPacketizer().push(data)][2:]
    per_kind = -(-lanes // 3)
    out["opus"] = (None, 48000, [
        (mc.ogg_opus(lane_units(opus[kind], i // 3, per_kind),
                     mc.GENERATED[kind][1]), None, kind)
        for i in range(lanes) for kind in [opus_kinds[i % 3]]])
    for kind in TELEPHONY:
        # 120 bytes: whole codes at every G.726 rate
        data = mc.generate(kind, 30, seconds)[0]
        blocks = [data[k:k + 120] for k in range(0, len(data) - 119, 120)]
        out[kind] = (kind, mc.GENERATED[kind][0], [
            (b"".join(lane_units(blocks, i, lanes)), None, kind)
            for i in range(lanes)])
    return out


def host_reference(group: str, data: bytes) -> np.ndarray:
    """The group's single-stream host decoder -> [C, n] f32 (int16
    groups: the exact int16 values as f32)."""
    if group == "aac":
        return aac_reference(data)
    if group == "mp3":
        from soundkit_tpu.codecs.mp3 import Mp3Decoder

        dec = Mp3Decoder()
        pcm = np.concatenate([dec.decode_f32(data), dec.flush_f32()])
        return pcm.reshape(-1, dec.channels).T
    if group == "vorbis":
        from soundkit_tpu.codecs.vorbis import VorbisDecoder

        dec = VorbisDecoder()
        return dec.decode_f32(data).reshape(-1, dec.channels).T
    if group == "opus":
        from soundkit_tpu.codecs.opus import OggOpusDecoder

        dec = OggOpusDecoder()
        return dec.decode_f32(data).reshape(-1, dec.channels).T
    if group.startswith("g711"):
        from soundkit_tpu.codecs.g711 import G711Decoder

        dec = (G711Decoder.new_alaw() if group.endswith("alaw")
               else G711Decoder.new_mulaw())
        return dec.decode_i16(data)[None].astype(np.float32)
    if group == "g722":
        from soundkit_tpu.codecs.g722 import G722Decoder

        return G722Decoder.new_64k().decode_i16(data)[None].astype(
            np.float32)
    from soundkit_tpu.codecs.g726 import G726Decoder, G726Packing, G726Rate

    rate = {"16": G726Rate.RATE_16000, "24": G726Rate.RATE_24000,
            "32": G726Rate.RATE_32000, "40": G726Rate.RATE_40000}
    dec = G726Decoder(rate[group.split("_")[1]], G726Packing.LEFT)
    return dec.decode_i16(data)[None].astype(np.float32)


def check_lane(group: str, label: str, got: np.ndarray, ref,
               source) -> dict:
    """Hold one served lane to its group's bar (``ref``: the host
    decode of its stream; ``source``: the encoder's input where the
    group is lossless); returns the reading."""
    if group == "flac":
        ref = source.T.astype(np.int64)
        pcm = np.round(got[:, : ref.shape[1]] * 32768.0).astype(np.int64)
        if got.shape[1] != ref.shape[1] or not np.array_equal(pcm, ref):
            raise AssertionError(f"flac lane {label} is not bit-exact")
        return {"exact": True}
    if group in TELEPHONY:
        pcm = np.round(got * 32768.0)
        if pcm.shape != ref.shape or not np.array_equal(pcm, ref):
            raise AssertionError(f"{group} lane {label} is not bit-exact")
        return {"exact": True}
    n = min(ref.shape[1], got.shape[1])
    if n < 0.9 * ref.shape[1]:
        raise AssertionError(f"{group} lane {label}: {got.shape[1]} "
                             f"samples for {ref.shape[1]}")
    got = got[: ref.shape[0], :n]
    ref = ref[:, :n]
    snr = snr_db(ref, got)
    err = float(np.abs(got - ref).max())
    # the bars of the groups' CPU tests: tests/test_mp3_native.py,
    # test_batched_models.py (CELT), test_vorbis.py and test_fleet.py
    # (SILK, hybrid)
    if group == "vorbis":
        ok, bar = err <= 2e-6, "max|err| <= 2e-6"
    elif label in ("opus_silk", "opus_hybrid"):
        ok, bar = err <= 1e-4, "max|err| <= 1e-4"
    else:
        ok, bar = snr >= 90.0, "snr >= 90 dB"
    if not ok:
        raise AssertionError(f"{group} lane {label}: {snr:.1f} dB, "
                             f"max|err| {err:.2e}; bar {bar}")
    return {"snr_db": round(snr, 2), "max_err": err, "bar": bar}


def phase_groups(meter: CompileMeter, lanes: int = 64, seconds: float = 9.0,
                 groups=None) -> dict:
    from soundkit_tpu.models.fleet import StreamFleet

    table = group_streams(lanes, seconds)
    if groups is not None:
        table = {g: table[g] for g in groups}
    streams, meta = {}, {}
    for group, (kind, rate, ls) in table.items():
        for i in range(lanes):
            sid = f"{group}:{i}"
            streams[sid] = (ls[i][0], kind)
            meta[sid] = (group, rate, i)
    checked = sorted({0, 1, 2, 3, 4, 5, lanes - 1})
    checked = [i for i in checked if i < lanes]
    keep = [f"{g}:{i}" for g in table for i in checked]
    compile0 = meter.seconds
    fleet = StreamFleet(capacity_per_group=lanes, channels=2)
    res = serve(fleet, streams, keep)
    compile_s = meter.seconds - compile0
    fallback = [s for s, g in res["groups"].items() if g != meta[s][0]]
    if fallback:
        raise AssertionError(f"streams off their group: {fallback[:6]}")
    readings = {}
    for sid in keep:
        group, _, i = meta[sid]
        data, source, label = table[group][2][i]
        ref = None if group == "flac" else host_reference(group, data)
        readings.setdefault(group, []).append(check_lane(
            group, label, res["pcm"][sid], ref, source))
    audio_s = sum(n / meta[s][1] for s, n in res["samples"].items())
    summary = {}
    for group, rs in readings.items():
        snrs = [r["snr_db"] for r in rs if "snr_db" in r]
        summary[group] = ("bit-exact" if not snrs else
                          f"min {min(snrs)} dB, max|err| "
                          f"{max(r['max_err'] for r in rs):.2e}")
    return _report("fleet_groups", compile_s, res["wall"], audio_s,
                   lanes_per_group=lanes, groups=summary)


# -- flac_encode -------------------------------------------------------------

def phase_flac_encode(meter: CompileMeter, lanes: int = 256,
                      seconds: float = 9.0) -> dict:
    import jax

    from corpus import make_corpus as mc
    from soundkit_tpu.codecs.flac import FlacDecoder
    from soundkit_tpu.models.flac_encode_batch import BatchedFlacEncoder

    rate = 48000
    base = [mc.music(rate, seconds, 40 + v).T.astype(np.int64)
            for v in range(4)]
    pcm = [np.roll(base[i % 4], 997 * i, axis=1) for i in range(lanes)]
    compile0 = meter.seconds
    t0 = time.perf_counter()
    with jax.enable_x64(True):
        enc = BatchedFlacEncoder(lanes, rate, 2, 16)
        for i, x in enumerate(pcm):
            enc.push(i, x)
        files = enc.finish_all()
    wall = time.perf_counter() - t0
    compile_s = meter.seconds - compile0
    for i, data in enumerate(files):
        dec = FlacDecoder()
        audio = dec.add(data)
        got = np.frombuffer(audio.data, "<i2").reshape(-1, 2).T
        n = pcm[i].shape[1]
        if got.shape[1] < n or not np.array_equal(got[:, :n], pcm[i]):
            raise AssertionError(f"flac_encode lane {i} is not bit-exact")
        if dec.info["md5"] == bytes(16) or not dec.verify_md5(audio.data):
            raise AssertionError(f"flac_encode lane {i}: bad STREAMINFO MD5")
    return _report("flac_encode", compile_s, wall,
                   lanes * seconds, lanes=lanes,
                   bytes_out=sum(len(f) for f in files))


# -- main --------------------------------------------------------------------

def native_line() -> str:
    from soundkit_tpu.native import loader

    loader.load()
    cxx = os.environ.get("CXX", "g++")
    ver = subprocess.run([cxx, "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    try:
        loader.load_av()
        av = "built"
    except loader.AvUnavailable:
        av = "not built (no libav on this machine)"
    return (f"native: {ver[0] if ver else cxx}; libsoundkit_host.so built; "
            f"libsoundkit_av.so {av}")


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 2
    from soundkit_tpu.utils.backend import enable_compile_cache, gpu_card

    cache = enable_compile_cache()
    import jaxlib

    dev = jax.devices()[0]
    print(f"card: {gpu_card()}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"device {dev.device_kind} x{len(jax.devices())}")
    print(native_line())
    print(f"compile cache: {cache}", flush=True)
    meter = CompileMeter()
    phase_aac(meter)
    phase_groups(meter)
    phase_flac_encode(meter)
    print(f"card: {gpu_card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
