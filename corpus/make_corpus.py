"""In-repo input corpus: seeded synthetic music and voice, encoded.

Two kinds of stream:

- **Committed** (``MANIFEST.json`` lists them with sha256, rate,
  channels and duration): AAC-LC ADTS 48 kHz stereo 128 kb/s, MP3
  44.1 kHz stereo 128 kb/s and Ogg Vorbis 48 kHz stereo.  Making them
  needs libavcodec's encoders (``codecs/encoders.AvEncoder``), which
  the serving machines need not have, so the bytes live in the repo.
  Regenerate with ``python corpus/make_corpus.py`` (rewrites the files
  and the manifest).
- **Generated at run time** from a seed by the owned encoders
  (:func:`generate`): FLAC 16-bit stereo, Ogg Opus in CELT, SILK-WB
  and hybrid modes, G.711 mu/A-law, G.722 and G.726 at their own rates.

The signal is synthetic music: harmonic tones with attack/decay
envelopes and stereo pans over low noise (:func:`music`), or a voiced
glottal-like source for the speech codecs (:func:`voice`).
"""
from __future__ import annotations

import hashlib
import json
import struct
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

CORPUS_DIR = Path(__file__).resolve().parent
MANIFEST = CORPUS_DIR / "MANIFEST.json"

#: committed streams: name -> (codec, rate, channels, seconds, seed, bitrate)
COMMITTED = {
    "music_aac_lc_48k.aac": ("aac", 48000, 2, 9.0, 1, 128000),
    "music_44k.mp3": ("mp3", 44100, 2, 9.0, 2, 128000),
    "music_48k.ogg": ("vorbis", 48000, 2, 9.0, 3, 128000),
}

#: kinds :func:`generate` makes, with their sample rate and channels
GENERATED = {
    "flac": (48000, 2),
    "opus_celt": (48000, 2),
    "opus_silk": (48000, 1),
    "opus_hybrid": (48000, 1),
    "g711_mulaw": (8000, 1),
    "g711_alaw": (8000, 1),
    "g722": (16000, 1),
    "g726_16": (8000, 1),
    "g726_24": (8000, 1),
    "g726_32": (8000, 1),
    "g726_40": (8000, 1),
}


def music(rate: int, seconds: float, seed: int,
          channels: int = 2) -> np.ndarray:
    """Synthetic music as int16 [n, channels]."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    out = np.zeros((n, 2))
    for _ in range(14):
        f0 = 110.0 * 2.0 ** (rng.integers(0, 36) / 12.0)
        on = rng.uniform(0.0, max(seconds - 0.5, 0.1))
        decay = rng.uniform(0.3, 2.5)
        dt = np.clip(t - on, 0.0, None)
        env = np.clip(dt / 0.02, 0.0, 1.0) * np.exp(-3.0 * dt / decay)
        env *= t >= on
        tone = sum(a * np.sin(2 * np.pi * k * f0 * t)
                   for k, a in ((1, 1.0), (2, 0.35), (3, 0.12)))
        pan = rng.uniform(0.2, 0.8)
        out[:, 0] += (1.0 - pan) * env * tone
        out[:, 1] += pan * env * tone
    out = 0.6 * out / max(np.abs(out).max(), 1e-9)
    out += 0.003 * rng.standard_normal(out.shape)
    pcm = np.clip(np.round(out * 32767.0), -32768, 32767).astype(np.int16)
    return pcm[:, :channels]


def voice(rate: int, seconds: float, seed: int) -> np.ndarray:
    """Synthetic voiced speech-like signal as float64 [n] in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f0 = 120.0 + 35.0 * np.sin(2 * np.pi * 2.1 * t + rng.uniform(0, 6))
    phase = np.cumsum(2 * np.pi * f0 / rate)
    syll = 0.3 + 0.7 * np.abs(np.sin(2 * np.pi * 2.7 * t))
    x = (0.35 * np.sin(phase) + 0.18 * np.sin(2 * phase)
         + 0.08 * np.sin(3 * phase)) * syll
    return x + 0.01 * rng.standard_normal(n)


# -- containers ------------------------------------------------------------

def _vorbis_ogg(pcm: np.ndarray, rate: int, bitrate: int) -> bytes:
    """Ogg Vorbis from libvorbis packets, with exact granule positions
    (each audio packet adds prev_blocksize/4 + cur_blocksize/4)."""
    from soundkit_tpu.codecs.encoders import AvEncoder
    from soundkit_tpu.codecs.vorbis import split_xiph_extradata
    from soundkit_tpu.codecs.vorbis_core import BitReader, VorbisSetup, ilog
    from soundkit_tpu.demux.ogg import build_ogg_page

    enc = AvEncoder("libvorbis", rate, pcm.shape[1], bitrate)
    pkts = enc.push_i16(pcm.reshape(-1)) + enc.flush()
    ident, comment, setup = split_xiph_extradata(enc.extradata)
    vs = VorbisSetup(bytes(ident), bytes(setup))
    mode_bits = ilog(len(vs.modes) - 1)
    serial = 0x534B4F56
    out = [build_ogg_page([ident], serial, 0, 0, header_type=2),
           build_ogg_page([comment, setup], serial, 1, 0)]
    granule, prev = 0, None
    for i, p in enumerate(pkts):
        br = BitReader(p)
        br.read1()
        mode = vs.modes[br.read(mode_bits)]
        size = vs.blocksize1 if mode.blockflag else vs.blocksize0
        if prev is not None:
            granule += prev // 4 + size // 4
        prev = size
        last = i == len(pkts) - 1
        g = min(granule, pcm.shape[0]) if last else granule
        out.append(build_ogg_page([p], serial, 2 + i, g,
                                  header_type=4 if last else 0))
    return b"".join(out)


def flac_bytes(pcm: np.ndarray, rate: int) -> bytes:
    from soundkit_tpu.codecs.flac_encode import FlacStreamEncoder

    enc = FlacStreamEncoder(rate, pcm.shape[1], 16)
    enc.add(pcm.T.astype(np.int64))
    return enc.finish()


def ogg_opus(packets: List[bytes], channels: int) -> bytes:
    from soundkit_tpu.demux.ogg import OggOpusWriter

    w = OggOpusWriter(channels)
    for p in packets:
        w.write_packet(p)
    return w.take() + w.close()


def encode_committed(name: str) -> bytes:
    codec, rate, ch, seconds, seed, bitrate = COMMITTED[name]
    pcm = music(rate, seconds, seed, ch)
    if codec == "aac":
        from soundkit_tpu.codecs.encoders import AacEncoder

        enc = AacEncoder(rate, ch, bitrate)
        return enc.encode_i16(pcm.reshape(-1)) + enc.flush()
    if codec == "mp3":
        from soundkit_tpu.codecs.encoders import Mp3Encoder

        enc = Mp3Encoder(rate, ch, bitrate)
        return enc.encode_i16(pcm.reshape(-1)) + enc.flush()
    return _vorbis_ogg(pcm, rate, bitrate)


def generate(kind: str, seed: int, seconds: float) -> Tuple[bytes, np.ndarray]:
    """Encode ``seconds`` of seeded signal with an owned encoder.

    Returns (stream bytes, the int16 [n, C] PCM that went in).
    Telephony kinds are headerless code bytes at the kind's own rate
    (8 kHz; 16 kHz for G.722)."""
    rate, ch = GENERATED[kind]
    if kind == "flac":
        pcm = music(rate, seconds, seed, ch)
        return flac_bytes(pcm, rate), pcm
    if kind == "opus_celt":
        from soundkit_tpu.codecs.encoders import OpusEncoder

        pcm = music(rate, seconds, seed, ch)
        enc = OpusEncoder(rate, ch, 96000)
        pkts = enc.encode_i16_packets(pcm.reshape(-1)) + enc.flush_packets()
        return ogg_opus(pkts, ch), pcm
    if kind in ("opus_silk", "opus_hybrid"):
        from soundkit_tpu.codecs.encoders import OpusEncoder

        x = voice(rate, seconds, seed)
        pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
        bw = "wb" if kind == "opus_silk" else "swb"
        enc = OpusEncoder(rate, 1, 24000 if kind == "opus_silk" else 32000,
                          mode="voice", voice_bandwidth=bw)
        pkts = enc.encode_i16_packets(pcm) + enc.flush_packets()
        return ogg_opus(pkts, 1), pcm[:, None]
    x = voice(rate, seconds, seed)
    pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
    if kind.startswith("g711"):
        from soundkit_tpu.codecs.g711 import G711Encoder

        enc = (G711Encoder.new_alaw() if kind.endswith("alaw")
               else G711Encoder.new_mulaw())
        return enc.encode_i16(pcm), pcm[:, None]
    if kind == "g722":
        from soundkit_tpu.codecs.g722 import G722Encoder

        enc = G722Encoder.new_64k()
        return enc.encode_i16(pcm) + enc.flush(), pcm[:, None]
    from soundkit_tpu.codecs.g726 import G726Encoder, G726Packing, G726Rate

    rate_enum = {"16": G726Rate.RATE_16000, "24": G726Rate.RATE_24000,
                 "32": G726Rate.RATE_32000, "40": G726Rate.RATE_40000}
    enc = G726Encoder(rate_enum[kind.split("_")[1]], G726Packing.LEFT)
    return enc.encode_i16(pcm) + enc.flush(), pcm[:, None]


# -- parsing (rate, channels, duration) ------------------------------------

_MP3_BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                 256, 320)
_MP3_RATES = (44100, 48000, 32000)


def mp3_frames(data: bytes) -> List[Tuple[int, int]]:
    """(offset, length) of each MPEG-1 Layer III frame."""
    frames = []
    pos = 0
    while pos + 4 <= len(data):
        h = struct.unpack_from(">I", data, pos)[0]
        if (h >> 21) != 0x7FF or ((h >> 19) & 3) != 3 or ((h >> 17) & 3) != 1:
            raise ValueError(f"no MPEG-1 Layer III frame at byte {pos}")
        br = _MP3_BITRATES[(h >> 12) & 15] * 1000
        rate = _MP3_RATES[(h >> 10) & 3]
        n = 144 * br // rate + ((h >> 9) & 1)
        frames.append((pos, n))
        pos += n
    return frames


def adts_frames(data: bytes) -> List[bytes]:
    """Whole ADTS frames (header included), split by their length
    fields."""
    frames = []
    pos = 0
    while pos + 7 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
            raise ValueError(f"no ADTS sync at byte {pos}")
        n = ((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3) \
            | (data[pos + 5] >> 5)
        frames.append(data[pos:pos + n])
        pos += n
    return frames


def ogg_pages(data: bytes) -> List[bytes]:
    """Whole Ogg pages, split by their segment tables."""
    pages = []
    pos = 0
    while pos + 27 <= len(data):
        nseg = data[pos + 26]
        n = 27 + nseg + sum(data[pos + 27:pos + 27 + nseg])
        pages.append(data[pos:pos + n])
        pos += n
    return pages


def clip(name: str, data: bytes, seconds: float) -> bytes:
    """The first ``seconds`` of a committed stream, cut at a frame
    (AAC, MP3) or page (Ogg) boundary."""
    codec, rate = COMMITTED[name][:2]
    if codec == "aac":
        return b"".join(adts_frames(data)[: int(seconds * rate / 1024)])
    if codec == "mp3":
        keep = mp3_frames(data)[: int(seconds * rate / 1152)]
        return data[: keep[-1][0] + keep[-1][1]]
    pages = ogg_pages(data)
    out = pages[:2]
    for page in pages[2:]:
        out.append(page)
        if struct.unpack_from("<q", page, 6)[0] >= seconds * rate:
            break
    return b"".join(out)


def parse_info(name: str, data: bytes) -> Dict[str, float]:
    """Rate, channels and duration of a committed stream, read from
    its own framing (ADTS headers, MPEG frame headers, Ogg granules)."""
    codec = COMMITTED[name][0]
    if codec == "aac":
        from soundkit_tpu.codecs.aac_lc import SAMPLE_RATES, AdtsStream

        st = AdtsStream()
        aus = st.push(data)
        rate = SAMPLE_RATES[st.sr_index]
        return {"rate": rate, "channels": data[3] >> 6 | (data[2] & 1) << 2,
                "duration": len(aus) * 1024 / rate}
    if codec == "mp3":
        frames = mp3_frames(data)
        h = struct.unpack_from(">I", data, 0)[0]
        rate = _MP3_RATES[(h >> 10) & 3]
        return {"rate": rate, "channels": 1 if ((h >> 6) & 3) == 3 else 2,
                "duration": len(frames) * 1152 / rate}
    from soundkit_tpu.demux.ogg import OggPacketizer

    pkts = OggPacketizer().push(data)
    ident = pkts[0][0]
    rate = struct.unpack_from("<I", ident, 12)[0]
    return {"rate": rate, "channels": ident[11],
            "duration": pkts[-1][1] / rate}


def manifest() -> Dict[str, dict]:
    return json.loads(MANIFEST.read_text())


def load(name: str) -> bytes:
    """A committed stream's bytes, checked against the manifest."""
    data = (CORPUS_DIR / name).read_bytes()
    want = manifest()[name]["sha256"]
    if hashlib.sha256(data).hexdigest() != want:
        raise ValueError(f"corpus/{name} does not match MANIFEST.json")
    return data


def main() -> None:
    entries = {}
    for name in COMMITTED:
        data = encode_committed(name)
        (CORPUS_DIR / name).write_bytes(data)
        entries[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                         "bytes": len(data), **parse_info(name, data)}
        print(name, entries[name])
    MANIFEST.write_text(json.dumps(entries, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(CORPUS_DIR.parent))
    main()
