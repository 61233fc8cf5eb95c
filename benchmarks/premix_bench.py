"""Premix comparison benchmark — the framework analog of the
reference's ``lori-asha-premix-bench`` crate (main.rs:160-345):
discover audio tracks under root directories by query terms, decode
each through the DecodePipeline to 48 kHz mono i16, then round-trip
every track through Opus encode/decode backends and report per-track
and aggregate encode/decode wall time, bitrate, and quality
(SNR/RMSE/MAE, the crate's QualityMetrics).

Backends compared (the crate's axis is soundkit wrapper vs pure-Rust
libopus-rs vs C libopus; the analog here is the owned encode path vs
the C shim vs the batched serving decoder):
  own - owned CELT encoder -> raw-Opus framing -> OpusStreamDecoder
  lop - libopus shim encoder -> same decode path
  bat - libopus packets -> BatchedOpusDecoder (serving model)

Usage:
  python benchmarks/premix_bench.py [--dir PATH] [--bitrate BPS]
        [--frame-ms MS] [--query TERMS...]
"""
from __future__ import annotations

import argparse
import struct
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

AUDIO_EXTS = {
    ".aac", ".ac3", ".aif", ".aiff", ".alac", ".amr", ".flac", ".gsm",
    ".m4a", ".mp3", ".ogg", ".oga", ".opus", ".raw", ".wav", ".webm",
}
TARGET_RATE = 48_000


@dataclass
class Metrics:
    snr_db: float
    rmse: float
    mae: float


@dataclass
class Result:
    enc_s: float
    dec_s: float
    encoded_bytes: int
    metrics: Metrics
    dlen: int


@dataclass
class Aggregate:
    tracks: int = 0
    enc_s: float = 0.0
    dec_s: float = 0.0
    audio_s: float = 0.0
    snrs: List[float] = field(default_factory=list)

    def add(self, r: Result, duration: float) -> None:
        self.tracks += 1
        self.enc_s += r.enc_s
        self.dec_s += r.dec_s
        self.audio_s += duration
        self.snrs.append(r.metrics.snr_db)


def discover_tracks(roots: List[Path], terms: List[str]) -> List[Path]:
    out = []
    for root in roots:
        if not root.is_dir():
            continue
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() not in AUDIO_EXTS or not p.is_file():
                continue
            name = str(p).lower()
            if terms and not all(t.lower() in name for t in terms):
                continue
            out.append(p)
    return out


def decode_for_benchmark(path: Path) -> Optional[np.ndarray]:
    """File -> 48 kHz mono i16 via the framework's decode pipeline."""
    from soundkit_tpu.core.audio_pipeline import audio_to_f32_channels
    from soundkit_tpu.core.audio_types import AudioData
    from soundkit_tpu.pipeline.decode_pipeline import StreamDecoder

    dec = StreamDecoder()
    data = path.read_bytes()
    outs = dec.process(data) + dec.process(b"")  # empty chunk = EOF
    outs = [o for o in outs if isinstance(o, AudioData)]
    if not outs:
        return None
    chans = []
    rate = outs[0].sampling_rate
    for a in outs:
        chans.append(np.stack(audio_to_f32_channels(a)))
    f32 = np.concatenate(chans, axis=1)
    mono = f32.mean(axis=0)
    if rate != TARGET_RATE:
        from soundkit_tpu.ops.resample import resample_np

        mono = resample_np(mono[None, :], rate, TARGET_RATE)[0]
    return np.clip(mono * 32767.0, -32768, 32767).astype(np.int16)


def _metrics(ref: np.ndarray, test: np.ndarray) -> Metrics:
    n = min(len(ref), len(test))
    if n == 0:
        return Metrics(0.0, 0.0, 0.0)
    r = ref[:n].astype(np.float64)
    t = test[:n].astype(np.float64)
    err = r - t
    p = np.mean(r**2)
    e = np.mean(err**2)
    snr = 10 * np.log10(p / e) if e > 0 else 150.0
    return Metrics(snr, float(np.sqrt(e)), float(np.mean(np.abs(err))))


def _align(ref: np.ndarray, test: np.ndarray, max_off: int = 4096) -> np.ndarray:
    """Trim codec delay: exact cross-correlation peak via FFT."""
    n = min(len(ref), len(test), 2 * TARGET_RATE)
    r = ref[:n].astype(np.float64)
    t = test[:n].astype(np.float64)
    size = 1 << int(np.ceil(np.log2(2 * n)))
    corr = np.fft.irfft(np.fft.rfft(t, size) * np.conj(np.fft.rfft(r, size)), size)
    off = int(np.argmax(corr[: min(max_off, n)]))
    return test[off:]


def run_soundkit_backend(pcm: np.ndarray, frame: int, bitrate: int,
                         enc_backend: str = "owned") -> Result:
    from soundkit_tpu.codecs.encoders import OpusEncoder
    from soundkit_tpu.codecs.opus import OpusStreamDecoder

    t0 = time.perf_counter()
    enc = OpusEncoder(TARGET_RATE, 1, bitrate, backend=enc_backend)
    stream = enc.encode_to_soundkit_stream(pcm)
    t1 = time.perf_counter()
    dec = OpusStreamDecoder()
    out = dec.decode_f32(stream)
    out = np.concatenate([out, dec.flush()])
    t2 = time.perf_counter()
    i16 = np.clip(out * 32768.0, -32768, 32767).astype(np.int16)
    aligned = _align(pcm, i16)
    return Result(t1 - t0, t2 - t1, len(stream), _metrics(pcm, aligned), len(i16))


def run_batched_backend(pcm: np.ndarray, frame: int, bitrate: int) -> Result:
    from soundkit_tpu.codecs.encoders import OpusEncoder
    from soundkit_tpu.models.opus_batch import BatchedOpusDecoder

    t0 = time.perf_counter()
    enc = OpusEncoder(TARGET_RATE, 1, bitrate, backend="libopus")
    pkts = enc.encode_i16_packets(pcm) + enc.flush_packets()
    wire = b"".join(struct.pack("<H", len(p)) + p for p in pkts)
    t1 = time.perf_counter()
    m = BatchedOpusDecoder(1, channels=1)
    m.push(0, wire)
    out, lens = m.decode_ready()
    parts = [out[i, 0, 0, : lens[i, 0]] for i in range(out.shape[0])]
    pcm_out = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    t2 = time.perf_counter()
    i16 = np.clip(pcm_out * 32768.0, -32768, 32767).astype(np.int16)
    aligned = _align(pcm, i16)
    return Result(t1 - t0, t2 - t1, len(wire), _metrics(pcm, aligned), len(i16))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", action="append", default=[], help="track root(s)")
    ap.add_argument("--bitrate", type=int, default=128_000)
    ap.add_argument("--frame-ms", type=int, default=20)
    ap.add_argument("--query", nargs="*", default=[])
    ap.add_argument("--json", default="", help="write aggregates to PATH")
    args = ap.parse_args(argv)

    roots = [Path(d) for d in args.dir] or [Path("/root/reference/testdata")]
    frame = TARGET_RATE * args.frame_ms // 1000
    tracks = discover_tracks(roots, args.query)
    if not tracks:
        print(f"No matching tracks found for {args.query} under {roots}.")
        return 0
    print(f"Found {len(tracks)} candidate tracks")
    # untimed warmup: native library build/load, spec-table pushes and
    # scipy imports otherwise land in the first track's own-backend
    # column and skew the per-backend comparison
    warm = (np.sin(0.05 * np.arange(TARGET_RATE // 4)) * 8000).astype(
        np.int16)
    for backend in ("owned", "libopus"):
        try:
            run_soundkit_backend(warm, frame, args.bitrate, backend)
        except Exception:
            pass
    hdr = (f"{'Track':<58} {'dur':>6} {'own_enc':>7} {'own_snr':>7} {'own_kbps':>8} "
           f"{'lop_enc':>7} {'lop_snr':>7} {'lop_kbps':>8} | {'bat_dec':>7} {'bat_snr':>7}")
    print(hdr)
    agg_own, agg_lop, agg_bat = Aggregate(), Aggregate(), Aggregate()
    for path in tracks:
        try:
            pcm = decode_for_benchmark(path)
        except Exception as e:  # mirror the crate's decode-failed line
            print(f"{str(path):<60} decode-failed: {e}")
            continue
        if pcm is None or len(pcm) < frame:
            print(f"{str(path):<60} decode-failed: empty")
            continue
        dur = len(pcm) / TARGET_RATE
        # three encode backends, the crate's soundkit / libopus-rs / C
        # axis: owned CELT encode, libopus shim encode, and the libopus
        # packets through the batched serving decoder
        own = run_soundkit_backend(pcm, frame, args.bitrate, "owned")
        lop = run_soundkit_backend(pcm, frame, args.bitrate, "libopus")
        bat = run_batched_backend(pcm, frame, args.bitrate)
        okbps = own.encoded_bytes * 8 / dur / 1000
        lkbps = lop.encoded_bytes * 8 / dur / 1000
        print(f"{path.name:<58} {dur:>6.2f} {own.enc_s*1e3:>6.1f}m {own.metrics.snr_db:>7.2f} "
              f"{okbps:>8.1f} {lop.enc_s*1e3:>6.1f}m {lop.metrics.snr_db:>7.2f} "
              f"{lkbps:>8.1f} | {bat.dec_s*1e3:>6.1f}m {bat.metrics.snr_db:>7.2f}")
        agg_own.add(own, dur)
        agg_lop.add(lop, dur)
        agg_bat.add(bat, dur)
    summary = {}
    for name, agg in (("owned-enc", agg_own), ("libopus-enc", agg_lop),
                      ("batched", agg_bat)):
        if agg.tracks:
            print(f"[{name}] tracks={agg.tracks} audio={agg.audio_s:.1f}s "
                  f"enc_x={agg.audio_s/max(agg.enc_s,1e-9):.1f} "
                  f"dec_x={agg.audio_s/max(agg.dec_s,1e-9):.1f} "
                  f"mean_snr={np.mean(agg.snrs):.2f}dB")
            summary[name] = {
                "tracks": agg.tracks,
                "audio_s": round(agg.audio_s, 2),
                "enc_x_realtime": round(agg.audio_s / max(agg.enc_s, 1e-9), 2),
                "dec_x_realtime": round(agg.audio_s / max(agg.dec_s, 1e-9), 2),
                "mean_snr_db": round(float(np.mean(agg.snrs)), 2),
            }
    if args.json and summary:
        import json

        summary["config"] = {
            "bitrate": args.bitrate, "frame_ms": args.frame_ms,
            "note": "owned CELT encode vs libopus shim vs batched "
                    "serving decode over the reference testdata corpus "
                    "(lori-asha-premix-bench BENCHMARK.md analog)",
        }
        Path(args.json).write_text(json.dumps(summary, indent=1) + "\n")
        print("wrote", args.json)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    raise SystemExit(main())
