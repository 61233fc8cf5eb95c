"""PGO training for the table-pushed parsers (CELT/SILK/hybrid).

The pgo_train.cpp binary covers the parsers that run self-contained on
fixtures (AAC/FLAC/MP3/GSM/ALAC); the Opus-side walks need their spec
tables pushed from Python, so the Makefile runs THIS script against the
-fprofile-generate instrumented library (``SKT_LIB_OVERRIDE`` points
the loader at it, skipping the lazy rebuild) to collect branch counts
for celt_parse.cpp / silk_parse.cpp / hybrid_glue.cpp — the mixed
fleet's dominant host stage.

Training content: libopus-encoded packets of a deterministic
music+voice signal in all three modes (CELT music, SILK-WB voice,
hybrid), walked through the same batched entries the serving models
use.  Runs CPU-only; no JAX device work is needed for the walks.

Usage: SKT_LIB_OVERRIDE=<instrumented.so> python pgo_train_walks.py
"""
from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import numpy as np


def _opus_packets(app_bitrate_pairs, seconds=2.0):
    op = ctypes.CDLL("libopus.so.0")
    op.opus_encoder_create.restype = ctypes.c_void_p
    op.opus_encoder_create.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    op.opus_encode_float.restype = ctypes.c_int
    op.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    rng = np.random.default_rng(5)
    n = int(48000 * seconds)
    t = np.arange(n) / 48000.0
    sig = (0.4 * np.sin(2 * np.pi * 220 * t)
           * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.15 * np.sin(2 * np.pi * 9000 * t)
           + 0.02 * rng.standard_normal(n)).astype(np.float32)
    out = []
    for app, br, *ctls in app_bitrate_pairs:
        err = ctypes.c_int(0)
        enc = ctypes.c_void_p(op.opus_encoder_create(
            48000, 1, app, ctypes.byref(err)))
        op.opus_encoder_ctl(enc, 4002, br)  # SET_BITRATE
        for req, v in ctls:
            op.opus_encoder_ctl(enc, req, v)
        pkts = []
        for i in range(0, n - 960, 960):
            buf = ctypes.create_string_buffer(4000)
            r = op.opus_encode_float(
                enc, np.ascontiguousarray(sig[i:i + 960, None]).ctypes
                .data_as(ctypes.POINTER(ctypes.c_float)), 960, buf,
                4000)
            if r > 0:
                pkts.append(buf.raw[:r])
        out.append(pkts)
    return out


def main() -> int:
    assert os.environ.get("SKT_LIB_OVERRIDE"), "needs SKT_LIB_OVERRIDE"
    from soundkit_tpu.codecs.opus_core import parse_packet

    import jax

    jax.config.update("jax_platforms", "cpu")

    from soundkit_tpu.models.opus_batch import (
        BatchedCeltDecoder,
        BatchedHybridDecoder,
        BatchedSilkDecoder,
    )

    # 4004 = SET_MAX_BANDWIDTH, 1103 = WIDEBAND → pure SILK-WB voice
    music, voice, hyb32 = _opus_packets(
        [(2049, 96000), (2048, 16000, (4004, 1103)), (2048, 32000)])
    by_mode = {"celt": [], "silk": [], "hybrid": []}
    for p in music + voice + hyb32:
        by_mode[parse_packet(p)[0].mode].append(p)

    B = 16
    for mode, cls in (("celt", BatchedCeltDecoder),
                      ("silk", BatchedSilkDecoder),
                      ("hybrid", BatchedHybridDecoder)):
        pkts = by_mode[mode][:48]
        if not pkts:
            print(f"pgo_train_walks: no {mode} packets", file=sys.stderr)
            continue
        dec = cls(B, channels=1)
        for b in range(B):
            for pkt in pkts:
                if mode == "celt":
                    dec.push_packet(b, pkt)  # full packet (TOC kept)
                else:
                    toc, frames = parse_packet(pkt)
                    dec.push_packet(b, frames[0], toc.bandwidth,
                                    2 if toc.stereo else 1)
        dec.decode_ready()
    print("pgo_train_walks: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
