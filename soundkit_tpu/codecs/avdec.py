"""Generic libavcodec-backed streaming decoder (host path).

The framework-owned equivalents of the reference's C-wrapper crates
(soundkit-aac/-gsm/-amr/-g729/-ac3/...) build on this one class; each
codec module configures codec name, framing, and output conversion.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from soundkit_tpu.native.loader import load_av


class AvDecodeError(ValueError):
    pass


class AvDecoder:
    def __init__(
        self,
        codec_name: str,
        sample_rate: int = 0,
        channels: int = 0,
        extradata: Optional[bytes] = None,
        use_parser: bool = False,
    ):
        self._lib = load_av()
        ed = bytes(extradata) if extradata else None
        self._h = self._lib.skt_av_open(
            codec_name.encode(),
            sample_rate,
            channels,
            ed,
            len(ed) if ed else 0,
            1 if use_parser else 0,
        )
        if not self._h:
            raise AvDecodeError(f"failed to open decoder {codec_name!r}")
        self.codec_name = codec_name
        self.rate = 0
        self.channels = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_av_close(self._h)
            self._h = None

    def push(self, data: bytes) -> np.ndarray:
        """Feed bytes (b'' = EOF/flush); returns newly decoded
        interleaved f32 samples (possibly empty)."""
        rc = self._lib.skt_av_push(self._h, bytes(data), len(data))
        if rc != 0:
            raise AvDecodeError(self._lib.skt_av_err(self._h).decode() or "decode error")
        return self._drain()

    def flush(self) -> np.ndarray:
        return self.push(b"")

    def _drain(self) -> np.ndarray:
        cap = 1 << 18
        buf = (ctypes.c_float * cap)()
        rate = ctypes.c_int()
        ch = ctypes.c_int()
        parts = []
        while True:
            n = self._lib.skt_av_pull_f32(self._h, buf, cap, rate, ch)
            if n == 0:
                break
            parts.append(np.frombuffer(buf, dtype=np.float32, count=n).copy())
        if rate.value:
            self.rate = rate.value
            self.channels = ch.value
        if not parts:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(parts)


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    """round(x * 32768) with clamp.

    The shim normalizes integer-native decoder output (ALAC, GSM, ...)
    as s/32768; multiplying by 32768 and rounding recovers the exact
    integers, keeping lossless paths bit-exact.  (The pipeline's
    options stage uses the reference's *32767-truncate separately.)
    """
    scaled = np.rint(np.asarray(x, np.float64) * 32768.0)
    return np.clip(scaled, -32768, 32767).astype(np.int16)
