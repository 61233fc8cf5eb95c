"""G.726 ADPCM codec (16/24/32/40 kbit/s).

API equivalent of ``soundkit-g726/src/lib.rs``: ``G726Rate``
(:71-171), ``G726Packing`` Left/Right bit packing (:173-179, ffmpeg
``g726``/``g726le``), streaming ``G726Encoder``/``G726Decoder`` with
group-granular buffering (:556-912).

The predictor core is ``soundkit_tpu.ops.adpcm`` — a batched scan that
runs identically on CPU (host streaming path, B=1) and on the
accelerator (the 1024-stream batched path).  Code packing/unpacking
is vectorized numpy bit manipulation on the host.
"""
from __future__ import annotations

import enum
import functools
from typing import Optional

import numpy as np

from soundkit_tpu.ops import adpcm

G726_SAMPLE_RATE = 8000
G726_CHANNELS = 1


class G726Rate(enum.Enum):
    RATE_16000 = 2  # bits per code
    RATE_24000 = 3
    RATE_32000 = 4
    RATE_40000 = 5

    @classmethod
    def from_bitrate(cls, bit_rate: int) -> "G726Rate":
        return {
            16000: cls.RATE_16000,
            24000: cls.RATE_24000,
            40000: cls.RATE_40000,
        }.get(bit_rate, cls.RATE_32000)

    @property
    def bits_per_sample(self) -> int:
        return self.value

    @property
    def bit_rate(self) -> int:
        return {2: 16000, 3: 24000, 4: 32000, 5: 40000}[self.value]

    @property
    def samples_per_byte_group(self) -> int:
        return {2: 4, 3: 8, 4: 2, 5: 8}[self.value]

    @property
    def bytes_per_group(self) -> int:
        return {2: 1, 3: 3, 4: 1, 5: 5}[self.value]


class G726Packing(enum.Enum):
    LEFT = "left"  # ffmpeg -f g726 (MSB-first)
    RIGHT = "right"  # ffmpeg -f g726le (LSB-first)


def unpack_codes(data: bytes, bits: int, packing: G726Packing) -> np.ndarray:
    """Packed bytes -> u8 codes (lib.rs:530-554), whole groups only."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n_codes = (len(arr) * 8) // bits
    if packing is G726Packing.LEFT:
        bits_arr = np.unpackbits(arr)[: n_codes * bits].reshape(n_codes, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    else:
        bits_arr = np.unpackbits(arr, bitorder="little")[: n_codes * bits].reshape(
            n_codes, bits
        )
        weights = (1 << np.arange(bits)).astype(np.uint16)
    return (bits_arr.astype(np.uint16) @ weights).astype(np.uint8)


def pack_codes(codes: np.ndarray, bits: int, packing: G726Packing) -> bytes:
    """u8 codes -> packed bytes (lib.rs:501-528); len(codes)*bits must be /8."""
    codes = np.asarray(codes, dtype=np.uint8)
    if packing is G726Packing.LEFT:
        shifts = np.arange(bits - 1, -1, -1)
        bits_arr = ((codes[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
        return np.packbits(bits_arr).tobytes()
    shifts = np.arange(bits)
    bits_arr = ((codes[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits_arr, bitorder="little").tobytes()


@functools.lru_cache(maxsize=8)
def _jit_decode(bits: int):
    from soundkit_tpu.utils.backend import host_jit

    def fn(codes, valid, state):
        return adpcm.g726_decode_scan(codes, state, bits, valid)

    return host_jit(fn)


@functools.lru_cache(maxsize=8)
def _jit_encode(bits: int):
    from soundkit_tpu.utils.backend import host_jit

    def fn(samples, valid, state):
        return adpcm.g726_encode_scan(samples, state, bits, valid)

    return host_jit(fn)


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class G726Decoder:
    """Streaming decoder; buffers to whole byte groups (lib.rs:743-912)."""

    def __init__(
        self,
        rate: G726Rate = G726Rate.RATE_32000,
        packing: G726Packing = G726Packing.LEFT,
    ):
        self.rate = rate
        self.packing = packing
        self._pending = bytearray()
        self._state = adpcm.g726_init_state(1)

    sample_rate = property(lambda self: G726_SAMPLE_RATE)
    channels = property(lambda self: G726_CHANNELS)

    def decode_i16(self, data: bytes) -> np.ndarray:
        self._pending.extend(data)
        group = self.rate.bytes_per_group
        complete = (len(self._pending) // group) * group
        if complete == 0:
            return np.zeros(0, dtype=np.int16)
        chunk = bytes(self._pending[:complete])
        del self._pending[:complete]

        codes = unpack_codes(chunk, self.rate.bits_per_sample, self.packing)
        n = len(codes)
        padded = _bucket(n)
        codes_p = np.zeros((1, padded), dtype=np.uint8)
        codes_p[0, :n] = codes
        valid = np.zeros((1, padded), dtype=bool)
        valid[0, :n] = True

        pcm, self._state = _jit_decode(self.rate.bits_per_sample)(
            codes_p, valid, self._state
        )
        return np.asarray(pcm)[0, :n].astype(np.int16)

    def decode_i32(self, data: bytes) -> np.ndarray:
        return self.decode_i16(data).astype(np.int32) << 16

    def decode_f32(self, data: bytes) -> np.ndarray:
        return (self.decode_i16(data).astype(np.float32) / np.float32(32768.0)).astype(
            np.float32
        )

    def flush(self) -> None:
        if self._pending:
            raise ValueError(
                f"G.726 stream ended with {len(self._pending)} trailing partial-packet byte(s)"
            )

    def reset(self) -> None:
        self._pending.clear()
        self._state = adpcm.g726_init_state(1)


class G726Encoder:
    """Streaming encoder; buffers to whole sample groups (lib.rs:556-741)."""

    def __init__(
        self,
        rate: G726Rate = G726Rate.RATE_32000,
        packing: G726Packing = G726Packing.LEFT,
    ):
        self.rate = rate
        self.packing = packing
        self._pending: np.ndarray = np.zeros(0, dtype=np.int16)
        self._state = adpcm.g726_init_state(1)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        samples = np.concatenate([self._pending, np.asarray(samples, dtype=np.int16)])
        group = self.rate.samples_per_byte_group
        complete = (len(samples) // group) * group
        self._pending = samples[complete:]
        if complete == 0:
            return b""
        return self._encode_exact(samples[:complete])

    def encode_i32(self, samples: np.ndarray) -> bytes:
        return self.encode_i16((np.asarray(samples, dtype=np.int32) >> 16).astype(np.int16))

    def flush(self) -> bytes:
        """Zero-pad the trailing partial group and encode it (lib.rs:607-625)."""
        if len(self._pending) == 0:
            return b""
        group = self.rate.samples_per_byte_group
        padded = np.zeros(group, dtype=np.int16)
        padded[: len(self._pending)] = self._pending
        self._pending = np.zeros(0, dtype=np.int16)
        return self._encode_exact(padded)

    def _encode_exact(self, samples: np.ndarray) -> bytes:
        n = len(samples)
        padded = _bucket(n)
        s_p = np.zeros((1, padded), dtype=np.int16)
        s_p[0, :n] = samples
        valid = np.zeros((1, padded), dtype=bool)
        valid[0, :n] = True
        codes, self._state = _jit_encode(self.rate.bits_per_sample)(
            s_p, valid, self._state
        )
        return pack_codes(
            np.asarray(codes)[0, :n], self.rate.bits_per_sample, self.packing
        )

    def reset(self) -> None:
        self._pending = np.zeros(0, dtype=np.int16)
        self._state = adpcm.g726_init_state(1)
