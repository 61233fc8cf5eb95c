"""G.711 mu-law / A-law codec.

API equivalent of ``soundkit-g711/src/lib.rs``: stateless per-sample
companding with ``G711Law``, streaming ``G711Encoder``/``G711Decoder``
(caller supplies rate/channels, :69-233), and ``encode_sample`` /
``decode_sample`` scalar helpers (:22-34).

The inner loop is ``soundkit_tpu.ops.companding`` — branch-free vector
arithmetic that runs on host (numpy) for the streaming API and on the
accelerator (jax) for the batched path (``G711BatchDecoder``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from soundkit_tpu.ops import companding as comp


class G711Law(enum.Enum):
    MU_LAW = "mulaw"
    A_LAW = "alaw"


def encode_sample(law: G711Law, sample: int) -> int:
    fn = comp.encode_mulaw_np if law is G711Law.MU_LAW else comp.encode_alaw_np
    return int(fn(np.array([sample], dtype=np.int16))[0])


def decode_sample(law: G711Law, code: int) -> int:
    fn = comp.decode_mulaw_np if law is G711Law.MU_LAW else comp.decode_alaw_np
    return int(fn(np.array([code], dtype=np.uint8))[0])


def encode_i16(law: G711Law, samples: np.ndarray) -> np.ndarray:
    fn = comp.encode_mulaw_np if law is G711Law.MU_LAW else comp.encode_alaw_np
    return fn(np.asarray(samples, dtype=np.int16))


def decode_i16(law: G711Law, codes) -> np.ndarray:
    fn = comp.decode_mulaw_np if law is G711Law.MU_LAW else comp.decode_alaw_np
    return fn(np.frombuffer(bytes(codes), dtype=np.uint8) if isinstance(codes, (bytes, bytearray, memoryview)) else codes)


@dataclass
class G711Decoder:
    """Streaming decoder (stateless); mirrors lib.rs:146-233."""

    law: G711Law = G711Law.MU_LAW
    sample_rate: int = 8000
    channels: int = 1

    @classmethod
    def new_mulaw(cls, sample_rate: int = 8000, channels: int = 1) -> "G711Decoder":
        return cls(G711Law.MU_LAW, sample_rate, channels)

    @classmethod
    def new_alaw(cls, sample_rate: int = 8000, channels: int = 1) -> "G711Decoder":
        return cls(G711Law.A_LAW, sample_rate, channels)

    def decode_i16(self, data) -> np.ndarray:
        return decode_i16(self.law, data)

    def decode_i32(self, data) -> np.ndarray:
        # i32 output is the i16 value shifted into the high 16 bits (lib.rs:207)
        return decode_i16(self.law, data).astype(np.int32) << 16

    def decode_f32(self, data) -> np.ndarray:
        # f32 output divides by 32768 (lib.rs:228)
        return (decode_i16(self.law, data).astype(np.float32) / np.float32(32768.0)).astype(
            np.float32
        )


@dataclass
class G711Encoder:
    law: G711Law = G711Law.MU_LAW
    sample_rate: int = 8000
    channels: int = 1

    @classmethod
    def new_mulaw(cls, sample_rate: int = 8000, channels: int = 1) -> "G711Encoder":
        return cls(G711Law.MU_LAW, sample_rate, channels)

    @classmethod
    def new_alaw(cls, sample_rate: int = 8000, channels: int = 1) -> "G711Encoder":
        return cls(G711Law.A_LAW, sample_rate, channels)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        return encode_i16(self.law, samples).tobytes()

    def encode_i32(self, samples: np.ndarray) -> bytes:
        # i32 input uses the high 16 bits (lib.rs:134)
        s = (np.asarray(samples, dtype=np.int32) >> 16).astype(np.int16)
        return encode_i16(self.law, s).tobytes()
