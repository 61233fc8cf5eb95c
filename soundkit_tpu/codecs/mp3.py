"""MP3 decoder (host path).

API equivalent of the reference's ``Mp3Decoder``
(soundkit-mp3/src/lib.rs:147-260, a nanomp3/minimp3 wrapper): streaming
byte input with internal frame sync (bit reservoir handled), f32-native
decode, per-frame rate/channel capture, i16 output for the pipeline
(decode_i16_with_drain arm, soundkit-decoder/src/lib.rs:375-387).

The happy path is OWNED end to end, mirroring the reference's pure-Rust
nanomp3 role: the C++ syntax parser (``NativeMp3Parser``,
native/src/mp3_parse.cpp — bit reservoir, scalefactors, Huffman,
short-block reorder) feeds compact granule lanes to the same jitted
synthesis step the batched device model runs (``ops.mp3_batch``
requant + stereo + antialias + IMDCT + polyphase), pinned to the
in-process CPU backend at B=1 (utils/backend.py host_jit).  114-126 dB
vs the libavcodec oracle on the fixture corpus (tests/test_mp3_native).

libavcodec remains the escape hatch only: native lib unavailable, jax
CPU backend unavailable, or the stream turns out to be MPEG Layer I/II
(the owned parser is Layer III only, like nanomp3's mp3 focus).
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.avdec import AvDecoder, f32_to_i16
from soundkit_tpu.core.audio_types import AudioData, EncodingFlag, Endianness

# how many bytes to scan for a non-Layer-III sync before committing to
# the owned parser (ID3v2 tags can front-load ~100 KB of junk)
_SNIFF_LIMIT = 256 * 1024


@functools.lru_cache(maxsize=1)
def _owned_step():
    from soundkit_tpu.ops import mp3_batch as mb
    from soundkit_tpu.utils.backend import host_jit

    return host_jit(mb.mp3_granule_device_compact)


def _sniff_layer(buf: bytes) -> Optional[int]:
    """First plausible MPEG audio header's layer (1/2/3), else None."""
    for i in range(len(buf) - 3):
        if buf[i] != 0xFF or (buf[i + 1] & 0xE0) != 0xE0:
            continue
        version = (buf[i + 1] >> 3) & 3
        layer_bits = (buf[i + 1] >> 1) & 3
        bitrate_idx = (buf[i + 2] >> 4) & 0xF
        sr_idx = (buf[i + 2] >> 2) & 3
        if version == 1 or layer_bits == 0:
            continue
        if bitrate_idx in (0, 15) or sr_idx == 3:
            continue
        return {1: 3, 2: 2, 3: 1}[layer_bits]  # bits -> layer number
    return None


class Mp3Decoder:
    def __init__(self, backend: str = "owned") -> None:
        self._av: Optional[AvDecoder] = None
        self._parser = None
        self._rate = 0
        self._channels = 0
        self._state = None  # (overlap [1,2,32,18], fifo [1,2,1024])
        self._sniff = b""  # bytes kept until the owned path commits
        if backend != "owned" or os.environ.get("SKT_MP3_AV"):
            self._use_av()
            return
        try:
            from soundkit_tpu.codecs.mp3_native import NativeMp3Parser

            self._parser = NativeMp3Parser()
        except Exception:
            self._use_av()

    def _use_av(self, replay: bytes = b"") -> np.ndarray:
        self._parser = None
        self._sniff = b""
        self._av = AvDecoder("mp3float", use_parser=True)
        return self._av.push(replay) if replay else np.zeros(0, np.float32)

    @property
    def sample_rate(self) -> Optional[int]:
        if self._av is not None:
            return self._av.rate or None
        return self._rate or None

    @property
    def channels(self) -> Optional[int]:
        if self._av is not None:
            return self._av.channels or None
        return self._channels or None

    def _synth_granule(self, quant, expq, meta) -> np.ndarray:
        """One compact granule lane -> interleaved f32 samples."""
        from soundkit_tpu.ops import mp3_batch as mb

        if self._state is None:
            self._state = mb.init_state(1, 2)
        nch = int(meta["nch"])
        bt = np.asarray([meta["block_type"]], dtype=np.int32)
        mixed = np.asarray([meta["mixed"]], dtype=np.uint8)
        nal = np.asarray([meta["n_alias"]], dtype=np.int32)
        ms = np.asarray([meta["ms"]], dtype=np.uint8)
        valid = np.asarray([[1, 1 if nch == 2 else 0]], dtype=np.uint8)
        pcm, ov, ff = _owned_step()(
            quant[None], expq[None], ms, bt, mixed, nal, valid,
            self._state[0], self._state[1],
        )
        self._state = (ov, ff)
        self._rate = int(meta["sample_rate"])
        self._channels = nch
        out = np.asarray(pcm)[0, :nch]  # [nch, 576]
        if nch == 1:
            return out[0]
        return out.T.reshape(-1)

    def decode_f32(self, data: bytes) -> np.ndarray:
        """Interleaved f32 (nanomp3-native output)."""
        if self._av is not None:
            return self._av.push(data)
        # layer sniff: the owned parser is Layer III only; reroute
        # Layer I/II streams (with full replay) before any output
        if self._sniff is not None:
            self._sniff += bytes(data)
            layer = _sniff_layer(self._sniff)
            if layer is not None and layer != 3:
                return self._use_av(self._sniff)
            if layer is None and len(self._sniff) < _SNIFF_LIMIT:
                # no header yet (ID3 prefix): keep buffering for replay
                pass
        self._parser.push(data)
        outs: List[np.ndarray] = []
        while True:
            pop = self._parser.pop()
            if pop is None:
                break
            self._sniff = None  # committed: granules are flowing
            quant, expq, meta = pop
            outs.append(self._synth_granule(quant, expq, meta))
        if not outs:
            return np.zeros(0, np.float32)
        return np.concatenate(outs).astype(np.float32)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush_f32(self) -> np.ndarray:
        if self._av is not None:
            return self._av.flush()
        # the owned parser emits every completed granule eagerly; a
        # trailing partial frame has nothing decodable left
        return np.zeros(0, np.float32)


class Mp3Adapter:
    """StreamingDecoder for the pipeline (emits i16 AudioData)."""

    def __init__(self) -> None:
        self._dec = Mp3Decoder()

    def _emit(self, pcm16: np.ndarray) -> List[AudioData]:
        if len(pcm16) == 0 or not self._dec.sample_rate:
            return []
        return [
            AudioData(
                bits_per_sample=16,
                channel_count=self._dec.channels,
                sampling_rate=self._dec.sample_rate,
                data=pcm16.astype("<i2").tobytes(),
                audio_format=EncodingFlag.PCM_SIGNED,
                endianness=Endianness.LITTLE,
            )
        ]

    def process(self, chunk: bytes) -> List[AudioData]:
        return self._emit(self._dec.decode_i16(chunk))

    def flush(self) -> List[AudioData]:
        return self._emit(f32_to_i16(self._dec.flush_f32()))
