"""AAC decoder (host path): ADTS streams and raw access units.

API equivalent of the reference's FDK-backed ``AacDecoder``
(soundkit-aac/src/lib.rs:103-259, ADTS transport).  The ADTS happy
path is OWNED end to end: the spec parser + numpy synthesis from the
AAC-LC family (codecs/aac_lc.py, ops/aac_dsp.py — the same math the
batched device model runs), ~6x realtime per stream on the host, no jit
warm-up inside the pipeline's responsiveness contract.

libavcodec remains the escape hatch for the shapes the owned LC path
does not serve — HE-AAC (an SBR fill extension, detected on ANY
access unit), >2 channels, PCE program configs — the FDK role SURVEY
§2.3 assigns to the generic ``soundkit-aac`` wrapper.  A pre-commit
reroute replays the stream's bytes; a mid-stream sighting continues
on a raw-AU decoder so owned samples are never re-emitted.  The
raw-AU (M4A) path stays on libavcodec: esds configs routinely signal
HE/PS profiles the LC decoder must not serve.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.avdec import AvDecoder, f32_to_i16
from soundkit_tpu.core.audio_types import AudioData, EncodingFlag, Endianness


class AacDecoder:
    """Streaming ADTS decoder (owned AAC-LC happy path)."""

    def __init__(self) -> None:
        self._av: Optional[AvDecoder] = None
        self._av_raw: Optional[AvDecoder] = None
        self._adts = None          # AdtsStream (owned framing)
        self._dec = None           # python AacLcDecoder
        self._synth = None         # AacLcSynth
        self._raw = bytearray()    # replay bytes until committed
        self._committed = False
        self._rate: Optional[int] = None
        self._chans: Optional[int] = None
        try:
            from soundkit_tpu.codecs.aac_lc import AdtsStream

            self._adts = AdtsStream()
        except Exception:
            self._fallback(b"")

    @property
    def sample_rate(self) -> Optional[int]:
        if self._av is not None:
            return self._av.rate or None
        return self._rate

    @property
    def channels(self) -> Optional[int]:
        if self._av is not None:
            return self._av.channels or None
        return self._chans

    def _fallback(self, pending: bytes) -> np.ndarray:
        """Switch to libavcodec, replaying every byte seen so far
        (pre-commit reroute: nothing was emitted from the owned path)."""
        self._av = AvDecoder("aac", use_parser=True)
        self._adts = None
        self._dec = None
        self._synth = None
        raw = bytes(self._raw) + pending
        self._raw = bytearray()
        return self._av.push(raw)

    def _fallback_raw_au(self) -> None:
        """Mid-stream owned failure (corrupt AU or late SBR sighting):
        continue on a raw-AU libavcodec decoder (ASC built from the
        ADTS config) so already-emitted owned samples are never
        replayed."""
        st = self._adts
        asc = bytes([(2 << 3) | (st.sr_index >> 1),
                     ((st.sr_index & 1) << 7)
                     | (st.channel_config << 3)])
        self._av_raw = AvDecoder("aac", extradata=asc)
        self._dec = None
        self._synth = None

    def _prime(self, first_au: bytes) -> bool:
        """First-AU gate: LC only, <=2 channels, no SBR extension."""
        from soundkit_tpu.codecs.aac_lc import (SAMPLE_RATES,
                                                AacLcDecoder)
        from soundkit_tpu.ops.aac_dsp import AacLcSynth

        st = self._adts
        if st.sr_index is None or st.channel_config not in (1, 2):
            return False
        try:
            dec = AacLcDecoder(st.sr_index)
            dec.decode_au(first_au)
            if dec.sbr_seen:
                return False
        except Exception:
            return False
        self._dec = AacLcDecoder(st.sr_index)
        self._synth = AacLcSynth(st.sr_index)
        self._rate = SAMPLE_RATES[st.sr_index]
        self._chans = st.channel_config
        return True

    def decode_f32(self, data: bytes) -> np.ndarray:
        if self._av is not None:
            return self._av.push(data)
        if not self._committed:
            self._raw.extend(data)
        try:
            aus = self._adts.push(data)
        except Exception:
            if self._committed:
                self._fallback_raw_au()
                return np.zeros(0, dtype=np.float32)
            return self._fallback(b"")
        if not aus:
            return np.zeros(0, dtype=np.float32)
        if self._dec is None and self._av_raw is None:
            if not self._prime(aus[0]):
                return self._fallback(b"")
        outs = []
        for au in aus:
            if self._av_raw is not None:
                outs.append(self._av_raw.push(au))
                continue
            try:
                frame = self._dec.decode_au(au)
                if self._dec.sbr_seen:
                    raise ValueError("HE-AAC SBR extension")
                pcm = self._synth.process_frame(frame)
                if pcm.shape[0] != self._chans:
                    raise ValueError("channel layout change")
                outs.append(pcm.T.reshape(-1).astype(np.float32))
            except Exception:
                if not self._committed:
                    return np.concatenate(
                        [np.concatenate(outs) if outs
                         else np.zeros(0, np.float32),
                         self._fallback(b"")])
                self._fallback_raw_au()
                outs.append(self._av_raw.push(au))
        self._committed = True
        self._raw = bytearray()
        return (np.concatenate(outs).astype(np.float32) if outs
                else np.zeros(0, dtype=np.float32))

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush_f32(self) -> np.ndarray:
        if self._av is not None:
            return self._av.flush()
        if self._av_raw is not None:
            return self._av_raw.flush()
        return np.zeros(0, dtype=np.float32)


class AacRawDecoder:
    """Raw access-unit decoder configured from an AudioSpecificConfig
    (the M4A path: extradata from the MP4 esds box)."""

    def __init__(self, audio_specific_config: bytes) -> None:
        self._av = AvDecoder("aac", extradata=audio_specific_config)

    @property
    def sample_rate(self) -> Optional[int]:
        return self._av.rate or None

    @property
    def channels(self) -> Optional[int]:
        return self._av.channels or None

    def decode_access_unit_f32(self, au: bytes) -> np.ndarray:
        return self._av.push(au)

    def flush_f32(self) -> np.ndarray:
        return self._av.flush()


class AacAdtsAdapter:
    """StreamingDecoder for the pipeline (ADTS autodetect path)."""

    def __init__(self) -> None:
        self._dec = AacDecoder()

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


class AacLatmAdapter:
    """StreamingDecoder for LOAS/LATM AAC elementary streams.

    Beyond reference parity (which only passes LATM packets through,
    soundkit-audio-demux/src/lib.rs:2249): demuxes the LOAS sync layer
    to raw access units (demux/latm.py) and decodes them with a
    raw-AU decoder configured from the in-band StreamMuxConfig's
    AudioSpecificConfig.
    """

    def __init__(self) -> None:
        from soundkit_tpu.demux.latm import LoasDemuxer

        self._loas = LoasDemuxer()
        self._dec: Optional[AacRawDecoder] = None

    def _emit(self, pcm: np.ndarray) -> List[AudioData]:
        if pcm is None or pcm.size == 0 or not self._dec or not self._dec.sample_rate:
            return []
        pcm16 = f32_to_i16(pcm)
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
        out: List[AudioData] = []
        for au in self._loas.push(chunk):
            if self._dec is None:
                self._dec = AacRawDecoder(self._loas.config.asc.to_bytes())
            out.extend(self._emit(self._dec.decode_access_unit_f32(au)))
        return out

    def flush(self) -> List[AudioData]:
        if self._dec is None:
            return []
        return self._emit(self._dec._av.flush())
