"""Ogg-Opus fleet group: per-lane Ogg demux + three batched engines.

Extends the serving fleet's batched coverage to Ogg-Opus streams:
each lane demuxes its Ogg pages on the host
(codecs/opus.OggOpusDemuxer), validates every packet's TOC, and is
classified by its first audio packet:

- CELT 20 ms (music) lanes queue into the shared
  ``BatchedCeltDecoder`` (device IMDCT/comb/de-emphasis over all
  lanes per round, C++ range decode/PVQ host stage);
- SILK 20 ms (voice) lanes queue into ``BatchedSilkDeviceDecoder``
  (one C++ skt_silk_parse_many walk per round, LTP/LPC synthesis +
  unmix + 48 kHz resample on device — ops/silk_batch.py);
- hybrid 20 ms lanes queue into ``BatchedHybridDecoder`` (the SILK
  walk's exported coder state seeds the CELT continuation parse;
  both synthesis halves run on device and sum).

All three emit device-resident [rounds, B, C, 960] slots with valid
samples at the END and lane-disjoint zeros elsewhere, so the fleet's
device_out/i16 collect path is a pure add across engines.

Streams no engine serves (multi-frame packets, mid-stream SILK
bandwidth or mode switches, transition-redundancy starts) raise
:class:`OpusLaneUnsupported` out of ``push`` so the fleet reroutes
them to a per-stream host decoder.  Retention is O(1) per lane: the
model keeps only a bounded packet tail (``TAIL_KEEP`` packets beyond
the undecoded queue, ~2 s of warmup — the converge-from-tail design
of codecs/opus.py ``_OpusCore._trim_history``) plus duration/emitted
accounting, and the reroute seeds a single-stream ``_OpusCore`` from
that tail (:class:`_OpusTailFallback`) instead of replaying the
stream's raw bytes from the start.  Decoder state memory is short
(CELT: one frame of overlap + postfilter history; SILK: two frames
of LPC/LTP state), so the tail replay converges to the full-history
decode well inside the retained warmup; already-emitted samples are
dropped by count so interleaved push/collect callers see no
duplicates.

Reference role: soundkit-ogg-opus decode inside the per-stream
pipeline (soundkit-decoder/src/lib.rs spawn paths), re-split so the
synthesis FLOPs batch onto the device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.opus import OggOpusDemuxer
from soundkit_tpu.models.opus_batch import (
    BatchedCeltDecoder,
    BatchedHybridDecoder,
    BatchedSilkDeviceDecoder,
)


class OpusLaneUnsupported(Exception):
    """This stream needs the host pipeline (odd framing / mode
    switches); carries ``replay`` — everything the fleet needs to
    seed a :class:`_OpusTailFallback` (bounded tail, no raw-byte
    retention)."""

    replay: Optional[dict] = None


class _OpusTailFallback:
    """Per-stream host decoder seeded from a lane's bounded packet
    tail (fleet reroute target; codecs/opus.py converge-from-tail).

    Duck-types the ``StreamDecoder.process`` surface the fleet's
    fallback path consumes: ``process(data) -> [AudioData]`` with
    f32 PCM, where ``data`` is the stream's raw Ogg bytes arriving
    after the reroute (the lane's demuxer moves over for byte
    continuity) and ``b""`` drains/flushes.  The first replayed
    packet rebuilds the Python decoder's state from the retained
    tail and drops the ``emitted`` samples the lane already
    delivered, so interleaved push/collect callers see a gapless,
    duplicate-free stream."""

    def __init__(self, demux, head, tail, dropped, emitted, pending):
        from soundkit_tpu.codecs.opus import _OpusCore

        self._demux = demux
        core = _OpusCore(head)
        core._fast = False  # native CELT state can't seed from a tail
        if core._own is not None:
            core._history = list(tail)
            core._dropped = int(dropped)
            core._emitted = int(emitted)
            self._primed = False
        else:
            # multistream head: avcodec delegate, rejected before any
            # packet decoded (nothing emitted, no tail to converge)
            self._primed = True
        self._core = core
        self._queue: List[bytes] = list(pending)

    def process(self, data: bytes):
        from soundkit_tpu.codecs.opus_core import OpusUnsupported
        from soundkit_tpu.core.audio_types import AudioData, EncodingFlag

        pkts = self._queue
        self._queue = []
        if data:
            pkts = pkts + self._demux.push(data)
        outs = []
        for p in pkts:
            if not self._primed:
                self._core._history.append(p)
                self._core._trim_history()
                try:
                    pcm = self._core._replay_own()
                except OpusUnsupported:
                    pcm = self._core._fallback()
                self._primed = True
            else:
                pcm = self._core.decode_packet_f32(p)
            if pcm.size:
                outs.append(AudioData(
                    bits_per_sample=32,
                    channel_count=self._core.channels,
                    sampling_rate=self._core.sample_rate,
                    data=np.asarray(pcm, "<f4").tobytes(),
                    audio_format=EncodingFlag.PCM_FLOAT,
                ))
        return outs


def _classify(packet: bytes, channels: int):
    """(kind, toc, frame) for a servable packet, else (None, ..)."""
    from soundkit_tpu.codecs.opus_core import (
        _TOC_CACHE,
        TOC_ATTRS,
        parse_packet,
    )

    if not packet:
        return None, None, None
    mode, dur, stereo, _bw, code = TOC_ATTRS[packet[0]]
    if code == 0:
        # fast path: code-0 packets (one frame) need no length parse
        if dur != 20 or (2 if stereo else 1) > channels:
            return None, None, None
        return mode, _TOC_CACHE[packet[0]], packet[1:]
    try:
        toc, frames = parse_packet(packet)
    except Exception:
        return None, None, None
    coded = 2 if toc.stereo else 1
    if (toc.frame_duration != 20 or len(frames) != 1
            or coded > channels):
        return None, None, None
    if toc.mode == "celt":
        return "celt", toc, frames[0]
    if toc.mode == "silk":
        return "silk", toc, frames[0]
    if toc.mode == "hybrid":
        return "hybrid", toc, frames[0]
    return None, None, None


class BatchedOggOpusDecoder:
    """B-lane Ogg-Opus serving model over the device CELT synthesis."""

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2,
                 celt_wire: str = "f32"):
        self.B = num_streams
        self.C = channels
        self._celt = BatchedCeltDecoder(num_streams, channels,
                                        wire=celt_wire)
        self._silk = BatchedSilkDeviceDecoder(num_streams, channels)
        self._hyb = BatchedHybridDecoder(num_streams, channels)
        self._kind: List[Optional[str]] = [None] * num_streams
        self._demux: List[OggOpusDemuxer] = [
            OggOpusDemuxer() for _ in range(num_streams)
        ]
        self._queued = [0] * num_streams  # packets ever queued per lane
        # converge-from-tail reroute state: bounded packet tail plus
        # trimmed-duration / emitted-sample accounting per lane
        self._tail: List[List[bytes]] = [[] for _ in range(num_streams)]
        self._tail_dropped = [0] * num_streams  # 48k samples trimmed
        self._emitted = [0] * num_streams  # samples delivered per lane

    #: warmup packets retained beyond the undecoded queue (~2 s at
    #: 20 ms — matches codecs/opus.py _HISTORY_KEEP; far beyond CELT/
    #: SILK state memory, so a tail replay converges before it ends)
    TAIL_KEEP = 96

    def reset_lane(self, b: int) -> None:
        self._celt.reset_lane(b)
        self._silk.reset_lane(b)
        self._hyb.reset_lane(b)
        self._kind[b] = None
        self._demux[b] = OggOpusDemuxer()
        self._queued[b] = 0
        self._tail[b] = []
        self._tail_dropped[b] = 0
        self._emitted[b] = 0

    def lane_configured(self, b: int) -> bool:
        # an Opus lane can still hit a reroute at any packet (mode
        # switch) — but the reroute replays from the lane's own
        # bounded tail, so the fleet retains NO raw bytes; report
        # configured as soon as the head has parsed
        return self._demux[b].head is not None

    def _reroute(self, b: int, msg: str, pending: List[bytes]):
        """Build the reroute exception: the lane's demuxer, head, and
        bounded tail (plus the still-unprocessed packets of the
        current push, offender first) seed a _OpusTailFallback."""
        exc = OpusLaneUnsupported(msg)
        exc.replay = dict(
            demux=self._demux[b], head=self._demux[b].head,
            tail=list(self._tail[b]), dropped=self._tail_dropped[b],
            emitted=self._emitted[b], pending=pending,
        )
        return exc

    def lane_sample_rate(self, b: int) -> Optional[int]:
        return 48000 if self._demux[b].head is not None else None

    def lane_ready(self, b: int) -> int:
        if self._kind[b] == "silk":
            return self._silk.lane_ready(b)
        if self._kind[b] == "hybrid":
            return self._hyb.lane_ready(b)
        return self._celt.queued(b)

    def push(self, b: int, data: bytes) -> None:
        dm = self._demux[b]
        had_head = dm.head is not None
        pkts = dm.push(data)
        if dm.head is not None and not had_head:
            if dm.head.channels > self.C or dm.head.mapping_family != 0:
                raise self._reroute(b, "unsupported OpusHead", pkts)
            self._celt.configure_lane(
                b, dm.head.pre_skip, dm.head.output_gain
            )
            self._silk.configure_lane(
                b, dm.head.pre_skip, dm.head.output_gain
            )
        for i, pkt in enumerate(pkts):
            kind, toc, frame = _classify(pkt, self.C)
            if kind is None:
                raise self._reroute(
                    b, "non-20ms/multiframe packet", pkts[i:])
            if self._kind[b] is None:
                self._kind[b] = kind
            if kind != self._kind[b]:
                raise self._reroute(b, "mid-stream mode switch", pkts[i:])
            if kind == "celt":
                # _classify already split the TOC: hand the frame +
                # end band + coded channels straight to the queue (no
                # second split in the decode loop)
                self._celt.push_frame(
                    b, frame, self._celt._band_end_i[toc.bandwidth],
                    2 if toc.stereo else 1)
            elif kind == "hybrid":
                # a transition-redundancy packet at stream START is
                # flagged by the engine at decode time; reroute the
                # lane on its next push (real encoders attach
                # redundancy only to transition packets, which the
                # mode-switch guard above reroutes before decode)
                if self._hyb.lane_error(b):
                    raise self._reroute(
                        b, self._hyb.lane_error(b), pkts[i:])
                self._hyb.push_packet(b, frame, toc.bandwidth,
                                      2 if toc.stereo else 1)
            else:
                # a SILK packet with trailing CELT redundancy only
                # appears at mode/bandwidth switches; the switch
                # packet itself triggers the reroute below, and the
                # replay decodes the redundancy exactly
                bw0 = self._silk.bw[b]
                if bw0 is not None and toc.bandwidth != bw0:
                    raise self._reroute(
                        b, "silk bandwidth switch", pkts[i:])
                self._silk.push_packet(b, frame, toc.bandwidth,
                                       2 if toc.stereo else 1)
            self._queued[b] += 1
            self._tail[b].append(pkt)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode up to ``n`` lockstep packet rounds.

        Returns (pcm, lengths): pcm [rounds, B, C, 960] (device array
        when ``device_out``, valid samples at the END of each slot;
        host array otherwise, valid samples at the START), lengths
        [rounds, B] int32.

        All three engines produce lane-disjoint device slots with
        zeros elsewhere, so the device combine is a pure add — no
        scatters, no host staging."""
        # dispatch every engine's device rounds (async) before any
        # combine/fetch work
        parts = [engine.decode_ready(max_packets=n, device_out=device_out)
                 for engine in (self._celt, self._silk, self._hyb)]
        R = max(lens.shape[0] for _, lens in parts)
        if R == 0:
            return parts[0]
        lengths = np.zeros((R, self.B), np.int32)
        for _, lens in parts:
            lengths[: lens.shape[0]] += lens
        # converge-from-tail bookkeeping: count delivered samples and
        # trim each lane's retained tail to (undecoded queue +
        # TAIL_KEEP warmup packets); every trimmed packet is a decoded
        # 20 ms frame (960 raw 48k samples)
        tot = lengths.sum(axis=0)
        for b in range(self.B):
            self._emitted[b] += int(tot[b])
            t = self._tail[b]
            keep = self.lane_ready(b) + self.TAIL_KEEP
            if len(t) > keep:
                cut = len(t) - keep
                del t[:cut]
                self._tail_dropped[b] += 960 * cut
        if device_out:
            import jax.numpy as jnp

            total = None
            for pcm, lens in parts:
                r = lens.shape[0]
                if r == 0:
                    continue
                if r < R:
                    pcm = jnp.concatenate(
                        [pcm, jnp.zeros((R - r, self.B, self.C,
                                         self.FRAME), jnp.float32)],
                        axis=0)
                total = pcm if total is None else total + pcm
            return total, lengths
        out = np.zeros((R, self.B, self.C, self.FRAME), np.float32)
        cpcm, clen = parts[0]
        out[: clen.shape[0]] = cpcm  # celt host slots: valid at START
        for pcm, lens in parts[1:]:
            # silk/hybrid host slots carry valid samples at the END;
            # convert to the host START convention lane-wise
            for i in range(lens.shape[0]):
                for b in np.flatnonzero(lens[i]):
                    m = int(lens[i, b])
                    out[i, b, :, :m] = pcm[i, b, :, self.FRAME - m:]
        return out, lengths
