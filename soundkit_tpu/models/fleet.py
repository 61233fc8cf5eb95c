"""StreamFleet — the multi-stream serving runtime.

The reference serves N streams by spawning one DecodePipeline thread
per stream (soundkit-decoder/src/lib.rs spawn*).  The device-batched
analog routes each arriving byte stream, after format detection, into
a fixed-capacity **batched lane group** for its codec (AAC-LC, MP3,
FLAC — the device-batched models) or a per-stream host fallback
(everything else via StreamDecoder), decodes all groups in lockstep
device batches, and returns per-stream PCM.  Lanes are recycled when a
stream ends, so a long-running fleet serves an unbounded sequence of
streams with bounded device state.

Ragged arrival is first-class: a group decodes
``max(lane_ready)`` batches per collect; lanes with no data decode as
silence with frozen state (the models' validity masks), and the fleet
slices each stream's true output by its per-lane produced count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from soundkit_tpu.demux.detect import AudioType, detect_audio

MIN_DETECT = 8192

#: headerless telephony codecs served by the sixth batched group via
#: explicit-kind ingest (``push(sid, data, kind=...)`` — the analog of
#: spawn_g711(law, rate, channels), soundkit-decoder/src/lib.rs:616-654)
TELEPHONY_KINDS = (
    "g711_mulaw", "g711_alaw", "g722",
    "g726_16", "g726_24", "g726_32", "g726_40",
)


@dataclass
class _Lane:
    group: str
    index: int
    produced: int = 0  # batches decoded for this lane so far


#: headerless/raw kinds served by per-stream host pipelines through
#: the same explicit-kind ingest (the spawn_gsm / spawn_amr_nb /
#: spawn_g729 / spawn_opus analogs — no batched group, but explicit
#: spawns never depend on autodetect)
HOST_KINDS = ("gsm", "amr_nb", "g729", "opus_raw")


def _explicit_host_decoder(kind: str):
    """Per-stream host decoder for an explicit kind: headerless kinds
    with no batched group (HOST_KINDS), or a telephony/batched kind
    whose group is full (the reference's spawn_* always succeeds;
    overflow streams keep decoding, just without batching)."""
    from soundkit_tpu.pipeline.decode_pipeline import (
        DecodeOptions,
        StreamDecoder,
    )

    if kind in HOST_KINDS:
        if kind == "gsm":
            from soundkit_tpu.codecs.telephony import (
                GsmVariant,
                make_gsm_adapter,
            )

            return StreamDecoder(
                DecodeOptions(), make_gsm_adapter(GsmVariant.STANDARD))
        if kind == "amr_nb":
            from soundkit_tpu.codecs.telephony import make_amr_adapter

            return StreamDecoder(DecodeOptions(), make_amr_adapter())
        if kind == "g729":
            from soundkit_tpu.codecs.telephony import make_g729_adapter

            return StreamDecoder(DecodeOptions(), make_g729_adapter())
        from soundkit_tpu.codecs.containers import make_opus_stream_adapter

        return StreamDecoder(
            DecodeOptions(), make_opus_stream_adapter())
    if kind not in TELEPHONY_KINDS:
        return StreamDecoder()  # container formats self-detect
    from soundkit_tpu.codecs.g711 import G711Law
    from soundkit_tpu.codecs.g726 import G726Packing, G726Rate
    from soundkit_tpu.pipeline.decode_pipeline import (
        DecodeOptions,
        G711Adapter,
        G722Adapter,
        G726Adapter,
    )

    if kind.startswith("g711"):
        law = G711Law.A_LAW if kind.endswith("alaw") else G711Law.MU_LAW
        return StreamDecoder(DecodeOptions(), G711Adapter(law, 8000, 1))
    if kind == "g722":
        return StreamDecoder(DecodeOptions(), G722Adapter())
    rate = {
        "g726_16": G726Rate.RATE_16000, "g726_24": G726Rate.RATE_24000,
        "g726_32": G726Rate.RATE_32000, "g726_40": G726Rate.RATE_40000,
    }[kind]
    return StreamDecoder(
        DecodeOptions(), G726Adapter(rate, G726Packing.LEFT))


def _slice_lane_host(kind, arr, lane, k, meta, out_bits):
    """Slice one lane's valid PCM out of a fetched group batch.

    ``arr`` is the host copy of the staged [n, B, ...] group output;
    returns [C, samples] (or None when an opus lane produced nothing).
    Shared by the fetching ``collect()`` and the device-resident
    ``FleetLaneOutput.fetch()`` so both modes are bit-identical."""
    if kind == "opus":
        parts = []
        for r in range(k):
            m = int(meta[r][lane])
            if m > 0:
                parts.append(arr[r, lane, :, arr.shape[-1] - m:])
        return np.concatenate(parts, axis=1) if parts else None
    if kind == "flac":
        parts = []
        for f in range(k):
            mt = meta[f][lane]
            ch = max(int(mt[1]), 1)
            sl = arr[f, lane, :ch, : mt[0]]
            if out_bits == 16:
                parts.append(sl)  # already exact int16
            else:
                parts.append(sl.astype(np.float32) / 32768.0)
        return np.concatenate(parts, axis=1)
    if kind in TELEPHONY_KINDS:
        parts = []
        for r in range(k):
            m = int(meta[r][lane])
            if m > 0:
                sl = arr[r, lane, :, :m]  # i16-native, valid at START
                parts.append(sl if out_bits == 16
                             else sl.astype(np.float32) / 32768.0)
        return np.concatenate(parts, axis=1) if parts else None
    lanes = arr[:k, lane]  # [k, C, S]
    return np.transpose(lanes, (1, 0, 2)).reshape(lanes.shape[1], -1)


@dataclass
class FleetLaneOutput:
    """One stream's newly produced PCM, left ON DEVICE.

    Returned by ``StreamFleet.collect(device_out=True)``.  A consumer
    that keeps post-processing on device (resampler, mixer, encoder:
    the transcode chain) never pays the d2h fetch of decoded PCM.
    ``device`` is the group's staged [n, B, ...] batch (shared by every
    lane of the group); ``samples`` counts this stream's valid samples
    per channel without any transfer.  ``fetch()`` materialises the host PCM,
    bit-identical to plain ``collect()`` (one shared fetch per group).
    Host-produced streams (vorbis ragged lanes, pipeline fallbacks)
    carry their PCM in ``host`` directly."""

    kind: str
    samples: int
    rate: Optional[int]
    device: object = None
    lane: int = -1
    frames: int = 0
    meta: object = None
    out_bits: int = 32
    host: Optional[np.ndarray] = None
    _cache: Optional[dict] = None

    def fetch(self) -> Optional[np.ndarray]:
        if self.host is not None:
            return self.host
        if self._cache is None:
            self._cache = {}
        if "arr" not in self._cache:
            from soundkit_tpu.utils.wire import from_device_chunked

            self._cache["arr"] = from_device_chunked(self.device)
        return _slice_lane_host(
            self.kind, self._cache["arr"], self.lane, self.frames,
            self.meta, self.out_bits,
        )


class _BatchedGroup:
    """Wraps one batched model with lane allocation/recycling."""

    def __init__(self, kind: str, capacity: int, channels: int,
                 opus_wire: str = "f32"):
        self.kind = kind
        self.capacity = capacity
        self.channels = channels
        self.opus_wire = opus_wire
        self._free = list(range(capacity))
        self._used: set = set()  # lanes that have hosted a stream
        self._model = None  # built lazily (FLAC stride, AAC jit, ...)

    def _ensure(self):
        if self._model is not None:
            return self._model
        if self.kind == "aac":
            from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder

            self._model = BatchedAacLcDecoder(self.capacity, self.channels)
        elif self.kind == "mp3":
            from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder

            self._model = BatchedMp3Decoder(self.capacity, self.channels)
        elif self.kind == "flac":
            from soundkit_tpu.models.flac_batch import BatchedFlacDecoder

            self._model = BatchedFlacDecoder(self.capacity)
        elif self.kind == "vorbis":
            from soundkit_tpu.models.vorbis_batch import BatchedVorbisDecoder

            self._model = BatchedVorbisDecoder(self.capacity)
        elif self.kind == "opus":
            from soundkit_tpu.models.opus_fleet_model import (
                BatchedOggOpusDecoder,
            )

            self._model = BatchedOggOpusDecoder(self.capacity, self.channels,
                                                celt_wire=self.opus_wire)
        elif self.kind in TELEPHONY_KINDS:
            from soundkit_tpu.models.telephony_batch import TelephonyLaneGroup

            self._model = TelephonyLaneGroup(self.kind, self.capacity)
        else:
            raise ValueError(self.kind)
        return self._model

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        lane = self._free.pop()
        # clear the previous occupant — fresh lanes skip it (a model
        # starts zeroed, and per-lane device resets are a scatter
        # dispatch each: 0.7 s of a 1024-stream cold start was resets)
        if self._model is not None and lane in self._used:
            self._model.reset_lane(lane)
        self._used.add(lane)
        return lane

    def release(self, lane: int) -> None:
        self._free.append(lane)

    def push(self, lane: int, data: bytes) -> None:
        self._ensure().push(lane, data)

    def lane_ready(self, lane: int) -> int:
        return self._ensure().lane_ready(lane)

    def lane_configured(self, lane: int) -> bool:
        """True once the lane can no longer reject the stream (only the
        Vorbis model has a per-group topology constraint)."""
        m = self._ensure()
        fn = getattr(m, "lane_configured", None)
        return True if fn is None else fn(lane)

    def lane_sample_rate(self, lane: int) -> Optional[int]:
        if self._model is None:
            return None
        return self._model.lane_sample_rate(lane)

    def decode(self, n: int, device_out: bool = False):
        m = self._ensure()
        if self.kind == "vorbis":
            return m.decode_batches(n)  # ragged host lists
        return m.decode_batches(n, device_out=device_out)


class StreamFleet:
    """Route detected streams into batched codec groups.

    - ``push(stream_id, data)``: buffer until detection (8 KiB or
      ``end_stream``), then feed the stream's lane / fallback decoder.
    - ``end_stream(stream_id)``: EOF; triggers detection for small
      streams, flushes fallbacks, and recycles the lane at the next
      ``collect``.
    - ``collect()``: decode all groups in lockstep batches and return
      ``{stream_id: f32 PCM [C, samples]}`` newly produced since the
      last collect.
    """

    BATCH_SAMPLES = {"aac": 1024, "mp3": 576}

    def __init__(self, capacity_per_group: int = 16, channels: int = 2,
                 out_bits: int = 32):
        """``out_bits=16`` is the serving-mode analog of the
        reference's default i16 output (DecodeOptions
        output_bits_per_sample / decode_i16, soundkit-decoder
        lib.rs:88-92): PCM quantizes to int16 ON DEVICE (*32767
        out-scale, audio_pipeline.rs:14-35) so the d2h fetch moves half
        the bytes.  FLAC 16-bit lanes are bit-exact in
        this mode (their samples are i16-valued integers already).
        ``out_bits=32`` returns f32 planes (the default)."""
        if out_bits not in (16, 32):
            raise ValueError("out_bits must be 16 or 32")
        self.out_bits = out_bits
        self.channels = channels
        self._cap = capacity_per_group
        # i16 output mode also rides the half-width int16 CELT
        # spectral wire (per-band scales, ~98 dB — above the i16
        # output floor); f32 output keeps the exact f32 wire
        self._groups: Dict[str, _BatchedGroup] = {
            k: _BatchedGroup(k, capacity_per_group, channels,
                             opus_wire="i16" if out_bits == 16 else "f32")
            for k in ("aac", "mp3", "flac", "vorbis", "opus")
        }
        self._lanes: Dict[str, _Lane] = {}
        self._detect: Dict[str, bytearray] = {}
        # raw bytes of lane streams whose group can still reject them
        # (Vorbis topology, confirmed only at header parse) — kept so a
        # rejected stream can be replayed into a host fallback
        self._pretopo: Dict[str, bytearray] = {}
        self._fallback: Dict[str, object] = {}
        self._ended: Dict[str, bool] = {}
        self._pending_out: Dict[str, List[np.ndarray]] = {}
        self._rates: Dict[str, int] = {}  # last known rate per stream
        self._retired: List[str] = []  # recycled last collect; rates
        # kept one extra collect-cycle so callers can still query the
        # rate of PCM they just received, then purged (bounded state)

    # -- ingest -----------------------------------------------------------

    def push(self, stream_id: str, data: bytes,
             kind: Optional[str] = None) -> None:
        """Feed stream bytes.  ``kind`` is the EXPLICIT-KIND ingest for
        headerless formats autodetect cannot route (the
        ``spawn_g711(law, rate, channels)`` analog,
        soundkit-decoder/src/lib.rs:616-654): one of
        :data:`TELEPHONY_KINDS` (G.726 kinds assume left-justified
        packing, the reference CLI default), a headerless host kind
        from :data:`HOST_KINDS` (gsm / amr_nb / g729 / opus_raw — the
        spawn_gsm/spawn_amr_nb/spawn_g729/spawn_opus analogs), or a
        batched group name ("aac", "mp3", "flac", "vorbis", "opus")
        to skip detection.  Only the first push of a stream may carry
        ``kind``."""
        self._ended.setdefault(stream_id, False)
        if stream_id in self._lanes:
            self._push_lane(stream_id, data)
            return
        if stream_id in self._fallback:
            self._feed_fallback(stream_id, data)
            return
        if kind is not None:
            buf = bytes(self._detect.pop(stream_id, b"")) + data
            self._route_explicit(stream_id, kind, buf)
            return
        buf = self._detect.setdefault(stream_id, bytearray())
        buf.extend(data)
        if len(buf) >= MIN_DETECT:
            self._route(stream_id)

    def _push_lane(self, stream_id: str, data: bytes) -> None:
        """Feed a lane-routed stream; if the model rejects it at header
        parse (Vorbis topology mismatch), free the lane and replay the
        stream's bytes into a per-stream host fallback instead of
        raising out of push (the stream decoded fine pre-batching)."""
        from soundkit_tpu.models.opus_fleet_model import OpusLaneUnsupported
        from soundkit_tpu.models.vorbis_batch import TopologyMismatch

        ln = self._lanes[stream_id]
        group = self._groups[ln.group]
        pre = self._pretopo.get(stream_id)
        if pre is not None:
            pre.extend(data)
        try:
            group.push(ln.index, data)
        except (TopologyMismatch, OpusLaneUnsupported) as e:
            group.release(ln.index)
            del self._lanes[stream_id]
            replay = getattr(e, "replay", None)
            if replay is not None:
                # opus reroute: seed a single-stream decoder from the
                # lane's bounded packet tail (O(1) retained bytes) and
                # drain the current push's unprocessed packets now
                from soundkit_tpu.models.opus_fleet_model import (
                    _OpusTailFallback,
                )

                self._pretopo.pop(stream_id, None)
                self._fallback[stream_id] = _OpusTailFallback(**replay)
                self._feed_fallback(stream_id, b"")
            else:
                raw = bytes(self._pretopo.pop(stream_id, data))
                from soundkit_tpu.pipeline.decode_pipeline import (
                    StreamDecoder,
                )

                self._fallback[stream_id] = StreamDecoder()
                self._feed_fallback(stream_id, raw)
            if self._ended.get(stream_id):
                self._feed_fallback(stream_id, b"")
            return
        if pre is not None and group.lane_configured(ln.index):
            del self._pretopo[stream_id]

    def end_stream(self, stream_id: str) -> None:
        if stream_id in self._detect:
            self._route(stream_id)
        self._ended[stream_id] = True
        if stream_id in self._fallback:
            self._feed_fallback(stream_id, b"")

    def _route(self, stream_id: str) -> None:
        buf = bytes(self._detect.pop(stream_id, b""))
        kind = {
            AudioType.AAC: "aac",
            AudioType.MP3: "mp3",
            AudioType.FLAC: "flac",
            AudioType.OGG_VORBIS: "vorbis",
            AudioType.OGG_OPUS: "opus",
        }.get(detect_audio(buf))
        if kind is not None:
            lane_idx = self._groups[kind].alloc()
            if lane_idx is not None:
                self._lanes[stream_id] = _Lane(kind, lane_idx)
                if kind == "vorbis":
                    # raw bytes retained only while the group can
                    # still reject the stream (until headers parse);
                    # opus lanes reroute from their own bounded packet
                    # tail (opus_fleet_model._OpusTailFallback), so
                    # the fleet retains nothing for them
                    self._pretopo[stream_id] = bytearray()
                self._push_lane(stream_id, buf)
                return
        # unknown codec or group full: per-stream host pipeline
        from soundkit_tpu.pipeline.decode_pipeline import StreamDecoder

        self._fallback[stream_id] = StreamDecoder()
        self._feed_fallback(stream_id, buf)

    def _route_explicit(self, stream_id: str, kind: str,
                        buf: bytes) -> None:
        """Route a stream into a named group, bypassing detection.
        Telephony groups build lazily (most fleets serve none); a full
        group overflows to the matching per-stream host decoder."""
        if kind in HOST_KINDS:
            self._fallback[stream_id] = _explicit_host_decoder(kind)
            self._feed_fallback(stream_id, buf)
            return
        known = kind in TELEPHONY_KINDS or kind in (
            "aac", "mp3", "flac", "vorbis", "opus")
        if not known:
            raise ValueError(f"unknown explicit kind {kind!r}")
        group = self._groups.get(kind)
        if group is None:
            group = _BatchedGroup(kind, self._cap, self.channels)
            self._groups[kind] = group
        lane_idx = group.alloc()
        if lane_idx is not None:
            self._lanes[stream_id] = _Lane(kind, lane_idx)
            if kind == "vorbis":
                self._pretopo[stream_id] = bytearray()
            if buf:
                self._push_lane(stream_id, buf)
            return
        self._fallback[stream_id] = _explicit_host_decoder(kind)
        if kind in TELEPHONY_KINDS:
            self._rates[stream_id] = 16000 if kind == "g722" else 8000
        self._feed_fallback(stream_id, buf)

    def _feed_fallback(self, stream_id: str, data: bytes) -> None:
        from soundkit_tpu.core.audio_types import AudioData

        dec = self._fallback[stream_id]
        outs = dec.process(data)
        audio = [o for o in outs if isinstance(o, AudioData)]
        if audio:
            self._rates[stream_id] = audio[-1].sampling_rate
            self._pending_out.setdefault(stream_id, []).extend(
                np.stack(_to_f32_channels(o)) for o in audio
            )

    def group_model(self, kind: str):
        """The batched model behind group ``kind`` (None until the
        group has been built)."""
        group = self._groups.get(kind)
        return group._model if group is not None else None

    def lane_group(self, stream_id: str) -> Optional[str]:
        """The batched group serving ``stream_id``; None for a stream
        on a per-stream host decoder or not routed yet."""
        ln = self._lanes.get(stream_id)
        return ln.group if ln is not None else None

    def sample_rate(self, stream_id: str) -> Optional[int]:
        """Per-stream sample rate: a lane stream reports its OWN lane's
        rate (mixed-rate groups surface each lane's true rate), a
        fallback stream its decoder's last output rate. None until the
        stream's first header has parsed."""
        ln = self._lanes.get(stream_id)
        if ln is not None:
            return self._groups[ln.group].lane_sample_rate(ln.index)
        return self._rates.get(stream_id)

    # -- decode -----------------------------------------------------------

    def _fetch(self, dev) -> np.ndarray:
        """Fetch a staged device array (already quantized at staging
        time in i16 mode, so half the bytes cross the host link and
        the quantize programs of all groups overlap the first fetch)."""
        from soundkit_tpu.utils.wire import from_device_chunked

        return from_device_chunked(dev)

    def _host_out(self, pcm: np.ndarray) -> np.ndarray:
        """Match the device-side i16 quantization for host-produced
        planes (vorbis ragged output, fallback decoders)."""
        if self.out_bits == 16:
            return np.clip(
                np.round(pcm * 32767.0), -32768, 32767
            ).astype(np.int16)
        return pcm

    def collect(self, device_out: bool = False):
        """Decode every group and return newly produced PCM per stream.

        Two-phase: every group's device program dispatches first
        (async), then the outputs are fetched, so no group's compute
        waits behind another group's transfer.  With ``out_bits=16`` the
        quantization to int16 happens on device before the fetch
        (half the wire bytes).

        ``device_out=True`` skips the fetch entirely and returns
        ``{stream_id: FleetLaneOutput}`` with each lane group's PCM
        left on device — the serving mode for device-resident
        consumers (see FleetLaneOutput); otherwise returns
        ``{stream_id: np.ndarray [C, samples]}``."""
        out: Dict[str, object] = {}
        for sid in self._retired:
            self._rates.pop(sid, None)
        self._retired = []

        staged = []  # (kind, active, ready_before, n, dev, metas)
        for kind, group in self._groups.items():
            active = {
                sid: ln for sid, ln in self._lanes.items() if ln.group == kind
            }
            if not active:
                continue
            n = max(group.lane_ready(ln.index) for ln in active.values())
            if n == 0:
                continue
            ready_before = {
                sid: group.lane_ready(ln.index) for sid, ln in active.items()
            }
            if kind == "vorbis":
                # ragged per-lane PCM lists (packet output length varies
                # with the neighboring block sizes)
                per_lane = group.decode(n)
                for sid, ln in active.items():
                    pcm = per_lane[ln.index]
                    if pcm.shape[-1]:
                        hostpcm = self._host_out(pcm.astype(np.float32))
                        if device_out:
                            out[sid] = FleetLaneOutput(
                                kind="vorbis", samples=hostpcm.shape[-1],
                                rate=self.sample_rate(sid), host=hostpcm,
                            )
                        else:
                            out[sid] = hostpcm
                        ln.produced += 1
                continue
            if kind == "opus":
                pcm, lengths = group.decode(n, device_out=True)
                if getattr(pcm, "shape", (0,))[0] == 0:
                    continue
                if self.out_bits == 16:
                    pcm = _i16_quantizers()[0](pcm)
                staged.append((kind, active, ready_before, n, pcm, lengths))
                continue
            if kind in TELEPHONY_KINDS:
                # i16-native scans: the staged batch is int16 in BOTH
                # output modes (half the d2h wire; f32 conversion, when
                # asked for, happens host-side after the fetch)
                pcm, lengths = group.decode(n, device_out=True)
                if getattr(pcm, "shape", (0,))[0] == 0:
                    continue
                staged.append((kind, active, ready_before, n, pcm, lengths))
                continue
            if kind == "flac":
                samples, metas = group.decode(n, device_out=True)
                if self.out_bits == 16:
                    # per-(frame, lane) downshift: >16-bit lanes scale
                    # like the reference's s24->i16 (arithmetic >> 8),
                    # not clip; quantize dispatches HERE (phase 1) so
                    # it overlaps other groups' transfers
                    import jax.numpy as jnp

                    shf = np.zeros((n, samples.shape[1]), np.int32)
                    for f in range(n):
                        shf[f] = np.maximum(metas[f][:, 3] - 16, 0)
                    samples = _i16_quantizers()[1](
                        samples, jnp.asarray(shf)
                    )
                staged.append((kind, active, ready_before, n, samples, metas))
            else:
                pcm = group.decode(n, device_out=True)  # [n, B, C, S] f32
                if getattr(pcm, "shape", (0,))[0] == 0:
                    continue
                if self.out_bits == 16:
                    pcm = _i16_quantizers()[0](pcm)
                staged.append((kind, active, ready_before, n, pcm, None))

        for kind, active, ready_before, n, dev, metas in staged:
            if device_out:
                cache: dict = {}
                for sid, ln in active.items():
                    k = min(ready_before[sid], n)
                    if k == 0:
                        continue
                    if kind == "opus" or kind in TELEPHONY_KINDS:
                        cnt = sum(int(metas[r][ln.index]) for r in range(k))
                    elif kind == "flac":
                        cnt = sum(
                            int(metas[f][ln.index][0]) for f in range(k)
                        )
                    else:
                        cnt = k * int(dev.shape[-1])
                    rec = FleetLaneOutput(
                        kind=kind, samples=cnt, rate=self.sample_rate(sid),
                        device=dev, lane=ln.index, frames=k, meta=metas,
                        out_bits=self.out_bits, _cache=cache,
                    )
                    # match plain collect()'s key set: opus/telephony
                    # lanes that produced nothing are skipped there
                    # (slice returns None), every other kind emits
                    # (flac can emit a zero-length array)
                    if cnt > 0 or (kind != "opus"
                                   and kind not in TELEPHONY_KINDS):
                        out[sid] = rec
                    ln.produced += k
                continue
            arr = self._fetch(dev)
            for sid, ln in active.items():
                k = min(ready_before[sid], n)
                if k == 0:
                    continue
                pcm = _slice_lane_host(
                    kind, arr, ln.index, k, metas, self.out_bits
                )
                if pcm is not None:
                    out[sid] = pcm
                ln.produced += k

        # fallback streams: whatever their host decoders produced
        for sid, parts in list(self._pending_out.items()):
            if parts:
                maxc = max(p.shape[0] for p in parts)
                padded = [
                    np.pad(p, ((0, maxc - p.shape[0]), (0, 0))) for p in parts
                ]
                pcm = self._host_out(np.concatenate(padded, axis=1))
                if device_out:
                    out[sid] = FleetLaneOutput(
                        kind="host", samples=pcm.shape[-1],
                        rate=self._rates.get(sid), host=pcm,
                    )
                else:
                    out[sid] = pcm
                self._pending_out[sid] = []

        # recycle lanes of ended, fully drained streams — and drop all
        # bookkeeping so a long-running fleet has bounded state
        for sid in [s for s, e in self._ended.items() if e]:
            ln = self._lanes.get(sid)
            if ln is not None:
                if self._groups[ln.group].lane_ready(ln.index) == 0:
                    rate = self._groups[ln.group].lane_sample_rate(ln.index)
                    if rate is not None:
                        self._rates[sid] = rate
                    self._retired.append(sid)
                    self._groups[ln.group].release(ln.index)
                    del self._lanes[sid]
                    del self._ended[sid]
                    self._pretopo.pop(sid, None)
            elif sid in self._fallback:
                if not self._pending_out.get(sid):
                    del self._fallback[sid]
                    self._pending_out.pop(sid, None)
                    self._retired.append(sid)
                    del self._ended[sid]
            elif sid not in self._detect:
                del self._ended[sid]
        return out


import functools


@functools.lru_cache(maxsize=1)
def _i16_quantizers():
    """Jitted device-side i16 quantizers: f32 in [-1, 1] via the
    reference's *32767 out-scale (audio_pipeline.rs:14-35), and int32
    FLAC samples with a per-(frame, lane) arithmetic downshift —
    exact for 16-bit streams (shift 0), s24le_to_i16-style >> 8 for
    24-bit lanes (audio_bytes.rs:66)."""
    import jax
    import jax.numpy as jnp

    f32 = jax.jit(
        lambda x: jnp.clip(
            jnp.round(x * 32767.0), -32768, 32767
        ).astype(jnp.int16)
    )
    i32 = jax.jit(
        lambda x, shift: jnp.clip(
            x >> shift[:, :, None, None], -32768, 32767
        ).astype(jnp.int16)
    )
    return f32, i32


def _to_f32_channels(audio) -> List[np.ndarray]:
    from soundkit_tpu.core.audio_pipeline import audio_to_f32_channels

    return audio_to_f32_channels(audio)
