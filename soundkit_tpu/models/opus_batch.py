"""Batched multi-stream Opus decoders.

Two serving models share the soundkit raw-Opus wire framing (u16-LE
length-prefixed packets, codecs/opus.py OpusStreamDecoder framing):

- ``BatchedCeltDecoder`` — the device path for CELT streams.  The
  range decoder / allocation / PVQ stage is inherently sequential
  (per-symbol adaptive entropy coding), so it runs on the host via
  the owned RFC 6716 decoder (codecs/opus_celt.py,
  ``parse_only=True``); the synthesis — IMDCT, overlap-add, comb
  postfilter, de-emphasis, where the FLOPs are — runs as ONE jitted
  step over all lanes (ops/celt_batch.py), following the framework's
  host parse -> fixed-shape [B, C, ...] -> jitted step with carried
  state pattern.
- ``BatchedOpusDecoder`` — the generic fallback: one libavcodec
  decoder per lane, batched at the framing level only.  Kept for
  SILK/hybrid/multi-frame packings the device model does not serve.

Reference role: soundkit-opus's per-pipeline decoder
(soundkit-opus/src/lib.rs), rebatched for lockstep serving.
"""
from __future__ import annotations

import functools
import struct
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.avdec import AvDecoder


def _default_extradata(channels: int) -> bytes:
    # minimal OpusHead: version 1, channels, preskip 0, 48k, gain 0, mapping 0
    return (
        b"OpusHead" + bytes([1, channels]) + struct.pack("<HIhB", 0, 48000, 0, 0)
    )


class BatchedOpusDecoder:
    FRAME = 960  # 20 ms @ 48 kHz, the dominant packing

    def __init__(self, num_streams: int, channels: int = 2):
        self.B = num_streams
        self.C = channels
        # decoders are created lazily from each lane's OpusHead so
        # avcodec honors the stream's preskip/gain; lanes without a
        # head (bare packet wire) get a minimal default head
        self._dec: List[Optional[AvDecoder]] = [None] * num_streams
        self._extradata = [_default_extradata(channels)] * num_streams
        self._buf = [bytearray() for _ in range(num_streams)]
        self._packets: List[List[bytes]] = [[] for _ in range(num_streams)]
        self._head_done = [False] * num_streams
        self.sample_rate = 48000

    def _decoder(self, b: int) -> AvDecoder:
        if self._dec[b] is None:
            self._dec[b] = AvDecoder("opus", extradata=self._extradata[b])
        return self._dec[b]

    def push(self, stream_idx: int, data: bytes) -> None:
        """Feed the soundkit raw-Opus wire: optional OpusHead(19B),
        then u16-LE length-prefixed packets (soundkit-opus framing)."""
        buf = self._buf[stream_idx]
        buf.extend(data)
        if not self._head_done[stream_idx]:
            if len(buf) < 8:
                return
            if bytes(buf[:8]) == b"OpusHead":
                if len(buf) < 19:
                    return
                self._extradata[stream_idx] = bytes(buf[:19])
                del buf[:19]
            self._head_done[stream_idx] = True
        while len(buf) >= 2:
            (n,) = struct.unpack_from("<H", buf, 0)
            if len(buf) < 2 + n:
                break
            self._packets[stream_idx].append(bytes(buf[2 : 2 + n]))
            del buf[: 2 + n]

    @property
    def ready_packets(self) -> int:
        return min(len(p) for p in self._packets)

    def decode_ready(self, max_packets: Optional[int] = None):
        """Decode lockstep packet batches.

        Returns (pcm [packets, B, C, 960] f32, lengths [packets, B]
        i32).  ``lengths`` is the valid sample count per slot — the
        first packet of a stream is short by the head's preskip, and
        oversized packings are truncated to FRAME (the per-lane
        decoder state stays correct regardless).
        """
        n = self.ready_packets
        if max_packets is not None:
            n = min(n, max_packets)
        out = np.zeros((n, self.B, self.C, self.FRAME), dtype=np.float32)
        lengths = np.zeros((n, self.B), dtype=np.int32)
        for i in range(n):
            for b in range(self.B):
                pkt = self._packets[b].pop(0)
                dec = self._decoder(b)
                pcm = dec.push(pkt)  # interleaved f32
                if len(pcm) == 0:
                    continue
                frames = pcm.reshape(-1, dec.channels or self.C)
                k = min(len(frames), self.FRAME)
                out[i, b, : frames.shape[1], :k] = frames[:k].T
                lengths[i, b] = k
        return out, lengths


@functools.lru_cache(maxsize=4)
def _celt_masked_step():
    """Jitted lockstep CELT synthesis with a validity mask: invalid
    lanes (no packet this round) emit silence and freeze their
    carried state, the standard ragged-lane pattern."""
    import jax
    import jax.numpy as jnp

    from soundkit_tpu.ops.celt_batch import celt_synth_step

    def step(freq, short_flag, comb_params, valid, ola, hist, emph):
        pcm, o2, h2, e2 = celt_synth_step(
            freq, short_flag, comb_params, ola, hist, emph
        )
        v1 = valid[:, None, None]
        pcm = jnp.where(v1, pcm, 0.0)
        o2 = jnp.where(v1, o2, ola)
        h2 = jnp.where(v1, h2, hist)
        e2 = jnp.where(valid[:, None], e2, emph)
        return pcm, o2, h2, e2

    return jax.jit(step)


# rounds per device call: each call has a fixed dispatch+sync cost,
# so lockstep rounds are batched through one jitted scan; always
# called at this R (short tails padded with invalid rounds) so
# exactly one program is ever compiled
ROUNDS_PER_CALL = 8


@functools.lru_cache(maxsize=4)
def _celt_multi_step(quant: bool = False):
    """jit of ROUNDS_PER_CALL masked synthesis rounds as one scan:
    inputs [R, B, ...], carried (ola, hist, emph), output
    pcm [R, B, C, 960].

    The freq wire may arrive trimmed to the coded band end (all bins
    above ``celt_freq_bands[end] * 8`` are structurally zero — 320 of
    960 for a WB stream) and is zero-padded back to the frame size on
    device; the jit specializes per wire width, and widths take only
    the handful of values the TOC bandwidths allow, so at most four
    programs ever compile.

    ``quant=True`` is the half-width serving wire: ``freq`` arrives
    int16 with per-(round, lane, band) f32 ``scales`` [R, B, 21] and a
    bin→band map ``band_idx`` [W] i32; the dequantize is the first
    fused op on device (skt_celt_parse_many_q produced the wire)."""
    import jax
    from jax import lax

    import jax.numpy as jnp

    from soundkit_tpu.ops.celt_batch import N as FRAME_N, celt_synth_step

    def body(carry, xs):
        ola, hist, emph = carry
        freq, short_flag, comb_params, valid = xs
        pcm, o2, h2, e2 = celt_synth_step(
            freq, short_flag, comb_params, ola, hist, emph
        )
        v1 = valid[:, None, None]
        pcm = jnp.where(v1, pcm, 0.0)
        o2 = jnp.where(v1, o2, ola)
        h2 = jnp.where(v1, h2, hist)
        e2 = jnp.where(valid[:, None], e2, emph)
        return (o2, h2, e2), pcm

    def multi(freq, short_flag, comb_params, valid, ola, hist, emph,
              scales=None, band_idx=None):
        if quant:
            freq = freq.astype(jnp.float32) \
                * scales[:, :, band_idx][:, :, None, :]
        w = freq.shape[-1]
        if w < FRAME_N:
            freq = jnp.pad(
                freq, ((0, 0), (0, 0), (0, 0), (0, FRAME_N - w))
            )
        (ola, hist, emph), pcm = lax.scan(
            body, (ola, hist, emph),
            (freq, short_flag, comb_params, valid),
        )
        return pcm, ola, hist, emph

    return jax.jit(multi)


# hybrid CELT runs from start band 17 to at most band 21: at the 960
# frame size the spectrum is structurally zero outside bins
# [freq_bands[17]*8, freq_bands[21]*8) = [320, 800) — the wire ships
# only that window and the device pads it back
_HYB_BIN_LO, _HYB_BIN_HI = 320, 800


# SILK excitation exports as integer Q23 (silk_parse.cpp
# decode_excitation: e = value*256|qoff +-20, out = e / 2^23), so the
# wire ships raw Q23 ints — int16 when every |e| fits (always, in
# practice: |e| needs pulse magnitudes > 127), f32 otherwise
_EXC_Q = 8388608.0


@functools.lru_cache(maxsize=8)
def _hybrid_wire_layout(R: int, B: int, C: int, exc16: bool = True):
    """Packed one-buffer wire for a hybrid chunk (R rounds x B lanes):
    every SILK-export and CELT-continuation plane lives in ONE
    4-byte-aligned uint8 buffer, sliced + bitcast on device, instead
    of ~20 separate arrays per chunk, each with its own transfer
    issue cost.  Returns (layout [(name, off, dtype, shape)],
    total_bytes)."""
    fields = [
        ("exc", np.int16 if exc16 else np.float32, (R, B, 2, 320)),
        ("gains", np.float32, (R, B, 2, 4)),
        ("coef", np.float32, (R, B, 2, 2, 16)),
        ("ltp", np.float32, (R, B, 2, 4, 5)),
        ("ltpscale", np.float32, (R, B, 2)),
        ("stereo_w", np.float32, (R, B, 4)),
        ("freq", np.float32, (R, B, C, _HYB_BIN_HI - _HYB_BIN_LO)),
        ("comb", np.float32, (R, B, 16)),
        ("fresh", np.float32, (R, B)),
        ("gain48", np.float32, (B,)),
        ("lags", np.int32, (R, B, 2, 4)),
        ("hl", np.int32, (R, B, 2)),
        ("vo", np.int32, (R, B, 2)),
        ("cc", np.int32, (R, B, 2)),
        ("um", np.int32, (R, B)),
        ("sr", np.int32, (R, B)),
        ("sflag", np.int32, (R, B)),
        ("valid", np.int32, (R, B)),
    ]
    layout, off = [], 0
    for name, dt, shp in fields:
        layout.append((name, off, dt, shp))
        off += int(np.prod(shp)) * np.dtype(dt).itemsize
    return layout, off


def _wire_views(wire, R: int, B: int, C: int, exc16: bool):
    """Per-field numpy views into a packed hybrid wire buffer."""
    layout, _ = _hybrid_wire_layout(R, B, C, exc16)
    return {
        name: np.frombuffer(wire, dt, int(np.prod(shp)), off)
        .reshape(shp)
        for name, off, dt, shp in layout
    }


@functools.lru_cache(maxsize=8)
def _hybrid_chunk_fn(R: int, B: int, C: int, exc16: bool = True):
    """One jitted dispatch for a whole hybrid chunk: unpack the
    packed wire, run the SILK R-round scan (ops/silk_batch), the CELT
    continuation scan, fold the lane gain, and sum the halves.  The
    round-4 path paid one h2d per plane plus four dispatches per
    chunk; this is ONE chunked h2d + ONE call."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from soundkit_tpu.ops import silk_batch as sb

    scan = sb._jitted_scan(2, C == 2, "float32")
    step = _celt_multi_step()
    layout, total = _hybrid_wire_layout(R, B, C, exc16)

    def unpack(buf):
        out = {}
        for name, off, dt, shp in layout:
            n = int(np.prod(shp))
            width = np.dtype(dt).itemsize
            raw = lax.slice(buf, (off,), (off + n * width,))
            out[name] = lax.bitcast_convert_type(
                raw.reshape(n, width), jnp.dtype(dt)).reshape(shp)
        return out

    def fn(wire, out_hist, lpch_tail, rs_tail, ola, hist, emph):
        p = unpack(wire)
        if exc16:
            p["exc"] = p["exc"].astype(jnp.float32) * (1.0 / _EXC_Q)
        g = p["valid"] != 0
        sy, oh, lp, rt = scan(
            p["exc"], p["gains"], p["coef"], p["hl"], p["vo"],
            p["lags"], p["ltp"], p["ltpscale"], p["cc"], p["um"],
            p["sr"], p["stereo_w"], p["gain48"], g, p["fresh"],
            out_hist, lpch_tail, rs_tail)
        freq = p["freq"] * p["gain48"][None, :, None, None]
        freq = jnp.pad(freq, ((0, 0), (0, 0), (0, 0),
                              (_HYB_BIN_LO, 960 - _HYB_BIN_HI)))
        cpcm, ola, hist, emph = step(
            freq, p["sflag"], p["comb"], g, ola, hist, emph)
        return sy[:, :, :C] + cpcm, oh, lp, rt, ola, hist, emph

    return jax.jit(fn, donate_argnums=(1, 2, 3, 4, 5, 6))


@functools.lru_cache(maxsize=8)
def _band_of_bin(width: int):
    """Static bin→band map for the quantized wire: band k covers
    [freq_bands[k]*8, freq_bands[k+1]*8) at the 960 frame size."""
    from soundkit_tpu.codecs.opus_celt import tables

    fb = tables()["celt_freq_bands"].astype(np.int64) * 8
    return np.clip(
        np.searchsorted(fb, np.arange(width), side="right") - 1, 0, 20
    ).astype(np.int32)


class BatchedCeltDecoder:
    """Lockstep multi-stream CELT-Opus decoder with device synthesis.

    Host side: per-lane range decode + PVQ through the owned CELT
    decoder in ``parse_only`` mode, producing denormalized spectra
    and postfilter parameters.  Device side: one jitted
    ``celt_synth_step`` over ``[B, C, 960]`` (IMDCT / overlap-add /
    comb / de-emphasis), with carried overlap, comb history and
    de-emphasis state resident per lane.

    Serves 20 ms fullband CELT packets (the dominant real-time
    packing and the fixture corpus); SILK, hybrid and other frame
    sizes raise ``OpusUnsupported`` — route those lanes through
    ``BatchedOpusDecoder``.  Mono-coded packets inside stereo lanes
    are duplicated across channels as the host decoder does.

    Reference role: soundkit-opus/src/lib.rs per-pipeline decode,
    re-split so the synthesis FLOPs batch onto the device.
    """

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 1,
                 native: bool = True, wire: str = "f32"):
        from soundkit_tpu.codecs.opus_celt import CeltDecoder, tables

        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        # wire="i16": half-width spectral wire (int16 + per-band f32
        # scales, quantized inside the native parse — ~92 dB vs the
        # exact path, above the fleet's i16 output floor).  Requires
        # the native backend; f32 exactness is the default.
        self._wire_i16 = wire == "i16"
        # host parse backend: the C++ port (native/src/celt_parse.cpp,
        # ~160x the Python stage) when the toolchain is present,
        # otherwise the owned Python decoder
        self._native = None
        if native:
            try:
                from soundkit_tpu.codecs.celt_native import NativeCeltBatch

                self._native = NativeCeltBatch(num_streams, channels)
            except Exception:
                self._native = None
        self._dec = (
            None if self._native is not None
            else [CeltDecoder(channels) for _ in range(num_streams)]
        )
        t = tables()
        self._band_end = t["celt_band_end"].astype(int)
        # plain-int copy: numpy scalar indexing + int() in the
        # per-packet TOC split costs ~1 us/packet at fleet scale
        self._band_end_i = [int(v) for v in self._band_end]
        self._taps = t["celt_postfilter_taps"].astype(np.float64)
        self._buf = [bytearray() for _ in range(num_streams)]
        # per lane: queued (frame_bytes, end_band, coded_channels) —
        # the TOC split happens ONCE at push time (round-5 host diet:
        # the decode loop used to re-split every packet per round)
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self._head_done = [False] * num_streams
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float64)
        from soundkit_tpu.ops.celt_batch import HIST

        # carried synthesis state stays DEVICE-RESIDENT for the
        # model's lifetime (no per-decode host round trip of ~1.2 MB
        # at B=128).  Lane recycling zeroes rows on device via the
        # fresh mask instead.
        self._ola = None   # lazily jnp [B, C, 120]
        self._hist = None  # jnp [B, C, HIST]
        self._emph = None  # jnp [B, C]
        self._hist_len = HIST
        self._fresh = np.zeros(self.B, bool)

    def push(self, stream_idx: int, data: bytes) -> None:
        """Feed the soundkit raw-Opus wire: optional OpusHead(19B),
        then u16-LE length-prefixed packets."""
        buf = self._buf[stream_idx]
        buf.extend(data)
        if not self._head_done[stream_idx]:
            if len(buf) < 8:
                return
            if bytes(buf[:8]) == b"OpusHead":
                if len(buf) < 19:
                    return
                self._skip[stream_idx] = struct.unpack_from("<H", buf, 10)[0]
                gain_q8 = struct.unpack_from("<h", buf, 16)[0]
                if gain_q8:
                    self._gain[stream_idx] = 10.0 ** (gain_q8 / (20.0 * 256.0))
                del buf[:19]
            self._head_done[stream_idx] = True
        while len(buf) >= 2:
            (n,) = struct.unpack_from("<H", buf, 0)
            if len(buf) < 2 + n:
                break
            self._packets[stream_idx].append(
                self._frame_of(bytes(buf[2 : 2 + n])))
            del buf[: 2 + n]

    def push_packet(self, stream_idx: int, packet: bytes) -> None:
        """Enqueue one already-framed Opus packet."""
        self._packets[stream_idx].append(self._frame_of(packet))

    def push_frame(self, stream_idx: int, frame: bytes, end: int,
                   coded: int) -> None:
        """Enqueue one already TOC-split CELT frame (the fleet's Ogg
        layer classifies every packet anyway — no second split)."""
        self._packets[stream_idx].append((frame, end, coded))

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        """Set the OpusHead-derived lane config when packets arrive via
        push_packet (an external demuxer owns the head, e.g. Ogg)."""
        self._skip[b] = pre_skip
        if gain_q8:
            self._gain[b] = 10.0 ** (gain_q8 / (20.0 * 256.0))
        self._head_done[b] = True

    def reset_lane(self, b: int) -> None:
        """Recycle one lane for a new stream (fleet pattern)."""
        if self._native is not None:
            self._native.reset_lane(b)
        else:
            self._dec[b].reset()
        self._buf[b] = bytearray()
        self._packets[b] = []
        self._head_done[b] = False
        self._skip[b] = 0
        self._gain[b] = 1.0
        self._fresh[b] = True  # next decode zeroes the row on device

    def queued(self, b: int) -> int:
        return len(self._packets[b])

    @property
    def ready_packets(self) -> int:
        return min(len(p) for p in self._packets)

    def _frame_of(self, pkt: bytes):
        """TOC split: one packet -> (CELT frame bytes, end band,
        coded channels)."""
        from soundkit_tpu.codecs.opus_core import (
            TOC_ATTRS,
            OpusUnsupported,
            parse_packet,
        )

        if pkt:
            mode, dur, stereo, bw, code = TOC_ATTRS[pkt[0]]
            if code == 0:
                # fast path: code-0 = exactly one frame, body is pkt[1:]
                if mode != "celt" or dur != 20:
                    raise OpusUnsupported(
                        "BatchedCeltDecoder serves single-frame 20 ms "
                        "CELT packets"
                    )
                coded = 2 if stereo else 1
                if coded > self.C:
                    raise OpusUnsupported("stereo packet in a mono lane")
                return pkt[1:], self._band_end_i[bw], coded
        toc, frames = parse_packet(pkt)
        if toc.mode != "celt" or toc.frame_duration != 20 or len(frames) != 1:
            raise OpusUnsupported(
                "BatchedCeltDecoder serves single-frame 20 ms CELT packets"
            )
        coded = 2 if toc.stereo else 1
        if coded > self.C:
            raise OpusUnsupported("stereo packet in a mono lane")
        return frames[0], self._band_end_i[toc.bandwidth], coded

    def _parse_lane(self, b: int, frame: bytes, end: int, coded: int):
        """Python host stage for one lane: range decode + PVQ, returns
        (freq [C, 960], short_flag, comb_params [16])."""
        from soundkit_tpu.codecs.opus_rc import RangeDecoder
        from soundkit_tpu.ops.celt_batch import pack_comb_params

        dec = self._dec[b]
        rc = RangeDecoder(frame)
        dec.decode_frame(rc, self.FRAME, 0, end, coded, parse_only=True)
        lp = dec.last_parse
        freq = np.asarray(lp["freq"], np.float32)
        if coded < self.C:
            freq = np.repeat(freq, self.C, axis=0)
        cp = pack_comb_params(
            lp["pf_state"], lp["pf_period"], lp["pf_gain"],
            lp["pf_tapset"], self._taps,
        )
        return freq, int(bool(lp["shortBlocks"])), cp

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep packet batches on the device.

        Returns (pcm [packets, B, C, 960] f32, lengths [packets, B]
        i32).  Lanes with no queued packet in a round emit silence
        (length 0) and keep their synthesis state frozen; a lane's
        first slots are short by its head's preskip.

        ``device_out=False`` (default): pcm is a host array with the
        valid samples at the START of each slot.

        ``device_out=True``: pcm stays a device array — no d2h fetch
        happens, the serving pattern for downstream device stages.  Valid
        samples then sit at the END of each slot (``slot[...,
        FRAME-length:]``) because the preskip trim is not applied on
        device; length-960 slots are identical under both conventions.
        """
        import jax.numpy as jnp

        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        R = ROUNDS_PER_CALL
        n_pad = (n + R - 1) // R * R
        quant = self._wire_i16 and self._native is not None
        B = self.B
        from soundkit_tpu.codecs.opus_celt import tables as _celt_tables

        fb = _celt_tables()["celt_freq_bands"].astype(np.int64)
        if self._native is not None and n > 0:
            # host stage, round-5 shape: ONE native call walks all
            # rounds x lanes and writes the dispatch-layout wire
            # directly (the per-round freq[i]=copy + re-slice path
            # it replaced was the largest host stage of the fleet)
            lens = np.zeros((B, n_pad), np.int32)
            ends = np.zeros((B, n_pad), np.int32)
            codedm = np.zeros((B, n_pad), np.int32)
            base = np.zeros(B, np.int64)
            parts = []
            pos = 0
            for b in range(B):
                q = self._packets[b]
                k = min(len(q), n)
                if k == 0:
                    continue
                take = q[:k]
                del q[:k]
                lens[b, :k] = [len(t[0]) for t in take]
                ends[b, :k] = [t[1] for t in take]
                codedm[b, :k] = [t[2] for t in take]
                base[b] = pos
                lane_buf = b"".join(t[0] for t in take)
                parts.append(lane_buf)
                pos += len(lane_buf)
            buf = b"".join(parts)
            valid = (lens > 0).T.copy()  # [n_pad, B]
            end_max = int(ends.max())
            W = int(fb[end_max]) * 8 if end_max else self.FRAME
            # n_pad (not n) as the round count: lens/ends/coded are
            # [B, n_pad]-strided and the C walk indexes b*R + r; the
            # pad rounds are lens==0 slots it skips
            freq, scales, comb, sflag, ok = self._native.parse_rounds(
                buf, base, lens, ends, codedm, n_pad, W, quant)
            bad = valid[:n] & (ok[:n] != 0)
            if bad.any():
                i0, b0 = np.argwhere(bad)[0]
                from soundkit_tpu.codecs.opus_core import OpusUnsupported

                raise OpusUnsupported(
                    f"native celt parse failed on lane {int(b0)} "
                    f"round {int(i0)} ({int(ok[i0, b0])})"
                )
        else:
            # Python fallback: per-round, per-lane owned decoder
            freq = np.zeros((n_pad, B, self.C, self.FRAME), np.float32)
            scales = None
            quant = False
            sflag = np.zeros((n_pad, B), np.int32)
            comb = np.zeros((n_pad, B, 16), np.float32)
            valid = np.zeros((n_pad, B), bool)
            end_max = 0
            for i in range(n):
                for b in range(B):
                    if not self._packets[b]:
                        continue
                    frame, end_b, coded_b = self._packets[b].pop(0)
                    freq[i, b], sflag[i, b], comb[i, b] = \
                        self._parse_lane(b, frame, end_b, coded_b)
                    valid[i, b] = True
                    end_max = max(end_max, end_b)
            W = int(fb[end_max]) * 8 if end_max else self.FRAME
        # fold the OpusHead output gain into the spectra: the whole
        # synthesis chain (IMDCT/overlap/comb/de-emphasis) is linear,
        # and the carried state scales consistently lane-wise (on the
        # quantized wire the gain rides the per-band scales instead)
        if np.any(self._gain != 1.0):
            g = self._gain.astype(np.float32)
            if quant:
                scales *= g[None, :, None]
            else:
                freq *= g[None, :, None, None]
        # per-slot valid lengths depend only on packet presence and
        # the remaining preskip — independent of the pcm itself
        # (vectorised: consume preskip greedily across valid rounds)
        vn = valid[:n].astype(np.int64)
        cap = vn * self.FRAME  # per-slot capacity
        cum = np.cumsum(cap, axis=0)  # capacity incl this round
        skip0 = np.array(self._skip, np.int64)
        consumed = np.clip(skip0[None, :] - (cum - cap), 0, cap)
        lengths = (cap - consumed).astype(np.int32)
        if n:
            self._skip = list(np.maximum(skip0 - cum[-1], 0))
        # device stage: R rounds per jitted scan call (fixed R keeps
        # the compiled-program count bounded; each call has a fixed
        # dispatch+sync cost), chunked h2d, and NO per-call sync —
        # every round is dispatched async and a single block happens
        # at the end
        from soundkit_tpu.utils.wire import (
            WIRE_CHUNK_BYTES,
            from_device_chunked,
            to_device_chunked,
        )

        def h2d(a):
            flat = np.ascontiguousarray(a).reshape(-1)
            return to_device_chunked(
                flat, chunk_bytes=WIRE_CHUNK_BYTES // a.itemsize
            ).reshape(a.shape)

        step = _celt_multi_step(quant)
        bidx = None
        if quant:
            import jax.numpy as _jnp

            bidx = _jnp.asarray(_band_of_bin(W))
        if self._ola is None:
            self._ola = jnp.zeros((self.B, self.C, 120), jnp.float32)
            self._hist = jnp.zeros((self.B, self.C, self._hist_len),
                                   jnp.float32)
            self._emph = jnp.zeros((self.B, self.C), jnp.float32)
            self._fresh[:] = False
        ola, hist, emph = self._ola, self._hist, self._emph
        if self._fresh.any():
            keep = jnp.asarray(~self._fresh, jnp.float32)
            ola = ola * keep[:, None, None]
            hist = hist * keep[:, None, None]
            emph = emph * keep[:, None]
            self._fresh[:] = False
        chunks = []
        for r0 in range(0, n_pad, R):
            extra = ()
            if quant:
                extra = (jnp.asarray(scales[r0:r0 + R]), bidx)
            pcm, ola, hist, emph = step(
                h2d(freq[r0:r0 + R, :, :, :W]),
                jnp.asarray(sflag[r0:r0 + R]),
                jnp.asarray(comb[r0:r0 + R]),
                jnp.asarray(valid[r0:r0 + R]),
                ola, hist, emph,
                *extra,
            )
            chunks.append(pcm)
        self._ola, self._hist, self._emph = ola, hist, emph
        if device_out:
            if chunks:
                pcm_all = jnp.concatenate(chunks, axis=0)[:n]
            else:
                pcm_all = jnp.zeros(
                    (0, self.B, self.C, self.FRAME), jnp.float32
                )
            pcm_all.block_until_ready()
            return pcm_all, lengths
        out = np.zeros((n, self.B, self.C, self.FRAME), dtype=np.float32)
        for ci, r0 in enumerate(range(0, n_pad, R)):
            host = from_device_chunked(chunks[ci])
            for i in range(r0, min(r0 + R, n)):
                for b in range(self.B):
                    if not valid[i, b]:
                        continue
                    k = self.FRAME - lengths[i, b]
                    out[i, b, :, : self.FRAME - k] = host[i - r0, b][:, k:]
        return out, lengths


class BatchedSilkDecoder:
    """Lockstep multi-stream SILK-voice decoder.

    One native batch call per round (silk_parse.cpp
    skt_silk_decode_many: range decode + LTP/LPC synthesis for all B
    lanes) followed by per-lane oracle-matched resampling to 48 kHz
    on the host.  The LP layer is per-sample sequential IIR work that
    runs on the host here; batching amortizes
    the per-packet Python overhead that dominated per-stream replay.

    Serves 20 ms code-0 SILK packets at a constant per-lane bandwidth
    (the shape of real voice streams); bandwidth switches, multi-frame
    packets and hybrid/CELT modes are the caller's reroute cases.

    Reference role: soundkit-opus/src/lib.rs per-pipeline decode.
    """

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2):
        from soundkit_tpu.codecs.silk_native import NativeSilkBatch

        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._batch = NativeSilkBatch(num_streams, channels)
        # per lane: queued (frame_bytes, coded_channels) + fixed bw
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self.bw = [None] * num_streams
        self._resamp = [None] * num_streams
        self._skip = [0] * num_streams
        self._gain = [1.0] * num_streams

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        self._skip[b] = pre_skip
        self._gain[b] = (10.0 ** (gain_q8 / (20.0 * 256.0))
                        if gain_q8 else 1.0)

    def reset_lane(self, b: int) -> None:
        self._batch.reset_lane(b)
        self._packets[b] = []
        self.bw[b] = None
        self._resamp[b] = None
        self._skip[b] = 0
        self._gain[b] = 1.0

    def lane_ready(self, b: int) -> int:
        return len(self._packets[b])

    def push_packet(self, b: int, frame: bytes, bandwidth: int,
                    coded: int) -> None:
        """Queue one SILK frame payload (no TOC).  The caller
        validates mode/duration/framing; the first packet pins the
        lane's bandwidth."""
        if self.bw[b] is None:
            self.bw[b] = bandwidth
            rate = (8000, 12000, 16000)[bandwidth]
            from soundkit_tpu.utils.swr import SilkResampler

            self._resamp[b] = SilkResampler(rate, bandwidth, self.C)
        self._packets[b].append((frame, coded))

    def decode_ready(self, max_packets: Optional[int] = None):
        """Decode lockstep rounds.  Returns (pcm [rounds, B, C, 960]
        host f32 with valid samples at the END of each slot, lengths
        [rounds, B] i32)."""
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        pcm = np.zeros((n, self.B, self.C, self.FRAME), np.float32)
        lengths = np.zeros((n, self.B), np.int32)
        for i in range(n):
            frames = [b""] * self.B
            bws = np.zeros(self.B, np.int32)
            coded = np.ones(self.B, np.int32)
            valid = np.zeros(self.B, np.uint8)
            for b in range(self.B):
                if not self._packets[b]:
                    continue
                frames[b], coded[b] = self._packets[b].pop(0)
                bws[b] = self.bw[b]
                valid[b] = 1
            out16, nsamp, _info = self._batch.decode_many(
                frames, bws, coded, [20] * self.B, valid)
            for b in range(self.B):
                if not valid[b] or nsamp[b] < 0:
                    continue
                up = out16[b, : nsamp[b]]
                out48 = self._resamp[b].process(up, self.FRAME)
                if self._gain[b] != 1.0:
                    out48 = out48 * np.float32(self._gain[b])
                m = out48.shape[0]
                k = min(self._skip[b], m)
                self._skip[b] -= k
                m -= k
                if m > 0:
                    pcm[i, b, :, self.FRAME - m:] = out48[k:].T
                lengths[i, b] = m
        return pcm, lengths


class BatchedSilkDeviceDecoder:
    """Lockstep multi-stream SILK-voice decoder, synthesis on device.

    Round-4 split of :class:`BatchedSilkDecoder` (VERDICT #4): the
    native walk (silk_parse.cpp ``skt_silk_parse_many``) range-decodes
    every lane's frame and exports the synthesis inputs; the
    per-sample LTP/LPC recursion, stereo unmix and oracle-matched
    48 kHz resample run as ONE jitted step over ``[B, 2, ...]`` lanes
    with carried device state (ops/silk_batch.py) — host output
    agrees with the host engine to ~110 dB (f32 serving) and to the
    f32 resampler's own arithmetic noise in f64
    (tests/test_silk_device.py).

    Serves 20 ms single-frame SILK packets (mono or stereo coding may
    vary per packet; midonly handled in-lane) at a constant per-lane
    bandwidth.  Bandwidth switches / multi-frame packets remain the
    caller's reroute cases.

    Slot convention: every decoded round yields one 960-sample slot
    per lane with valid samples at the END; a lane's FIRST slot has
    ``960 - lead`` valid samples, where ``lead`` is the bandwidth's
    stream-start resampler offset (silk_batch.lead_invalid — NB 23,
    MB/WB 0).  Lengths are computed host-side (no device sync).

    Reference role: soundkit-opus/src/lib.rs per-pipeline decode.
    """

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2):
        from soundkit_tpu.codecs.silk_native import NativeSilkBatch
        from soundkit_tpu.ops import silk_batch as _sb

        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._sb = _sb
        self._batch = NativeSilkBatch(num_streams, channels)
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self.bw = [None] * num_streams
        self._fresh = np.ones(num_streams, bool)
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float32)
        self._state = {}  # bw -> (out_hist, lpch_tail, rs_tail) device

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        self._skip[b] = pre_skip
        self._gain[b] = np.float32(
            10.0 ** (gain_q8 / (20.0 * 256.0)) if gain_q8 else 1.0)

    def reset_lane(self, b: int) -> None:
        self._batch.reset_lane(b)
        self._packets[b] = []
        self.bw[b] = None
        self._fresh[b] = True  # the step zeroes this lane's state
        self._skip[b] = 0
        self._gain[b] = np.float32(1.0)

    def lane_ready(self, b: int) -> int:
        return len(self._packets[b])

    def push_packet(self, b: int, frame: bytes, bandwidth: int,
                    coded: int) -> None:
        """Queue one 20 ms SILK frame payload (no TOC); the first
        packet pins the lane's bandwidth."""
        if self.bw[b] is None:
            self.bw[b] = bandwidth
        self._packets[b].append((frame, coded))

    def _group_state(self, bw: int):
        if bw not in self._state:
            import jax.numpy as jnp

            self._state[bw] = tuple(
                jnp.asarray(s)
                for s in self._sb.init_state(self.B, bw, np.float32))
        return self._state[bw]

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep rounds.  Returns (pcm [rounds, B, C, 960]
        with valid samples at the END of each slot — a device f32
        array when ``device_out``, host f32 otherwise — and lengths
        [rounds, B] i32)."""
        import jax.numpy as jnp

        sb = self._sb
        B, C = self.B, self.C
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        lengths = np.zeros((n, B), np.int32)
        rounds = []
        for i in range(n):
            frames = [b""] * B
            bws = np.zeros(B, np.int32)
            coded = np.ones(B, np.int32)
            valid = np.zeros(B, np.uint8)
            for b in range(B):
                if not self._packets[b]:
                    continue
                frames[b], coded[b] = self._packets[b].pop(0)
                bws[b] = self.bw[b]
                valid[b] = 1
            p = self._batch.parse_many(frames, bws, coded,
                                       [20] * B, valid)
            ok = valid.astype(bool) & (p["n"] > 0)
            y_total = None
            for bw in sorted({int(b_) for b_ in bws[ok]}):
                g = ok & (bws == bw)
                state = self._group_state(bw)
                fresh = (self._fresh & g).astype(np.float32)
                f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
                y, *state = sb.silk_round(
                    bw, C == 2,
                    f32(p["exc"]), f32(p["gains"]), f32(p["coef"]),
                    np.ascontiguousarray(p["flags"][:, 7:9]),
                    np.ascontiguousarray(p["flags"][:, 5:7]),
                    p["lags"], f32(p["ltp"]), f32(p["ltpscale"]),
                    np.ascontiguousarray(p["flags"][:, 9:11]),
                    (p["flags"][:, 2] == 2).astype(np.int32),
                    np.ascontiguousarray(p["flags"][:, 4]),
                    f32(p["stereo_w"]), self._gain, g, fresh,
                    *state)
                self._state[bw] = tuple(state)
                y_total = y if y_total is None else y_total + y
            if y_total is None:
                y_total = jnp.zeros((B, 2, self.FRAME), jnp.float32)
            rounds.append(y_total[:, :C] if C < 2 else y_total)
            # host-side length bookkeeping: first slot is short by the
            # bandwidth's stream-start offset, then pre-skip consumes
            for b in range(B):
                if not ok[b]:
                    continue
                m = self.FRAME
                if self._fresh[b]:
                    m -= sb.lead_invalid(int(bws[b]))
                    self._fresh[b] = False
                k = min(self._skip[b], m)
                self._skip[b] -= k
                lengths[i, b] = m - k
        if not rounds:
            shape = (0, B, C, self.FRAME)
            return (jnp.zeros(shape, jnp.float32) if device_out
                    else np.zeros(shape, np.float32)), lengths
        pcm = jnp.stack(rounds)
        if device_out:
            return pcm, lengths
        return np.asarray(pcm), lengths


class BatchedHybridDecoder:
    """Lockstep multi-stream hybrid-Opus decoder, both halves on device.

    A hybrid packet codes SILK-WB (low band) and CELT from start band
    17 (high band) on ONE shared range coder (opus_core.py
    _decode_hybrid_frame).  Per round: the native SILK walk
    (skt_silk_parse_many, forced WB) exports the synthesis inputs plus
    the final coder state; the native CELT walk continues from that
    state (skt_celt_parse_many_cont, start band 17) and exports
    denormalized spectra; the device runs the SILK LTP/LPC scan +
    48 kHz resample (ops/silk_batch.py) and the CELT synthesis
    (ops/celt_batch.py) and sums them — WB slots align sample-exact
    (lead_invalid = 0).

    Packets carrying hybrid mode-transition redundancy are flagged by
    the native walk (red=1): real encoders attach redundancy only to
    mode-transition packets, which the fleet already reroutes at push
    (kind mismatch), so in-lane this only fires when a stream STARTS
    on a transition packet — the lane freezes (length 0) and the next
    push raises OpusLaneUnsupported so the standard byte-replay
    reroute serves the stream.

    Reference role: soundkit-opus/src/lib.rs per-pipeline decode.
    """

    FRAME = 960

    def __init__(self, num_streams: int, channels: int = 2):
        from soundkit_tpu.codecs.celt_native import NativeCeltBatch
        from soundkit_tpu.codecs.opus_celt import tables as celt_tables
        from soundkit_tpu.codecs.silk_native import NativeSilkBatch
        from soundkit_tpu.ops import silk_batch as _sb
        from soundkit_tpu.ops.celt_batch import HIST

        self.B = num_streams
        self.C = channels
        self.sample_rate = 48000
        self._sb = _sb
        self._silk = NativeSilkBatch(num_streams, channels)
        self._celt = NativeCeltBatch(num_streams, channels)
        self._band_end = celt_tables()["celt_band_end"].astype(int)
        self._hist_len = HIST
        self._packets: List[List[tuple]] = [[] for _ in range(num_streams)]
        self._fresh = np.ones(num_streams, bool)
        self._skip = [0] * num_streams
        self._gain = np.ones(num_streams, np.float32)
        self._error: List[Optional[str]] = [None] * num_streams
        self._silk_state = None  # (out_hist, lpch_tail, rs_tail), WB
        self._celt_state = None  # (ola, hist, emph) device f32

    def configure_lane(self, b: int, pre_skip: int = 0,
                       gain_q8: int = 0) -> None:
        self._skip[b] = pre_skip
        self._gain[b] = np.float32(
            10.0 ** (gain_q8 / (20.0 * 256.0)) if gain_q8 else 1.0)

    def reset_lane(self, b: int) -> None:
        self._silk.reset_lane(b)
        self._celt.reset_lane(b)
        self._packets[b] = []
        self._fresh[b] = True  # steps zero this lane's device state
        self._skip[b] = 0
        self._gain[b] = np.float32(1.0)
        self._error[b] = None

    def lane_error(self, b: int) -> Optional[str]:
        return self._error[b]

    def lane_ready(self, b: int) -> int:
        return len(self._packets[b])

    def push_packet(self, b: int, frame: bytes, bandwidth: int,
                    coded: int) -> None:
        """Queue one 20 ms hybrid frame payload (no TOC); bandwidth is
        the TOC index (3 = SWB, 4 = FB) driving the CELT band end."""
        self._packets[b].append(
            (frame, int(self._band_end[bandwidth]), coded))

    def _states(self):
        import jax.numpy as jnp

        if self._silk_state is None:
            self._silk_state = tuple(
                jnp.asarray(s)
                for s in self._sb.init_state(self.B, 2, np.float32))
        if self._celt_state is None:
            self._celt_state = (
                jnp.zeros((self.B, self.C, 120), jnp.float32),
                jnp.zeros((self.B, self.C, self._hist_len), jnp.float32),
                jnp.zeros((self.B, self.C), jnp.float32),
            )
        return self._silk_state, self._celt_state

    def _wire32_from_wire16(self, wire16, exc_f64):
        """Overflow fallback: rebuild the f32-excitation wire from
        the already-walked packed wire plus the native f64 excitation
        export.  NO re-walk: SILK parameters are delta-coded across
        frames, so walking the stateful handles twice would corrupt
        every later frame (caught by
        test_hybrid_exc_overflow_fallback_matches_packed_path)."""
        R, B, C = ROUNDS_PER_CALL, self.B, self.C
        _, total = _hybrid_wire_layout(R, B, C, False)
        wire = np.empty(total, np.uint8)
        v16 = _wire_views(wire16, R, B, C, True)
        v32 = _wire_views(wire, R, B, C, False)
        for k, dst in v32.items():
            if k == "exc":
                np.copyto(dst, exc_f64, casting="unsafe")
            else:
                dst[...] = v16[k]
        return wire, _hybrid_chunk_fn(R, B, C, False)

    def decode_ready(self, max_packets: Optional[int] = None,
                     device_out: bool = False):
        """Decode lockstep rounds.  Returns (pcm [rounds, B, C, 960]
        with valid samples at the END of each slot — device f32 when
        ``device_out``, host f32 otherwise — and lengths [rounds, B]).

        Round-5 shape (r4 VERDICT next #4): per chunk of
        ROUNDS_PER_CALL rounds, ONE fused native call walks both
        halves of every packet (hybrid_glue.cpp chains the SILK
        parse-export and the CELT continuation), ONE jitted lax.scan
        runs all SILK synthesis rounds, and ONE _celt_multi_step scan
        runs the CELT half — the round-4 path paid two native calls,
        two dispatches and fresh marshalling per ROUND.  All planes
        of a chunk ship in ONE packed uint8 wire
        (``_hybrid_wire_layout``, written in native code by
        ``hybrid_parse_rounds_packed``) consumed by ONE fused
        dispatch (``_hybrid_chunk_fn``) instead of ~20 per-plane
        transfers per chunk."""
        import jax.numpy as jnp

        from soundkit_tpu.utils.wire import to_device_chunked

        B, C = self.B, self.C
        counts = [len(p) for p in self._packets]
        n = max(counts) if counts else 0
        if max_packets is not None:
            n = min(n, max_packets)
        if n == 0:
            shape = (0, B, C, self.FRAME)
            return (jnp.zeros(shape, jnp.float32) if device_out
                    else np.zeros(shape, np.float32)), np.zeros(
                        (0, B), np.int32)
        R = ROUNDS_PER_CALL
        n_pad = (n + R - 1) // R * R
        # drain the queues into per-lane packed byte runs
        plens = np.zeros((B, n_pad), np.int32)
        ends = np.zeros((B, n_pad), np.int32)
        codedm = np.ones((B, n_pad), np.int32)
        base = np.zeros(B, np.int64)
        parts = []
        pos = 0
        for b in range(B):
            q = self._packets[b]
            k = min(len(q), n)
            if k == 0:
                continue
            take = q[:k]
            del q[:k]
            if self._error[b]:
                continue  # frozen lane: drop its queued packets
            plens[b, :k] = [len(t[0]) for t in take]
            ends[b, :k] = [t[1] for t in take]
            codedm[b, :k] = [t[2] for t in take]
            base[b] = pos
            lane_buf = b"".join(t[0] for t in take)
            parts.append(lane_buf)
            pos += len(lane_buf)
        buf = b"".join(parts)

        layout16, total16 = _hybrid_wire_layout(
            ROUNDS_PER_CALL, B, C, True)
        d16 = {name: off for name, off, _, _ in layout16}
        offs16 = np.array(
            [d16[k] for k in ("exc", "gains", "coef", "ltp",
                              "ltpscale", "stereo_w", "freq", "comb",
                              "lags", "hl", "vo", "cc", "um", "sr",
                              "sflag")], np.int64)
        fused16 = _hybrid_chunk_fn(ROUNDS_PER_CALL, B, C, True)
        # overflow side-channel, filled by the native walk only when a
        # pulse run exceeds int16 Q23 (reused across chunks: it is
        # consumed synchronously before the next walk)
        exc_f64 = np.empty((ROUNDS_PER_CALL, B, 2, 320), np.float64)
        (sst, cst) = self._states()
        ola, hist, emph = cst
        # a lane's packets occupy rounds 0..k-1, so a fresh lane's
        # first valid round is ROUND 0: zero its celt carry once
        has_pkts = plens[:, 0] > 0
        fresh_lanes = self._fresh & has_pkts
        if fresh_lanes.any():
            keep = jnp.asarray(~fresh_lanes, jnp.float32)
            ola = ola * keep[:, None, None]
            hist = hist * keep[:, None, None]
            emph = emph * keep[:, None]
        g_all = np.zeros((n_pad, B), bool)
        chunks = []
        cur = base.copy()
        err_mask = np.array([e is not None for e in self._error])
        for r0 in range(0, n_pad, R):
            pl = plens[:, r0:r0 + R].copy()
            pl[err_mask] = 0  # lanes errored in an earlier chunk
            cur0 = cur.copy()
            cur = cur + plens[:, r0:r0 + R].sum(axis=1)
            # fresh wire per chunk: device_put reads the host buffer
            # asynchronously, so a pooled buffer mutated for chunk
            # N+1 can corrupt chunk N's in-flight transfer (CLAUDE.md
            # "never pool wire buffers").  The native walk converts
            # every device-bound plane straight into it.
            wire = np.empty(total16, np.uint8)
            overflow, nn, ok, red = \
                self._silk.hybrid_parse_rounds_packed(
                    self._celt, buf, cur0, pl, ends[:, r0:r0 + R],
                    codedm[:, r0:r0 + R], wire, offs16, exc_f64,
                    bin_lo=_HYB_BIN_LO,
                    bin_len=_HYB_BIN_HI - _HYB_BIN_LO)
            valid_r = (pl > 0).T.copy()  # [R, B]
            bad = valid_r & (ok != 0)
            if bad.any():
                for r_, b_ in np.argwhere(bad):
                    bi = int(b_)
                    if self._error[bi] is None:
                        self._error[bi] = (
                            "hybrid transition redundancy"
                            if red[r_, b_] else
                            "celt continuation parse failed "
                            f"({int(ok[r_, b_])})")
                    self._packets[bi] = []
                    valid_r[int(r_):, bi] = False
                    err_mask[bi] = True
            g = valid_r & (nn > 0)
            g_all[r0:r0 + R] = g
            if overflow:
                # a pulse run exceeded int16 Q23 (needs |pulses| >
                # 127 per coefficient): rebuild the f32 wire from
                # the walked planes + the native f64 excitation
                wire, fused = self._wire32_from_wire16(wire, exc_f64)
                views = _wire_views(wire, ROUNDS_PER_CALL, B, C,
                                    False)
            else:
                fused = fused16
                views = _wire_views(wire, ROUNDS_PER_CALL, B, C,
                                    True)
            np.copyto(views["valid"], g, casting="unsafe")
            views["gain48"][:] = self._gain
            views["fresh"][:] = 0.0
            if r0 == 0:
                views["fresh"][0] = fresh_lanes.astype(np.float32)
            pcm, *st = fused(to_device_chunked(wire), *sst,
                             ola, hist, emph)
            sst = list(st[:3])
            ola, hist, emph = st[3:]
            chunks.append(pcm)
        self._silk_state = tuple(sst)
        self._celt_state = (ola, hist, emph)
        self._fresh[has_pkts] = False
        # vectorised length/preskip bookkeeping (lead_invalid(WB)=0)
        vn = g_all[:n].astype(np.int64)
        cap = vn * self.FRAME
        cum = np.cumsum(cap, axis=0)
        skip0 = np.array(self._skip, np.int64)
        consumed = np.clip(skip0[None, :] - (cum - cap), 0, cap)
        lengths = (cap - consumed).astype(np.int32)
        self._skip = list(np.maximum(skip0 - cum[-1], 0))
        pcm = jnp.concatenate(chunks, axis=0)[:n]
        if device_out:
            return pcm, lengths
        return np.asarray(pcm), lengths
