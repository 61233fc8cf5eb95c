"""Flagship model: batched multi-stream AAC-LC decoder.

Replaces the reference's thread-per-pipeline design (SURVEY.md §2.5)
with stream-batch data parallelism: N concurrent ADTS streams are
host-parsed into fixed-shape frame batches and decoded by ONE jitted
device step (``ops.aac_batch.aac_decode_frame_device``) carrying
per-stream overlap-add state.  The model runs on one device; the
``streams`` mesh (parallel/mesh.py) is exercised only by step-level
tests.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.aac_lc import AacLcDecoder, AdtsStream
from soundkit_tpu.ops import aac_batch as ab


@functools.lru_cache(maxsize=1)
def _aac_steps():
    import jax

    return (jax.jit(ab.aac_decode_frame_device),
            jax.jit(ab.aac_decode_frame_device_compact_packed),
            jax.jit(ab.aac_decode_frame_device_v3_packed),
            jax.jit(ab.aac_decode_frame_device_v4_packed,
                    static_argnums=(3,)))


class BatchedAacLcDecoder:
    """Decode N parallel ADTS streams in lockstep frame batches.

    Parses with the C++ host parser (codecs.aac_lc_native); a native
    library that fails to build or load raises.  ``use_native=False``
    selects the Python syntax layer and the full wire (tests only).
    ``wire_counts`` counts the batches each wire generation carried.
    """

    def __init__(self, num_streams: int, channels: int = 2,
                 use_native: bool = True):
        self.B = num_streams
        self.C = channels
        self._streams = [AdtsStream() for _ in range(num_streams)]
        self._queues: List[List[bytes]] = [[] for _ in range(num_streams)]
        saved, prev_shape = ab.init_state(num_streams, channels)
        self._saved = saved
        self._prev_shape = prev_shape
        # process-wide jit wrappers: per-instance jax.jit objects made
        # every fleet/model construction re-trace (and re-compile) the
        # big v4 entropy program on each serving pass
        (self._step, self._step_packed, self._step_v3,
         self._step_v4) = _aac_steps()
        self._native = {}  # sr_index -> NativeAacParser (mixed-rate groups)
        self._native_cls = None
        if use_native:
            from soundkit_tpu.codecs.aac_lc_native import NativeAacParser
            from soundkit_tpu.native import loader

            loader.load()
            self._native_cls = NativeAacParser
        self.wire_counts = dict.fromkeys(("v4", "v3", "compact", "full"), 0)

    def push(self, stream_idx: int, data: bytes) -> None:
        self._queues[stream_idx].extend(self._streams[stream_idx].push(data))

    @property
    def ready_frames(self) -> int:
        """Frame batches decodable right now (min queue depth)."""
        return min(len(q) for q in self._queues)

    def lane_ready(self, b: int) -> int:
        return len(self._queues[b])

    def lane_sample_rate(self, b: int) -> Optional[int]:
        """Sample rate of lane ``b``'s stream (None until its first
        ADTS header parses). Lanes in one group may differ — each is
        parsed with its own rate's band tables."""
        from soundkit_tpu.codecs.aac_lc import SAMPLE_RATES

        sr = self._streams[b].sr_index
        return SAMPLE_RATES[sr] if sr is not None else None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b`` for a new stream: fresh parser + queue and
        zeroed device carry (overlap/window state), so no audio bleeds
        from the previous occupant."""
        import jax.numpy as jnp

        self._streams[b] = AdtsStream()
        self._queues[b] = []
        self._saved = jnp.asarray(self._saved).at[b].set(0.0)
        self._prev_shape = jnp.asarray(self._prev_shape).at[b].set(0)

    def decode_ready(
        self, max_frames: Optional[int] = None, device_out: bool = False
    ):
        """Decode up to max_frames lockstep batches (bounded by the
        least-ready lane; :meth:`decode_batches` for ragged fleets).

        Returns [frames, B, C, 1024] f32.  Streams with empty queues
        decode silence for that batch (state frozen via chan_valid).
        ``device_out=True`` returns a device array without readback —
        the right choice when a downstream device stage consumes the
        PCM or the host link is thin (see models/mp3_batch_model.py).
        """
        n = self.ready_frames if max_frames is None else min(self.ready_frames, max_frames)
        return self.decode_batches(n, device_out=device_out)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode exactly ``n`` lockstep batches; empty lanes decode as
        silence with frozen state.

        Hot path: packed v4 wire (raw AUs + section program; the
        spectral Huffman decode runs ON DEVICE via the ops.aac_entropy
        interpreter). Falls back to the v3 wire for mixed-rate batches
        or content the raw wire cannot express (pulses, oversized
        AUs/run tables), then compact, then the full wire."""
        import jax.numpy as jnp

        outs = []
        C = self.C
        for _ in range(n):
            aus: List[Optional[bytes]] = [
                q.pop(0) if q else None for q in self._queues
            ]
            v4 = self._try_v4(aus)
            if v4 is not None:
                buf4, max_steps = v4
                pcm, self._saved, self._prev_shape = self._step_v4(
                    jnp.asarray(buf4), self._prev_shape, self._saved, max_steps
                )
                outs.append(pcm)
                self.wire_counts["v4"] += 1
                continue
            buf3 = self._try_v3(aus)
            if buf3 is not None:
                pcm, self._saved, self._prev_shape = self._step_v3(
                    buf3, self._prev_shape, self._saved
                )
                outs.append(pcm)
                self.wire_counts["v3"] += 1
                continue
            buf = self._try_packed(aus)
            if buf is not None:
                pcm, self._saved, self._prev_shape = self._step_packed(
                    jnp.asarray(buf), self._prev_shape, self._saved
                )
                self.wire_counts["compact"] += 1
            else:
                self.wire_counts["full"] += 1
                fb = self._frame_batch_full(aus)
                # the native parser emits C=2 wire arrays; slice to the
                # model's channel count so the carried state shapes
                # match (a mono model at B=1 used to broadcast here)
                pcm, self._saved, self._prev_shape = self._step(
                    jnp.asarray(fb.quant[:, :C]), jnp.asarray(fb.scale[:, :C]),
                    jnp.asarray(fb.ms_mask), jnp.asarray(fb.int_factor),
                    jnp.asarray(fb.perm[:, :C]), jnp.asarray(fb.filt_id[:, :C]),
                    jnp.asarray(fb.lpc[:, :C]), jnp.asarray(fb.seq[:, :C]),
                    jnp.asarray(fb.shape[:, :C]), self._prev_shape,
                    jnp.asarray(fb.chan_valid[:, :C]), self._saved,
                )
            outs.append(pcm)
        if not outs:
            empty = np.zeros((0, self.B, self.C, 1024), dtype=np.float32)
            return jnp.asarray(empty) if device_out else empty
        # accumulate device handles (rounds dispatch async, no per-
        # round sync) and fetch ONCE in sub-cliff chunks on the host
        # path: a per-round np.asarray cost a ~20 ms round-trip each
        stacked = jnp.stack(outs)
        if device_out:
            return stacked
        from soundkit_tpu.utils.wire import from_device_chunked

        return from_device_chunked(stacked)

    def _lane_parsers(self, aus):
        """Ensure a native parser exists per sr_index present; returns
        the per-lane sr list (None entries = rate not yet known)."""
        lane_sr = [s.sr_index for s in self._streams]
        need = {
            lane_sr[i]
            for i, au in enumerate(aus)
            if au is not None and lane_sr[i] is not None
        }
        for sr in need - self._native.keys():
            self._native[sr] = self._native_cls(sr)
        return lane_sr

    def _try_v4(self, aus):
        """Packed v4 wire (device entropy decode) for this batch, or
        None to fall back: needs the native parser, a single sample
        rate across active lanes, and no pulse/oversize content."""
        if self._native_cls is None:
            return None
        lane_sr = self._lane_parsers(aus)
        srs = {
            lane_sr[i]
            for i, au in enumerate(aus)
            if au is not None and lane_sr[i] is not None
        }
        if len(srs) != 1:
            return None
        from soundkit_tpu.codecs.aac_lc_native import prepare_v4_batch_packed

        buf, max_steps, overflow = prepare_v4_batch_packed(
            self._native[srs.pop()], aus
        )
        if overflow:
            return None
        # sticky power-of-two scan length: the static max_steps arg
        # keys the jit cache, so per-batch values would retrace every
        # new peak; growing geometrically and never shrinking bounds
        # lifetime compiles at ~log2(peak) and makes the steady-state
        # serving loop retrace-free (test_no_recompilation)
        steps = 256
        while steps < max_steps:
            steps *= 2
        self._v4_steps = max(steps, getattr(self, "_v4_steps", 0))
        return buf, self._v4_steps

    def _try_v3(self, aus):
        """Packed v3 wire for this batch, or None to fall back (no
        native parser, or a lane overflowed the i8+escape / run-table
        budgets)."""
        if self._native_cls is None:
            return None
        from soundkit_tpu.codecs.aac_lc_native import (
            prepare_v3_batch_packed_grouped,
        )

        lane_sr = self._lane_parsers(aus)
        buf, overflow = prepare_v3_batch_packed_grouped(
            self._native, lane_sr, aus
        )
        return None if overflow else buf

    def _try_packed(self, aus):
        """Packed compact wire for this batch, or None to fall back
        (no native parser, or a lane's quant overflowed int16)."""
        if self._native_cls is None:
            return None
        from soundkit_tpu.codecs.aac_lc_native import (
            prepare_compact_batch_packed_grouped,
        )

        lane_sr = self._lane_parsers(aus)
        buf, overflow = prepare_compact_batch_packed_grouped(
            self._native, lane_sr, aus
        )
        return None if overflow else buf

    def _frame_batch_full(self, aus):
        if self._native_cls is not None:
            from soundkit_tpu.codecs.aac_lc_native import (
                prepare_frame_batch_grouped,
            )

            lane_sr = self._lane_parsers(aus)
            if any(sr is not None for sr in lane_sr):
                return prepare_frame_batch_grouped(self._native, lane_sr, aus)
        frames = []
        for i, au in enumerate(aus):
            dec = self._streams[i].decoder
            frames.append(dec.decode_au(au) if (au is not None and dec) else None)
        return ab.prepare_frame_batch(frames, self.C)
