"""Batched multi-stream MP3 decoder (second model family).

Mirrors ``BatchedAacLcDecoder``: N concurrent MP3 byte streams are
parsed by the C++ host layer (per-stream bit reservoir state) into
compact granule lanes (int16 quant + quarter-exponents) and decoded in
lockstep granule batches by one jitted device step
(``ops.mp3_batch.mp3_granule_device_compact``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.mp3_native import NativeMp3Parser
from soundkit_tpu.ops import mp3_batch as mb
import functools


@functools.lru_cache(maxsize=1)
def _mp3_steps():
    import jax

    return (jax.jit(mb.mp3_granule_device_compact),
            jax.jit(mb.mp3_granule_device_compact_packed),
            jax.jit(mb.mp3_granules_device_compact_multi))


class BatchedMp3Decoder:
    def __init__(self, num_streams: int, channels: int = 2):
        import ctypes

        import jax

        self.B = num_streams
        self.C = channels
        self._parsers = [NativeMp3Parser() for _ in range(num_streams)]
        self._lib = self._parsers[0]._lib
        self._handles = (ctypes.c_void_p * num_streams)(
            *[p._h for p in self._parsers]
        )
        self._counts = [0] * num_streams
        overlap, fifo = mb.init_state(num_streams, channels)
        self._overlap = overlap
        self._fifo = fifo
        # process-wide jit wrappers (per-instance ones re-traced on
        # every fleet construction)
        self._step, self._step_packed, self._multi_step = _mp3_steps()
        self.sample_rate: Optional[int] = None  # first rate seen (legacy)
        self._rates = np.zeros(num_streams, dtype=np.int32)  # per lane

    def _alloc_wire(self):
        # FRESH arrays per batch on purpose: jnp transfers may read the
        # host buffer asynchronously after the call returns, so a
        # rotating pool is a race (see CompactBatchWorkspace docstring
        # in codecs/aac_lc_native.py — observed live on this path)
        return (
            np.zeros((self.B, 2, 576), dtype=np.int16),   # quant
            np.zeros((self.B, 2, 576), dtype=np.int16),   # expq
            np.zeros((self.B, 2), dtype=np.int32),        # bt
            np.zeros((self.B, 2), dtype=np.uint8),        # mixed
            np.zeros((self.B, 2), dtype=np.int32),        # nal
            np.zeros(self.B, dtype=np.uint8),             # ms
            np.zeros((self.B, 2), dtype=np.uint8),        # valid
            np.zeros(self.B, dtype=np.int32),             # rate
        )

    def push(self, stream_idx: int, data: bytes) -> None:
        self._counts[stream_idx] = self._parsers[stream_idx].push(data)

    @property
    def ready_granules(self) -> int:
        return min(self._counts)

    def lane_ready(self, b: int) -> int:
        return self._counts[b]

    def lane_sample_rate(self, b: int) -> Optional[int]:
        """Sample rate of lane ``b``'s stream (None until its first
        frame pops). Mixed-rate groups decode correctly per lane; this
        surfaces each lane's true rate instead of the group's first."""
        r = int(self._rates[b])
        return r if r > 0 else None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: fresh C parser (reservoir/queue) and
        zeroed device carry (overlap + polyphase FIFO)."""
        import ctypes

        import jax.numpy as jnp

        self._parsers[b] = NativeMp3Parser()
        self._handles[b] = ctypes.c_void_p(self._parsers[b]._h)
        self._counts[b] = 0
        self._rates[b] = 0
        self._overlap = jnp.asarray(self._overlap).at[b].set(0.0)
        self._fifo = jnp.asarray(self._fifo).at[b].set(0.0)

    def _pop_batch(self):
        """ONE C call pops a granule from every stream's queue."""
        quant, expq, bt, mixed, nal, ms, valid, rate = self._alloc_wire()
        self._lib.skt_mp3_pop_batch(
            self._handles, self.B, quant.reshape(-1), expq.reshape(-1),
            bt.reshape(-1), mixed.reshape(-1), nal.reshape(-1),
            ms, valid.reshape(-1), rate,
        )
        self._note_rates(rate)
        return quant, expq, bt, mixed, nal, ms, valid

    def _pop_batch_packed(self):
        """One C pop into ONE packed uint8 wire buffer (one transfer).

        Freshly allocated per batch — never pooled (async transfers may
        read the host buffer after dispatch)."""
        layout, total = mb.mp3_wire_layout(self.B)
        buf = np.zeros(total, dtype=np.uint8)
        v = {
            name: buf[off : off + int(np.prod(shp)) * np.dtype(dt).itemsize]
            .view(dt)
            .reshape(-1)
            for name, off, dt, shp in layout
        }
        rate = np.zeros(self.B, dtype=np.int32)
        self._lib.skt_mp3_pop_batch(
            self._handles, self.B, v["quant"], v["expq"], v["bt"],
            v["mixed"], v["nal"], v["ms"], v["valid"], rate,
        )
        self._note_rates(rate)
        return buf, v["valid"].reshape(self.B, 2)

    def _note_rates(self, rate: np.ndarray) -> None:
        live = rate > 0
        self._rates[live] = rate[live]
        if self.sample_rate is None and live.any():
            self.sample_rate = int(rate[live][0])

    def decode_ready(
        self,
        max_granules: Optional[int] = None,
        device_out: bool = False,
    ):
        """Decode lockstep granule batches -> [granules, B, C, 576] f32.

        ``device_out=True`` returns a device array (no readback) — use
        when a downstream device stage (resampler, mixer, model)
        consumes the PCM and the device->host readback is not needed.
        """
        n = self.ready_granules
        if max_granules is not None:
            n = min(n, max_granules)
        return self.decode_batches(n, device_out=device_out)

    def decode_multi(self, n: int, device_out: bool = False):
        """Decode ``n`` lockstep granule batches with ONE device call
        (lax.scan over the granule axis).

        The per-granule loop pipelines host pops against async
        transfers, while this path serializes pop-all -> transfer-all
        -> scan.  Use it when dispatch latency dominates (small B) or
        when a single program per window is required.
        Compiles one program per distinct ``n``."""
        import jax
        import jax.numpy as jnp

        G = n
        quant = np.zeros((G, self.B, 2, 576), dtype=np.int16)
        expq = np.zeros((G, self.B, 2, 576), dtype=np.int16)
        bt = np.zeros((G, self.B, 2), dtype=np.int32)
        mixed = np.zeros((G, self.B, 2), dtype=np.uint8)
        nal = np.zeros((G, self.B, 2), dtype=np.int32)
        ms = np.zeros((G, self.B), dtype=np.uint8)
        valid = np.zeros((G, self.B, 2), dtype=np.uint8)
        rate = np.zeros(self.B, dtype=np.int32)
        for g in range(G):
            self._lib.skt_mp3_pop_batch(
                self._handles, self.B, quant[g].reshape(-1), expq[g].reshape(-1),
                bt[g].reshape(-1), mixed[g].reshape(-1), nal[g].reshape(-1),
                ms[g], valid[g].reshape(-1), rate,
            )
            self._note_rates(rate)
        for b in range(self.B):
            self._counts[b] -= int(valid[:, b].any(axis=1).sum())
        C = self.C
        pcm, self._overlap, self._fifo = self._multi_step(
            jnp.asarray(quant[:, :, :C]), jnp.asarray(expq[:, :, :C]),
            jnp.asarray(ms.astype(bool)), jnp.asarray(bt[:, :, :C]),
            jnp.asarray(mixed[:, :, :C].astype(bool)),
            jnp.asarray(nal[:, :, :C]),
            jnp.asarray(valid[:, :, :C].astype(bool)),
            self._overlap, self._fifo,
        )
        return pcm if device_out else np.asarray(pcm)

    def _pop_rounds(self, G: int):
        """ONE C call pops up to ``G`` granules from every lane into
        ``G`` packed wire rows (round-5 host diet: replaces G
        per-round ctypes calls + G fresh 1.2 MB numpy allocations).
        Returns the [G, stride] uint8 wire (fresh, never pooled — async
        transfers may read it late) and updates the per-lane
        counts/rates."""
        layout, stride = mb.mp3_wire_layout(self.B)
        offs = {name: off for name, off, _, _ in layout}
        wire = np.zeros((G, stride), dtype=np.uint8)
        rate = np.zeros(self.B, dtype=np.int32)
        popped = np.zeros(self.B, dtype=np.int32)
        self._lib.skt_mp3_pop_rounds(
            self._handles, self.B, G, wire.reshape(-1), stride,
            offs["bt"], offs["nal"], offs["quant"], offs["expq"],
            offs["mixed"], offs["ms"], offs["valid"], rate, popped,
        )
        self._note_rates(rate)
        for b in range(self.B):
            self._counts[b] -= int(popped[b])
        return wire

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode exactly ``n`` lockstep batches; lanes whose queue is
        empty decode as silence with frozen state."""
        import jax.numpy as jnp

        outs = []
        if n > 0:
            wire = self._pop_rounds(n)
        for g in range(n):
            # per-round dispatch over a contiguous wire row (the rows
            # are small; one big transfer would cross the h2d cliff)
            pcm, self._overlap, self._fifo = self._step_packed(
                jnp.asarray(wire[g]), self._overlap, self._fifo,
            )
            outs.append(pcm)
        if not outs:
            empty = np.zeros((0, self.B, self.C, 576), dtype=np.float32)
            return jnp.asarray(empty) if device_out else empty
        stacked = jnp.stack(outs)
        if device_out:
            return stacked
        from soundkit_tpu.utils.wire import from_device_chunked

        return from_device_chunked(stacked)
