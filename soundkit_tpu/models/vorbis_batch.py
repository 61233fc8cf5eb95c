"""Batched multi-stream Ogg Vorbis decoder.

Stream-batch data parallelism over N concurrent Ogg Vorbis streams:
host entropy decode (codecs/vorbis_core.py) emits per-packet spectra;
ONE jitted device step (ops/vorbis_batch.py) runs IMDCT + window +
overlap-add for all lanes in lockstep, carrying per-lane lap state.
Replaces the reference's one-decoder-per-stream design
(soundkit-vorbis/src/lib.rs:289) the same way models/aac_lc_batch.py
replaces thread-per-pipeline.

All lanes must share the (blocksize0, blocksize1, channels) topology
(one compiled step per topology; mixed fleets use one model instance
per group, like the AAC model's per-sample-rate parser groups).
"""
from __future__ import annotations

import functools

from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.vorbis_core import VorbisSetup, cached_setup
from soundkit_tpu.demux.ogg import OggPacketizer
from soundkit_tpu.ops import vorbis_batch as vb


class TopologyMismatch(ValueError):
    """A lane's stream headers disagree with the model topology.

    Raised from ``push`` at header-parse time; callers that multiplex
    arbitrary streams (models/fleet.py) catch this, free the lane, and
    reroute the stream to a per-stream host decoder."""


class _Lane:
    def __init__(self) -> None:
        self.pkts = OggPacketizer()
        self.headers: List[bytes] = []
        self.setup: Optional[VorbisSetup] = None
        self.parser = None  # native C++ parse stage, or the setup itself
        self.queue: List = []  # decoded spectra
        self.primed = False


@functools.lru_cache(maxsize=8)
def _vorbis_multi_step(n0: int, n1: int):
    """Process-wide jitted multi-round synthesis per topology — a
    per-instance jax.jit re-traced the program on every fleet/model
    construction."""
    import jax

    def _multi(specs, n_flags, pfs, nfs, valids, primeds, cflags,
               state):
        from jax import lax

        def body(st, xs):
            sp, nfl, p_, n_, v_, pr, cf = xs
            out, _len, st2, _ = vb.vorbis_synth_step(
                sp, nfl, p_, n_, v_, pr, st, cf, n0=n0, n1=n1)
            return st2, out

        state, outs = lax.scan(
            body, state,
            (specs, n_flags, pfs, nfs, valids, primeds, cflags))
        return outs, state

    return jax.jit(_multi)


class BatchedVorbisDecoder:
    def __init__(self, num_streams: int):
        self.B = num_streams
        self._lanes = [_Lane() for _ in range(num_streams)]
        self._step = None
        self._topology = None  # (n0, n1, channels)
        self._state = None  # device [B, C, n1//2] lap carry
        self._cflag = None  # host [B] previous-block-size flags

    def push(self, stream_idx: int, data: bytes) -> None:
        lane = self._lanes[stream_idx]
        for packet, _g in lane.pkts.push(data):
            if lane.setup is None:
                lane.headers.append(packet)
                if len(lane.headers) == 3:
                    lane.setup = cached_setup(bytes(lane.headers[0]), bytes(lane.headers[2]))
                    topo = (
                        lane.setup.blocksize0,
                        lane.setup.blocksize1,
                        lane.setup.channels,
                    )
                    if self._topology is None:
                        self._topology = topo
                    if topo == self._topology:
                        # per-packet hot path: the C++ parse stage
                        # (native/src/vorbis_parse.cpp); floor-0
                        # streams, which it does not parse, keep the
                        # Python decoder
                        from soundkit_tpu.codecs.vorbis_native import (
                            NativeVorbisParser,
                            VorbisNativeUnsupported,
                        )

                        try:
                            lane.parser = NativeVorbisParser(lane.setup)
                        except VorbisNativeUnsupported:
                            lane.parser = lane.setup
                    elif topo != self._topology:
                        # leave the lane unconfigured so a later
                        # reset_lane/alloc starts clean
                        lane.setup = None
                        lane.headers = []
                        raise TopologyMismatch(
                            f"lane {stream_idx} topology {topo} != model "
                            f"topology {self._topology}"
                        )
                continue
            spec = lane.parser.decode_packet_spectrum(packet)
            if spec is not None:
                lane.queue.append(spec)

    @property
    def ready_frames(self) -> int:
        return min(len(lane.queue) for lane in self._lanes)

    def decode_batches(
        self, n_batches: int, device_out: bool = False
    ) -> List:
        """Decode ``n_batches`` lockstep packets.

        Default: per-lane host PCM arrays [C, samples] concatenated
        over the batches.  Lanes with empty queues decode nothing that
        step (state frozen).

        ``device_out=True`` skips the d2h PCM fetch entirely and
        returns ``(outs, lens)`` where ``outs`` is a list of
        ``n_batches`` device arrays [B, C, n1//2] and ``lens`` a host
        [n_batches, B] int array of valid lengths — for callers that
        keep post-processing on device (no fetch of a [1024, C, 1024]
        f32 buffer).

        The carry_flag (previous block size per lane) is pure host
        bookkeeping — new_flag = n_flag where a packet arrived — so it
        lives host-side; only the f32 lap carry stays on device.
        """
        import jax
        import jax.numpy as jnp

        from soundkit_tpu.utils.wire import from_device_chunked

        if self._topology is None:
            if device_out:
                return [], np.zeros((0, self.B), dtype=np.int32)
            return [np.zeros((0, 0)) for _ in range(self.B)]
        n0, n1, C = self._topology
        h1 = n1 // 2
        R = 8  # rounds per device call (fixed: one compiled program)
        if self._step is None:
            self._step = _vorbis_multi_step(n0, n1)
            carry, cflag = vb.init_state(self.B, C, n1)
            self._state = jnp.asarray(carry)
            self._cflag = cflag  # host-side, never round-tripped

        # host stage: parse/queue every round up front (each call has
        # a fixed dispatch cost, so R rounds batch through one jitted
        # scan; short tails pad with invalid rounds)
        n_pad = (n_batches + R - 1) // R * R
        spec = np.zeros((n_pad, self.B, C, h1), dtype=np.float32)
        n_flag = np.ones((n_pad, self.B), dtype=np.int32)
        pf = np.ones((n_pad, self.B), dtype=np.int32)
        nf = np.ones((n_pad, self.B), dtype=np.int32)
        valid = np.zeros((n_pad, self.B), dtype=bool)
        primed = np.zeros((n_pad, self.B), dtype=bool)
        cflag = np.zeros((n_pad, self.B), dtype=np.int32)
        len_np = np.zeros((n_batches, self.B), dtype=np.int32)
        for r in range(n_batches):
            cflag[r] = self._cflag
            for b, lane in enumerate(self._lanes):
                primed[r, b] = lane.primed
                if not lane.queue:
                    continue
                sdec = lane.queue.pop(0)
                valid[r, b] = True
                half = sdec.n // 2
                spec[r, b, :, :half] = sdec.spectrum.astype(np.float32)
                n_flag[r, b] = 1 if sdec.n == n1 else 0
                pf[r, b] = sdec.prev_flag
                nf[r, b] = sdec.next_flag
                if not lane.primed:
                    # prime: treat prev block as same-size (d = n/2)
                    cflag[r, b] = n_flag[r, b]
                    lane.primed = True
            # host mirror of the step's new_carry_flag
            self._cflag = np.where(
                valid[r], n_flag[r], cflag[r]).astype(np.int32)
            prev_n = np.where(cflag[r] == 1, n1, n0)
            cur_n = np.where(n_flag[r] == 1, n1, n0)
            len_np[r] = np.where(valid[r] & primed[r],
                                 prev_n // 4 + cur_n // 4, 0)

        outs = [[] for _ in range(self.B)]
        dev_outs: List = []
        host_chunks: List = []  # (r0, hi, device out) — fetched ONCE below
        for r0 in range(0, n_pad, R):
            out, self._state = self._step(
                jnp.asarray(spec[r0:r0 + R]),
                jnp.asarray(n_flag[r0:r0 + R]),
                jnp.asarray(pf[r0:r0 + R]),
                jnp.asarray(nf[r0:r0 + R]),
                jnp.asarray(valid[r0:r0 + R]),
                jnp.asarray(primed[r0:r0 + R]),
                jnp.asarray(cflag[r0:r0 + R]),
                self._state,
            )
            hi = min(r0 + R, n_batches)
            if device_out:
                for r in range(r0, hi):
                    dev_outs.append(out[r - r0])
                continue
            mx = int(len_np[r0:hi].max()) if hi > r0 else 0
            if mx == 0:
                continue
            # device-side trim only; every round dispatches async and
            # ONE chunked fetch happens after the loop (a per-chunk
            # fetch serialized host latency between dispatches)
            host_chunks.append((r0, hi, out[: hi - r0, ..., :mx]))
        for r0, hi, dev in host_chunks:
            out_np = from_device_chunked(dev)
            for r in range(r0, hi):
                for b in range(self.B):
                    if len_np[r, b] > 0:
                        outs[b].append(out_np[r - r0, b, :, : len_np[r, b]])
        if device_out:
            lens = (
                len_np
                if n_batches
                else np.zeros((0, self.B), dtype=np.int32)
            )
            return dev_outs, lens
        return [
            np.concatenate(o, axis=-1) if o else np.zeros((C, 0))
            for o in outs
        ]

    def decode_ready(self) -> List[np.ndarray]:
        return self.decode_batches(self.ready_frames)

    # -- fleet group interface (models/fleet.py) ---------------------------

    def lane_ready(self, b: int) -> int:
        return len(self._lanes[b].queue)

    def lane_configured(self, b: int) -> bool:
        """True once lane ``b``'s headers parsed and matched the model
        topology (past the point where TopologyMismatch can raise)."""
        return self._lanes[b].setup is not None

    def lane_sample_rate(self, b: int) -> Optional[int]:
        setup = self._lanes[b].setup
        return setup.sample_rate if setup else None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: fresh Ogg/header state and zeroed device
        lap carry, so no audio bleeds from the previous occupant.  The
        new stream must share the group topology (blocksizes/channels);
        a mismatch raises at header parse."""
        self._lanes[b] = _Lane()
        if self._state is not None:
            self._state = self._state.at[b].set(0.0)
            self._cflag[b] = 1
