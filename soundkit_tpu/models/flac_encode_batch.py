"""Batched FLAC stream encoder: device analysis, host entropy pack.

The encode-direction sibling of the batched decode models: B lanes of
PCM move through ONE jitted analysis step per 4096-sample block
(ops/flac_enc_batch.flac_analyze_device — stereo mode search, fixed/
LPC-8 selection, exact integer residuals), and the host performs only
the Rice partition search + bit packing per lane via the owned frame
writer (codecs/flac_encode.py).  Each lane yields an independent,
fully standard .flac stream (STREAMINFO + MD5), bit-exact through the
framework's own decoder and the libavcodec oracle.

No reference analog exists (frame_codec.rs:42-278 encodes one stream
at a time on one core); this is the device-batched shape of the same
capability: lanes are data-parallel, the analysis is a pure map with
no sequential scan, so it shards over the stream-batch mesh axis like
every other batched model.

Ragged lanes: a lane with less than a full block pending simply sits
out the step (its `lane_valid` is masked off) and catches up when fed;
`finish(lane)` flushes the partial tail through the host planner.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.flac_encode import (
    BitWriter,
    FlacFrameEncoder,
    _SubframePlan,
)
from soundkit_tpu.ops.flac_enc_batch import LPC_PRECISION

# candidate stack order inside the device op
_SLOT_SOURCES = {1: (0, 1), 8: (0, 2), 9: (2, 1), 10: (3, 2), 0: (0, 0)}


class _Lane:
    def __init__(self, channels: int, bits: int):
        self.buf = np.zeros((channels, 0), np.int64)
        self.frames: List[bytes] = []
        self.md5 = hashlib.md5()
        self.total = 0
        self.min_fs: Optional[int] = None
        self.max_fs = 0
        self.finished = False


class BatchedFlacEncoder:
    """B-lane lockstep FLAC encoder (16/24-bit, mono/stereo).

    Frames are packed by the native bit-packer; a native library that
    fails to build or load raises.  ``use_native=False`` selects the
    per-frame Python writer (tests only)."""

    def __init__(self, n_lanes: int, sample_rate: int, channels: int,
                 bits_per_sample: int = 16, block_size: int = 4096,
                 use_native: bool = True):
        if channels not in (1, 2):
            raise ValueError("batched encoder: 1 or 2 channels")
        self.B = n_lanes
        self._lib = None
        if use_native:
            from soundkit_tpu.native.loader import load

            self._lib = load()
        self.channels = channels
        self.bits = bits_per_sample
        self.block_size = block_size
        self.sample_rate = sample_rate
        self._enc = [
            FlacFrameEncoder(sample_rate, channels, bits_per_sample)
            for _ in range(n_lanes)
        ]
        self._lanes = [_Lane(channels, bits_per_sample) for _ in range(n_lanes)]

    def push(self, lane: int, samples: np.ndarray) -> None:
        """[C, n] (or [n] for mono) ints at the declared bit depth."""
        x = np.atleast_2d(np.asarray(samples, np.int64))
        st = self._lanes[lane]
        st.buf = np.concatenate([st.buf, x], axis=1)
        # STREAMINFO MD5 runs here, once per pushed span: hashing at
        # block granularity cost ~0.45 s/pass at B=256 (3k transpose+
        # cast round-trips); per-chunk interleave concatenates to the
        # same stream-order digest.  Tail padding is hashed where the
        # padding is added (finish paths).
        self._md5_update(st, x)

    def _md5_update(self, st: _Lane, block: np.ndarray) -> None:
        inter = block.T.reshape(-1)
        if self.bits == 16:
            st.md5.update(inter.astype("<i2").tobytes())
        else:
            b = inter.astype("<i4").tobytes()
            arr = np.frombuffer(b, np.uint8).reshape(-1, 4)[:, :3]
            st.md5.update(arr.tobytes())

    def _record(self, st: _Lane, frame: bytes, n: int,
                block: np.ndarray, md5: bool = True) -> None:
        if md5:
            self._md5_update(st, block)
        st.total += n
        st.min_fs = len(frame) if st.min_fs is None else min(st.min_fs, len(frame))
        st.max_fs = max(st.max_fs, len(frame))
        st.frames.append(frame)

    def encode_step(self) -> int:
        """One lockstep round: every lane holding a full block encodes
        it through the shared device analysis.  Returns the number of
        lanes that produced a frame this step."""
        N = self.block_size
        jobs = []
        for i, st in enumerate(self._lanes):
            if st.buf.shape[1] >= N:
                jobs.append((i, st.buf[:, :N]))
                st.buf = st.buf[:, N:]
        return self._encode_jobs(jobs)

    def encode_pending(self) -> int:
        """Drain every full block of every lane through ONE device
        call (blocks are analysis-independent, so lanes AND rounds
        fold into the leading dim — the serving entry; `encode_step`
        remains the one-round lockstep form).  Returns the number of
        frames produced."""
        N = self.block_size
        jobs = []  # (lane, block_view) in per-lane FIFO order
        spans = []  # (job0, nb, [C, nb*N] lane view) for bulk fill
        for i, st in enumerate(self._lanes):
            nb = st.buf.shape[1] // N
            if nb:
                lanev = st.buf[:, : nb * N]
                spans.append((len(jobs), nb, lanev))
                for k in range(nb):
                    jobs.append((i, lanev[:, k * N : (k + 1) * N]))
                st.buf = st.buf[:, nb * N :]
        return self._encode_jobs(jobs, spans=spans)

    def _encode_jobs(self, jobs, N: Optional[int] = None,
                     spans=None) -> int:
        """Analyze + pack a job list in one device call + one native
        pack call.  The entry count pads to the next power of two so
        the number of compiled programs stays logarithmic in queue
        depth; with the native packer available the residual plane is
        neither materialized on device nor fetched, the block plane is
        built straight in the int16 wire dtype (<=16-bit streams; the
        packer's i16 entry reads it with no widening copy), and the
        per-block MD5 runs WHILE the device analyzes (only the ~50-byte
        plan rows synchronize).  ``N`` overrides the block size (tail
        frames; every job must hold exactly N samples)."""
        from soundkit_tpu.ops.flac_enc_batch import (
            flac_analyze_batch,
            flac_analyze_batch_dispatch,
            flac_plans_unpack,
        )

        if not jobs:
            return 0
        if N is None:
            N = self.block_size
        L = 1 << (len(jobs) - 1).bit_length()
        lib = self._lib
        dt = np.int16 if (lib is not None and self.bits <= 16) else np.int32
        x = np.zeros((L, 2, N), dt)
        if spans is not None:
            # bulk fill: one strided copy per lane instead of one per
            # block (the per-block loop cost ~0.3 s/pass at B=256)
            for j0, nb, lanev in spans:
                x[j0:j0 + nb, : self.channels] = (
                    lanev.reshape(self.channels, nb, N).swapaxes(0, 1))
        else:
            for j, (_, blk) in enumerate(jobs):
                x[j, : self.channels] = blk
        F = len(jobs)
        if lib is None:
            assign, kind, order, shift, qlp, res = flac_analyze_batch(
                x, N, self.bits, fetch_res=True
            )
            frames = self._pack_frames(
                [i for i, _ in jobs], [b for _, b in jobs], x[:F],
                assign[:F], kind[:F], order[:F], shift[:F], qlp[:F],
                res[:F],
            )
            for (i, blk), frame in zip(jobs, frames):
                self._record(self._lanes[i], frame, N, blk, md5=False)
            return F
        plans_dev = flac_analyze_batch_dispatch(x, N, self.bits)
        # (the STREAMINFO MD5 already ran at push time, per lane span)
        assign, kind, order, shift, qlp, _ = flac_plans_unpack(
            np.asarray(plans_dev))
        frames = self._pack_frames(
            [i for i, _ in jobs], [b for _, b in jobs], x[:F],
            assign[:F], kind[:F], order[:F], shift[:F], qlp[:F], None,
        )
        for (i, blk), frame in zip(jobs, frames):
            self._record(self._lanes[i], frame, N, blk, md5=False)
        return F

    def _pack_frames(self, lanes, blocks, blocks_i32, assign, kind,
                     order, shift, qlp, res) -> List[bytes]:
        """Pack F analyzed blocks into frames via the native bit-packer
        (native/src/flac_pack.cpp skt_flac_pack_frames) in one call;
        falls back to the per-frame Python writer when the host library
        is unavailable.  ``blocks_i32``/``res`` are [F, 2, N] int32
        (res rows aligned at [order:]); frame numbers advance per lane
        in job order (jobs are per-lane FIFO)."""
        F = len(lanes)
        N = blocks_i32.shape[-1]
        fno = np.zeros(F, np.int64)
        counts: dict = {}
        for j, i in enumerate(lanes):
            c = counts.get(i, self._enc[i]._frame_no)
            fno[j] = c
            counts[i] = c + 1
        lib = self._lib
        if lib is None:
            return [
                self._write_from_plan(
                    self._enc[i], blk, int(assign[j]), kind[j], order[j],
                    shift[j], qlp[j], res[j],
                )
                for j, (i, blk) in enumerate(zip(lanes, blocks))
            ]
        if res is None:
            res_ptr = None  # packer recomputes residuals from plans
        else:
            res_c = np.ascontiguousarray(res, np.int32)
            res_ptr = res_c.ctypes.data
        cap = 256 + N * 12
        out = np.zeros(F * cap, np.uint8)
        out_len = np.zeros(F, np.int64)
        pack = (lib.skt_flac_pack_frames16
                if blocks_i32.dtype == np.int16
                else lib.skt_flac_pack_frames)
        rc = pack(
            F, N, self.channels, self.sample_rate, self.bits,
            LPC_PRECISION, fno,
            np.ascontiguousarray(assign, np.int32),
            np.ascontiguousarray(kind, np.int32),
            np.ascontiguousarray(order, np.int32),
            np.ascontiguousarray(shift, np.int32),
            np.ascontiguousarray(qlp, np.int32), qlp.shape[-1],
            res_ptr,
            np.ascontiguousarray(blocks_i32),
            out, cap, out_len,
        )
        if rc != 0:
            raise RuntimeError(f"flac_pack overflow at frame {-rc - 1}")
        for i, c in counts.items():
            self._enc[i]._frame_no = c
        return [bytes(out[f * cap : f * cap + out_len[f]]) for f in range(F)]

    def _write_from_plan(self, enc: FlacFrameEncoder, block: np.ndarray,
                         assign: int, kind, order, shift, qlp,
                         res) -> bytes:
        C, n = block.shape
        if C == 1:
            assignment = 0
            chan_bits = (self.bits,)
            sources = (block[0].astype(np.int64),)
        else:
            L, R = block[0], block[1]
            cand = (L, R, L - R, (L + R) >> 1)
            s0, s1 = _SLOT_SOURCES[assign]
            sources = (cand[s0], cand[s1])
            assignment = assign
            chan_bits = (
                self.bits + (1 if assign == 9 else 0),
                self.bits + (1 if assign in (8, 10) else 0),
            )
        plans = []
        for slot, (src, bits) in enumerate(zip(sources, chan_bits)):
            o = int(order[slot])
            r = res[slot, o:n].astype(np.int64)
            if src[0] == src[-1] and np.all(src == src[0]):
                plans.append(_SubframePlan("constant", 0, None, bits,
                                           src[:1], 0))
                continue
            if kind[slot] == 1:
                plans.append(_SubframePlan(
                    "lpc", o, r, bits, src[:o], 0,
                    qlp=qlp[slot, :o].astype(np.int64),
                    shift=int(shift[slot]), precision=LPC_PRECISION,
                ))
            else:
                plans.append(_SubframePlan("fixed", o, r, bits, src[:o], 0))
        return enc.write_frame(n, assignment, plans)

    def finish_all(self) -> List[bytes]:
        """Finish every lane, batching the tail frames through the
        device analysis: one `_encode_jobs` call per DISTINCT tail
        length (in lockstep serving all lanes share one), versus
        ``finish``'s per-lane host analysis — the tail stage drops
        from B Levinson fits in Python to one jitted map.  Returns
        the B complete .flac streams in lane order."""
        self.encode_pending()
        groups: dict = {}
        for i, st in enumerate(self._lanes):
            if st.finished or st.buf.shape[1] == 0:
                continue
            groups.setdefault(max(st.buf.shape[1], 16), []).append(i)
        for n, lanes in sorted(groups.items()):
            jobs = []
            for i in lanes:
                st = self._lanes[i]
                blk = st.buf
                if blk.shape[1] < n:  # <16-sample tail: repeat-pad
                    pad = np.repeat(blk[:, -1:], n - blk.shape[1],
                                    axis=1)
                    self._md5_update(st, pad)  # decoder will emit it
                    blk = np.concatenate([blk, pad], axis=1)
                st.buf = st.buf[:, :0]
                jobs.append((i, blk))
            self._encode_jobs(jobs, N=n)
        return [self.finish(i) for i in range(self.B)]

    def finish(self, lane: int) -> bytes:
        """Flush the lane's tail through the host planner and return
        its complete .flac stream."""
        st = self._lanes[lane]
        # drain any full blocks still pending for this lane only
        while st.buf.shape[1] >= self.block_size:
            self.encode_step()
        if st.buf.shape[1] >= 16:
            block = st.buf
            st.buf = st.buf[:, :0]
            frame = self._enc[lane].encode_frame(block)
            self._record(st, frame, block.shape[1], block, md5=False)
        elif st.buf.shape[1] > 0:
            pad = 16 - st.buf.shape[1]
            ext = np.repeat(st.buf[:, -1:], pad, axis=1)
            self._md5_update(st, ext)  # decoder will emit the padding
            block = np.concatenate([st.buf, ext], axis=1)
            st.buf = st.buf[:, :0]
            frame = self._enc[lane].encode_frame(block)
            self._record(st, frame, block.shape[1], block, md5=False)
        st.finished = True

        info = BitWriter()
        info.write(self.block_size, 16)
        info.write(self.block_size, 16)
        info.write(st.min_fs or 0, 24)
        info.write(st.max_fs, 24)
        info.write(self.sample_rate, 20)
        info.write(self.channels - 1, 3)
        info.write(self.bits - 1, 5)
        info.write(st.total, 36)
        for b in st.md5.digest():
            info.write(b, 8)
        si = info.bytes()
        header = b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si
        return header + b"".join(st.frames)
