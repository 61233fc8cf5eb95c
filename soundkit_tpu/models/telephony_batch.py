"""Batched multi-stream telephony decoder (G.711 / G.722 / G.726).

The stream-batch replacement for thread-per-pipeline on the telephony
formats (BASELINE config 1): N concurrent byte streams decode in one
jitted step per fixed-size chunk.  Unlike the lockstep AAC model,
telephony lanes are fully ragged: each step consumes up to
``chunk_codes`` codes per stream under a validity mask (the ADPCM
scans freeze masked lanes natively), so slow producers never stall the
batch.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from soundkit_tpu.codecs.g726 import G726Packing, G726Rate, unpack_codes
from soundkit_tpu.ops import adpcm, companding
from soundkit_tpu.ops import g722 as g722_ops

CODECS = (
    "g711_mulaw",
    "g711_alaw",
    "g722",
    "g726_16",
    "g726_24",
    "g726_32",
    "g726_40",
)


@functools.lru_cache(maxsize=32)
def _dec_step(codec: str, B: int, chunk: int):
    """Process-wide jitted decode step per (codec, shape) — a
    per-instance jax.jit re-traced the program on every fleet/model
    construction."""
    import jax

    off_counts = (B * chunk + 3) & ~3

    def unpack(buf):
        import jax.numpy as jnp
        from jax import lax

        raw = lax.slice(buf, (0,), (B * chunk,))
        codes = lax.bitcast_convert_type(raw, jnp.uint8)
        codes = codes.reshape(B, chunk).astype(jnp.int32)
        cr = lax.slice(buf, (off_counts,), (off_counts + 4 * B,))
        counts = lax.bitcast_convert_type(
            cr.reshape(B, 4), jnp.int32
        ).reshape(B)
        valid = (
            jnp.arange(chunk, dtype=jnp.int32)[None, :]
            < counts[:, None]
        )
        return codes, valid

    import jax.numpy as jnp

    if codec.startswith("g711"):
        is_alaw = codec.endswith("alaw")

        def step_g711(buf):
            codes, valid = unpack(buf)
            pcm = (companding.decode_alaw(codes) if is_alaw
                   else companding.decode_mulaw(codes))
            return jnp.where(valid, pcm, 0)

        return jax.jit(step_g711)
    if codec == "g722":

        def step_g722(buf, st):
            codes, valid = unpack(buf)
            return g722_ops.g722_decode_scan(codes, st, valid)

        return jax.jit(step_g722)
    bits = int(codec.split("_")[1]) // 8

    def step_g726(buf, st, _b=bits):
        codes, valid = unpack(buf)
        return adpcm.g726_decode_scan(codes, st, _b, valid)

    return jax.jit(step_g726)


class BatchedTelephonyDecoder:
    def __init__(self, codec: str, num_streams: int, chunk_codes: int = 2048):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
        self.codec = codec
        self.B = num_streams
        self.chunk = chunk_codes
        self._queues: List[bytearray] = [bytearray() for _ in range(num_streams)]
        self._g726_rate: Optional[G726Rate] = None

        # packed wire: [codes u8 B*chunk][counts i32 B] in ONE uint8
        # buffer (one transfer issue per step; int32 codes + bool mask
        # would be 5 bytes of h2d per 1-byte code).  The validity mask
        # is rebuilt on device from the per-lane code counts.
        self._off_counts = (num_streams * chunk_codes + 3) & ~3
        self._wire_total = self._off_counts + 4 * num_streams

        self._step = _dec_step(codec, num_streams, chunk_codes)
        if codec.startswith("g711"):
            self._state = None
            self.samples_per_code = 1
            self.sample_rate = 8000
        elif codec == "g722":
            self._state = g722_ops.g722_init_state(num_streams)
            self.samples_per_code = 2
            self.sample_rate = 16000
        else:
            bits = int(codec.split("_")[1]) // 8
            self._g726_rate = {2: G726Rate.RATE_16000, 3: G726Rate.RATE_24000,
                               4: G726Rate.RATE_32000, 5: G726Rate.RATE_40000}[bits]
            self._state = adpcm.g726_init_state(num_streams)
            self.samples_per_code = 1  # one code = one sample
            self.sample_rate = 8000

    def push(self, stream_idx: int, data: bytes) -> None:
        self._queues[stream_idx].extend(data)

    def decode_step(self, device_out: bool = False):
        """Decode up to chunk codes per stream.

        Returns (pcm [B, chunk*samples_per_code] i16, lengths [B]):
        lengths in produced samples per stream.  ``device_out=True``
        leaves the PCM on device for a downstream device consumer, with
        no d2h egress of the full PCM."""
        import jax.numpy as jnp

        # FRESH buffer per step (transfers may read the host buffer
        # asynchronously after dispatch; never pool wire buffers)
        buf = np.zeros(self._wire_total, dtype=np.uint8)
        codes = buf[: self.B * self.chunk].reshape(self.B, self.chunk)
        counts = buf[self._off_counts:].view("<i4")
        lens = np.zeros(self.B, dtype=np.int64)
        for i, q in enumerate(self._queues):
            n = self._prepare_lane(i, q, codes)
            counts[i] = n
            lens[i] = n * self.samples_per_code
        if self.codec.startswith("g711"):
            pcm = self._step(jnp.asarray(buf))
        else:
            pcm, self._state = self._step(jnp.asarray(buf), self._state)
        if device_out:
            return pcm, lens
        from soundkit_tpu.utils.wire import from_device_chunked

        return from_device_chunked(pcm), lens

    def _prepare_lane(self, i, q, codes) -> int:
        """Fill lane i's uint8 code row; returns the code count."""
        if self.codec.startswith("g711") or self.codec == "g722":
            n = min(len(q), self.chunk)
            codes[i, :n] = np.frombuffer(bytes(q[:n]), dtype=np.uint8)
            del q[:n]
            return n
        rate = self._g726_rate
        group = rate.bytes_per_group
        avail_groups = len(q) // group
        max_groups = self.chunk // rate.samples_per_byte_group
        g = min(avail_groups, max_groups)
        nbytes = g * group
        if g:
            cs = unpack_codes(bytes(q[:nbytes]), rate.bits_per_sample, G726Packing.LEFT)
            codes[i, : len(cs)] = cs
            del q[:nbytes]
            return len(cs)
        return 0


class TelephonyLaneGroup:
    """Fleet lane-group adapter over :class:`BatchedTelephonyDecoder`.

    The sixth batched fleet group (r4 VERDICT next #3): G.711/722/726
    streams are headerless, so they arrive via the fleet's
    EXPLICIT-KIND ingest (``fleet.push(sid, data, kind="g711_mulaw")``,
    the analog of ``spawn_g711(law, rate, channels)``,
    soundkit-decoder/src/lib.rs:616-654) instead of autodetect.  Lanes
    are fully ragged: ``lane_ready`` counts pending fixed-size decode
    rounds (``chunk`` codes each) and ``decode_batches`` stacks ``n``
    scan steps into one device-resident [n, B, 1, S] int16 batch —
    i16-native end to end, so the egress wire is half the f32 bytes.
    """

    def __init__(self, codec: str, capacity: int, chunk_codes: int = 2048):
        self.codec = codec
        self.B = capacity
        self._dec = BatchedTelephonyDecoder(codec, capacity, chunk_codes)

    # -- fleet group surface ------------------------------------------------

    def push(self, lane: int, data: bytes) -> None:
        self._dec.push(lane, data)

    def _pending_codes(self, lane: int) -> int:
        q = len(self._dec._queues[lane])
        rate = self._dec._g726_rate
        if rate is None:
            return q  # g711 / g722: one code per byte
        return (q // rate.bytes_per_group) * rate.samples_per_byte_group

    def lane_ready(self, lane: int) -> int:
        c = self._pending_codes(lane)
        return -(-c // self._dec.chunk) if c else 0

    def lane_sample_rate(self, lane: int) -> Optional[int]:
        return self._dec.sample_rate

    def reset_lane(self, lane: int) -> None:
        """Recycle one lane: empty queue + that lane's scan state row
        back to init (tiny host round-trip; the carried states are a
        few [B] int32 planes)."""
        self._dec._queues[lane] = bytearray()
        st = self._dec._state
        if st is None:
            return
        fresh = (g722_ops.g722_init_state(self.B)
                 if self.codec == "g722"
                 else adpcm.g726_init_state(self.B))
        rows = []
        for cur, f0 in zip(st, fresh):
            a = np.array(cur)
            a[lane] = np.asarray(f0)[lane]
            rows.append(a)
        self._dec._state = type(st)(*rows)

    def decode_batches(self, n: int, device_out: bool = False):
        """Run ``n`` ragged scan rounds; returns (pcm [n, B, 1, S]
        int16 — device array when ``device_out`` — and lengths
        [n, B] int64 of produced samples, valid at slot START)."""
        import jax.numpy as jnp

        S = self._dec.chunk * self._dec.samples_per_code
        if n == 0:
            return np.zeros((0, self.B, 1, S), np.int16), []
        pcms, lens = [], []
        for _ in range(n):
            pcm, ln = self._dec.decode_step(device_out=True)
            pcms.append(pcm)
            lens.append(ln)
        dev = jnp.stack(pcms)[:, :, None, :]
        if device_out:
            return dev, lens
        from soundkit_tpu.utils.wire import from_device_chunked

        return from_device_chunked(dev), lens


@functools.lru_cache(maxsize=16)
def _enc_step(codec: str):
    """Process-wide jitted encode step per codec (shape-polymorphic
    via jit retrace on new shapes)."""
    import jax
    import jax.numpy as jnp

    if codec.startswith("g711"):
        is_alaw = codec.endswith("alaw")
        return jax.jit(
            lambda pcm, valid: jnp.where(
                valid,
                companding.encode_alaw(pcm) if is_alaw
                else companding.encode_mulaw(pcm),
                0,
            )
        )
    if codec == "g722":
        return jax.jit(
            lambda pcm, valid, st: g722_ops.g722_encode_scan(pcm, st, valid)
        )
    bits = int(codec.split("_")[1]) // 8
    return jax.jit(
        lambda pcm, valid, st, _b=bits: adpcm.g726_encode_scan(pcm, st, _b, valid)
    )


class BatchedTelephonyEncoder:
    """Batched multi-stream telephony ENCODE (PCM -> G.711/722/726).

    The transcode-farm counterpart of :class:`BatchedTelephonyDecoder`
    (reference role: one soundkit-g711/g722/g726 encoder per pipeline
    thread): N concurrent i16 PCM streams encode in one jitted step per
    fixed-size chunk with ragged validity masks; packing to the wire
    bytes (G.726 bit packing) happens on the host.
    """

    def __init__(self, codec: str, num_streams: int, chunk_samples: int = 2048):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
        if codec == "g722" and chunk_samples % 2:
            raise ValueError("g722 needs an even chunk (2 samples/code)")
        self.codec = codec
        self.B = num_streams
        self.chunk = chunk_samples
        self._queues: List[np.ndarray] = [
            np.zeros(0, dtype=np.int16) for _ in range(num_streams)
        ]
        self._g726_rate: Optional[G726Rate] = None
        self._step = _enc_step(codec)

        if codec.startswith("g711"):
            self._state = None
            self.codes_per_sample = 1.0
        elif codec == "g722":
            self._state = g722_ops.g722_init_state(num_streams)
            self.codes_per_sample = 0.5
        else:
            bits = int(codec.split("_")[1]) // 8
            self._bits = bits
            self._g726_rate = {2: G726Rate.RATE_16000, 3: G726Rate.RATE_24000,
                               4: G726Rate.RATE_32000, 5: G726Rate.RATE_40000}[bits]
            self._state = adpcm.g726_init_state(num_streams)
            self.codes_per_sample = 1.0

    def push(self, stream_idx: int, pcm: np.ndarray) -> None:
        self._queues[stream_idx] = np.concatenate(
            [self._queues[stream_idx], np.asarray(pcm, np.int16)]
        )

    def encode_step(self) -> List[bytes]:
        """Encode up to chunk samples per stream -> wire bytes per lane."""
        import jax.numpy as jnp

        pcm = np.zeros((self.B, self.chunk), dtype=np.int32)
        valid = np.zeros((self.B, self.chunk), dtype=bool)
        taken = np.zeros(self.B, dtype=np.int64)
        for i, q in enumerate(self._queues):
            n = min(len(q), self.chunk)
            if self.codec == "g722":
                n -= n % 2
            if self._g726_rate is not None:
                # whole packing groups only
                spg = self._g726_rate.samples_per_byte_group
                n -= n % spg
            pcm[i, :n] = q[:n]
            valid[i, :n] = True
            taken[i] = n
            self._queues[i] = q[n:]

        if self.codec.startswith("g711"):
            codes = np.asarray(self._step(jnp.asarray(pcm), jnp.asarray(valid)))
        else:
            # g722's scan masks per CODE (one code = a sample pair)
            v = valid[:, ::2] if self.codec == "g722" else valid
            codes_j, self._state = self._step(
                jnp.asarray(pcm), jnp.asarray(v), self._state
            )
            codes = np.asarray(codes_j)

        out: List[bytes] = []
        for i in range(self.B):
            n = int(taken[i])
            if n == 0:
                out.append(b"")
            elif self.codec.startswith("g711"):
                out.append(codes[i, :n].astype(np.uint8).tobytes())
            elif self.codec == "g722":
                out.append(codes[i, : n // 2].astype(np.uint8).tobytes())
            else:
                from soundkit_tpu.codecs.g726 import pack_codes

                out.append(pack_codes(codes[i, :n], self._bits, G726Packing.LEFT))
        return out
