"""Device FLAC Rice decoder — the SIMD bitstream interpreter.

Round-4 sibling of the AAC spectral entropy decoder
(ops/aac_entropy.py, same architecture): the FLAC serving model's
residual-plane wire cost 4 bytes of h2d per sample (int32 residuals,
~38 MB per 64-stream batch of the fixture), dwarfing the device
compute.  This module ships the
COMPRESSED frame bytes instead and decodes the Rice / fixed-width
residual payloads on the chip:

- the C++ walk (native/src/flac.cpp skt_flac_next_segs) locates every
  coding span and emits a dense cross-batch segment table
  (bit offset, Rice k or fixed width, count, destination index),
- the device runs one `lax.scan` whose body decodes ONE code PER
  SEGMENT per iteration: 32-bit window gather from the frame words,
  `lax.clz` unary quotient (24-zero windows consume an iteration
  without finishing a code, so arbitrary legal quotients work), k-bit
  remainder from a second window, zigzag; fixed-width segments
  (escape partitions, VERBATIM subframes) sign-extend a single read.
  Segments decode INDEPENDENTLY — the host walk pins each span's
  start bit — so parallelism is segments x scan of <=SEG_LEN_CAP
  samples, not one sequential walk per frame,
- one scatter materialises the [lanes, 2, stride] residual plane that
  feeds the existing LPC reconstruction kernel (ops/flac_lpc.py),
  fused in the same jitted program.

Bit-exact vs the host decoder (tests/test_flac_device.py).
Reference role: the claxon Rice hot loop,
soundkit-flac/src/lib.rs:646-780.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np


def pack_frame_words(frames: List[bytes], max_bytes: int) -> np.ndarray:
    """[NL, max_bytes//4] uint32, big-endian within each word.

    The hot path is the native scatter (skt_pack_frames_be): it
    touches only each frame's valid bytes, byteswapping on the way in,
    where the numpy expression re-wrote the whole padded plane —
    ~0.45 s -> ~0.05 s per 1024-stream fleet collect.

    Frames longer than ``max_bytes`` raise (the native scatter would
    silently clamp and the numpy path would raise a broadcast error —
    this guard makes both paths fail the same way; callers size
    ``max_bytes`` >= the longest frame)."""
    NL = len(frames)
    W = max_bytes // 4
    for i, fb in enumerate(frames):
        if len(fb) > W * 4:
            raise ValueError(
                f"frame {i} is {len(fb)} B > word plane {W * 4} B"
            )
    try:
        import ctypes

        from soundkit_tpu.native.loader import load as _load_native

        lib = _load_native()
        fn = getattr(lib, "skt_pack_frames_be")
    except Exception:
        # OSError/AttributeError (no lib / missing symbol) and
        # NativeBuildError (lazy make failed: no g++/libavcodec on
        # this box) all mean the same thing here: use the numpy path
        fn = None
    if fn is not None:
        offs = np.zeros(NL, np.int64)
        lens = np.zeros(NL, np.int64)
        pos = 0
        for i, fb in enumerate(frames):
            offs[i] = pos
            lens[i] = len(fb)
            pos += lens[i]
        buf = b"".join(frames)
        out = np.zeros((NL, W), dtype=np.uint32)
        fn(ctypes.c_long(NL), ctypes.c_char_p(buf),
           ctypes.c_void_p(offs.ctypes.data),
           ctypes.c_void_p(lens.ctypes.data),
           ctypes.c_long(W), ctypes.c_void_p(out.ctypes.data))
        return out
    buf = np.zeros((NL, max_bytes), dtype=np.uint8)
    for i, fb in enumerate(frames):
        buf[i, : len(fb)] = np.frombuffer(fb, np.uint8)
    return (
        buf.reshape(NL, -1, 4)[..., ::-1].copy().view(np.uint32)
        .reshape(NL, -1)
    )


def seg_wire(frame_segs: List[np.ndarray], stride: int):
    """Flatten per-frame-lane [n,4] segment tables (bitoff, k, n, dest
    with dest = c*stride + pos) into dense global arrays whose dest
    addresses the flat [NL*2*stride] plane.  Returns
    (lane, bitoff, k, n, dest) int32 [N_pad] with pad rows n=0."""
    lanes, offs, ks, ns, dests = [], [], [], [], []
    for i, segs in enumerate(frame_segs):
        if segs.size == 0:
            continue
        m = segs.shape[0]
        lanes.append(np.full(m, i, np.int32))
        offs.append(segs[:, 0])
        ks.append(segs[:, 1])
        ns.append(segs[:, 2])
        dests.append(segs[:, 3] + np.int32(i * 2 * stride))
    if not lanes:
        z = np.zeros(1, np.int32)
        return z, z, z, z, z
    cat = lambda xs: np.concatenate(xs).astype(np.int32)  # noqa: E731
    lane, off, k, n, dest = map(cat, (lanes, offs, ks, ns, dests))
    N = lane.shape[0]
    N_pad = 1 << max((N - 1).bit_length(), 6)
    pad = N_pad - N
    if pad:
        zp = np.zeros(pad, np.int32)
        lane = np.concatenate([lane, zp])
        off = np.concatenate([off, zp])
        k = np.concatenate([k, zp])
        n = np.concatenate([n, zp])  # n=0 -> never active
        dest = np.concatenate([dest, zp])
    return lane, off, k, n, dest


def flac_rice_plane_device(words, seg_lane, seg_bitoff, seg_k, seg_n,
                           seg_dest, warm, const_flag, const_val,
                           steps: int, nl_pad: int, stride: int):
    """Decode every segment's codes -> residual plane
    [nl_pad, 2, stride] int32 (warmup + constant channels filled).

    words [NL, W] uint32 BE; seg_* [N] int32; warm [NL, 2, 32] i32;
    const_flag/const_val [NL, 2] i32.  ``steps``/``nl_pad``/``stride``
    are static (jit static_argnums=(9, 10, 11)).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    NL, W = words.shape
    N = seg_lane.shape[0]
    flat_words = words.reshape(-1)
    lane_base = seg_lane * W

    is_fixed = seg_k < 0
    width = jnp.where(is_fixed, -seg_k - 1, 0).astype(jnp.uint32)
    k = jnp.maximum(seg_k, 0).astype(jnp.uint32)

    def window32(bitpos):
        """Next 32 bits MSB-first at each segment's bitpos (uint32)."""
        wi = (bitpos >> 5).astype(jnp.int32)
        sh = (bitpos & 31).astype(jnp.uint32)
        w0 = jnp.take(flat_words, lane_base + jnp.minimum(wi, W - 1))
        w1 = jnp.take(flat_words, lane_base + jnp.minimum(wi + 1, W - 1))
        hi = jnp.where(sh == 0, w0, w0 << sh)
        lo = jnp.where(sh == 0, jnp.uint32(0), w1 >> (jnp.uint32(32) - sh))
        return hi | lo

    DUMP = nl_pad * 2 * stride  # out-of-range slot for non-emitting rows

    def body(state, _):
        bitpos, qacc, si = state
        active = si < seg_n
        win = window32(bitpos)

        # fixed-width read (escape partitions / verbatim): always
        # completes one code
        v_u = jnp.where(
            width == 0, jnp.uint32(0),
            win >> (jnp.uint32(32) - width),
        )
        inv = jnp.uint32(32) - width  # 0..32; width==0 guarded above
        v_f = jnp.where(
            width == 0, jnp.int32(0),
            ((v_u << inv).astype(jnp.int32)) >> inv.astype(jnp.int32),
        )

        # Rice: unary quotient via clz; a 24-zero window consumes the
        # iteration without finishing (qacc accumulates)
        lead = lax.clz(win).astype(jnp.int32)  # clz(0) == 32
        long_skip = (~is_fixed) & (lead >= 24)
        q = (qacc + lead).astype(jnp.uint32)
        rem_pos = bitpos + lead + 1
        rwin = window32(rem_pos)
        rem = jnp.where(k == 0, jnp.uint32(0),
                        rwin >> (jnp.uint32(32) - k))
        zz = (q << k) | rem
        v_r = (zz >> 1).astype(jnp.int32) ^ -(zz & 1).astype(jnp.int32)

        done = active & (is_fixed | ~long_skip)
        val = jnp.where(is_fixed, v_f, v_r)
        tgt = jnp.where(done, seg_dest + si, DUMP)

        adv = jnp.where(is_fixed, width.astype(jnp.int32),
                        jnp.where(long_skip, 24,
                                  lead + 1 + seg_k))
        bitpos = jnp.where(active, bitpos + adv, bitpos)
        qacc = jnp.where(done | ~active, 0, jnp.where(long_skip, qacc + 24, qacc))
        si = jnp.where(done, si + 1, si)
        return (bitpos, qacc, si), (val, tgt)

    state = (
        seg_bitoff.astype(jnp.int32),
        jnp.zeros(N, jnp.int32),
        jnp.zeros(N, jnp.int32),
    )
    _, (vals, tgts) = lax.scan(body, state, None, length=steps)

    plane = jnp.zeros((nl_pad, 2, stride), jnp.int32)
    plane = plane.at[:, :, :32].set(
        jnp.pad(warm, ((0, nl_pad - NL), (0, 0), (0, 0)))
    )
    cf = jnp.pad(const_flag, ((0, nl_pad - NL), (0, 0)))
    cv = jnp.pad(const_val, ((0, nl_pad - NL), (0, 0)))
    plane = jnp.where(cf[:, :, None] == 1, cv[:, :, None], plane)
    flat = jnp.concatenate([plane.reshape(-1), jnp.zeros(1, jnp.int32)])
    flat = flat.at[tgts.reshape(-1)].set(vals.reshape(-1), mode="drop")
    return flat[:-1].reshape(nl_pad, 2, stride)


@functools.lru_cache(maxsize=8)
def _jitted_segs():
    """Fused segment-wire program: device Rice decode -> int64 widen ->
    LPC reconstruction / wasted shift / decorrelation."""
    import jax
    import jax.numpy as jnp

    from soundkit_tpu.ops.flac_lpc import flac_frame_device

    def kern(words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm,
             const_flag, const_val, coef, order, shift, wasted,
             chan_assign, block_size, lane_valid, steps, nl_pad, stride):
        plane = flac_rice_plane_device(
            words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm,
            const_flag, const_val, steps, nl_pad, stride,
        )
        c = lambda a: a.astype(jnp.int64)  # noqa: E731
        return flac_frame_device(
            c(plane), c(coef), c(order), c(shift), c(wasted),
            c(chan_assign), c(block_size), lane_valid,
        )

    return jax.jit(kern, static_argnums=(16, 17, 18))


def flac_frames_device_segs(words, frame_segs, warm, const_flag, const_val,
                            coef, order, shift, wasted, chan_assign,
                            block_size, lane_valid, steps: int,
                            nl_pad: int, stride: int,
                            device_out: bool = False,
                            n_keep: int | None = None):
    """Serving entry: many frames in ONE device call over the segment
    wire.  ``frame_segs`` is a list of per-frame [n, 4] tables (or the
    pre-flattened tuple from :func:`seg_wire`)."""
    import jax

    from soundkit_tpu.utils.wire import (
        WIRE_CHUNK_BYTES,
        from_device_chunked,
        to_device_chunked,
    )

    if isinstance(frame_segs, tuple):
        lane, off, k, n, dest = frame_segs
    else:
        lane, off, k, n, dest = seg_wire(frame_segs, stride)

    def h2d(a, dt):
        a = np.ascontiguousarray(np.asarray(a, dt))
        flat = a.reshape(-1)
        return to_device_chunked(
            flat, chunk_bytes=WIRE_CHUNK_BYTES // a.itemsize
        ).reshape(a.shape)

    with jax.enable_x64():
        out = _jitted_segs()(
            h2d(words, np.uint32), h2d(lane, np.int32),
            h2d(off, np.int32), h2d(k, np.int32), h2d(n, np.int32),
            h2d(dest, np.int32), h2d(warm, np.int32),
            h2d(const_flag, np.int32), h2d(const_val, np.int32),
            h2d(coef, np.int32), h2d(order, np.int32),
            h2d(shift, np.int32), h2d(wasted, np.int32),
            h2d(chan_assign, np.int32), h2d(block_size, np.int32),
            np.asarray(lane_valid, bool), steps, nl_pad, stride,
        )
    if n_keep is not None and n_keep < out.shape[0]:
        out = out[:n_keep]
    if device_out:
        return out
    return from_device_chunked(out)
