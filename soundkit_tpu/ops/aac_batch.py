"""Batched device AAC-LC numeric decode.

The device half of the flagship path (batched XLA kernels for the
AAC-LC inner loops over thousands of streams).  The
host parser (codecs.aac_lc) emits fixed-shape tensors per frame batch;
this module jits the numeric decode over ``[B, C, ...]``:

- dequantization: sign(q) * |q|^(4/3) * scale   (elementwise)
- M/S butterflies + intensity stereo via per-line masks/factors
- TNS all-pole filtering as ONE chunked lax.scan over spectral
  positions (each position belongs to at most one filter; direction
  handled by host-precomputed involutive permutations)
- IMDCT as a matmul: [B*C, 1024] @ [1024, 2048] (long) and
  blocked [B*C, 8, 128] @ [128, 256] (short), window bank gather,
  overlap-add with carried [B, C, 1024] state

Everything is shape-static and jit/pjit-compatible; shard dim 0
(streams) over the mesh for multi-chip.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from soundkit_tpu.codecs.aac_lc import (
    AacFrame,
    EIGHT_SHORT_SEQUENCE,
    INTENSITY_BT,
    INTENSITY_BT2,
    LONG_START_SEQUENCE,
    LONG_STOP_SEQUENCE,
    NOISE_BT,
    ONLY_LONG_SEQUENCE,
    ZERO_BT,
)
from soundkit_tpu.ops.aac_dsp import _lpc_from_parcor, half_window, imdct_matrix

MAX_ORDER = 20
MAX_FILTERS = 8  # >= filters per channel frame (8 short windows x 1)
TNS_CHUNK = 64


# ---------------------------------------------------------------------------
# constant banks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def window_bank() -> np.ndarray:
    """[4 seq, 2 prev_shape, 2 shape, 2048] long-path windows.

    EIGHT_SHORT entries are zeros (short path windows separately)."""
    bank = np.zeros((4, 2, 2, 2048), dtype=np.float32)
    for prev in (0, 1):
        for cur in (0, 1):
            la_prev = half_window(prev, 1024)
            ld = half_window(cur, 1024)[::-1]
            sa_prev = half_window(prev, 128)
            sd = half_window(cur, 128)[::-1]
            bank[ONLY_LONG_SEQUENCE, prev, cur] = np.concatenate([la_prev, ld])
            bank[LONG_START_SEQUENCE, prev, cur] = np.concatenate(
                [la_prev, np.ones(448), sd, np.zeros(448)]
            )
            bank[LONG_STOP_SEQUENCE, prev, cur] = np.concatenate(
                [np.zeros(448), sa_prev, np.ones(448), ld]
            )
    return bank


@functools.lru_cache(maxsize=1)
def short_window_bank() -> np.ndarray:
    """[2 prev, 2 cur, 8 windows, 256] per-subwindow short windows."""
    bank = np.zeros((2, 2, 8, 256), dtype=np.float32)
    for prev in (0, 1):
        for cur in (0, 1):
            sa_prev = half_window(prev, 128)
            sa = half_window(cur, 128)
            sd = half_window(cur, 128)[::-1]
            for i in range(8):
                asc = sa_prev if i == 0 else sa
                bank[prev, cur, i] = np.concatenate([asc, sd])
    return bank


# ---------------------------------------------------------------------------
# host-side batch preparation
# ---------------------------------------------------------------------------

@dataclass
class FrameBatch:
    """Fixed-shape tensors for one frame across B streams x C channels."""

    quant: np.ndarray        # [B, C, 1024] int32
    scale: np.ndarray        # [B, C, 1024] f32 (0 where zero/noise/intensity)
    ms_mask: np.ndarray      # [B, 1024] bool (CPE mid/side lines)
    int_factor: np.ndarray   # [B, 1024] f32, 0 = no intensity on that line
    perm: np.ndarray         # [B, C, 1024] int32 involutive TNS permutation
    filt_id: np.ndarray      # [B, C, 1024] int32 (-1 = no TNS)
    lpc: np.ndarray          # [B, C, MAX_FILTERS, MAX_ORDER] f32
    seq: np.ndarray          # [B, C] int32 window sequence
    shape: np.ndarray        # [B, C] int32 window shape
    chan_valid: np.ndarray   # [B, C] bool


def prepare_frame_batch(frames: List[Optional[AacFrame]], channels: int = 2) -> FrameBatch:
    """Flatten parsed frames (one per stream; None = silent) into tensors.

    Only the first element of each frame is used (SCE or CPE), matching
    the single-track decode pipeline.
    """
    B, C = len(frames), channels
    quant = np.zeros((B, C, 1024), dtype=np.int32)
    scale = np.zeros((B, C, 1024), dtype=np.float32)
    ms_mask = np.zeros((B, 1024), dtype=bool)
    int_factor = np.zeros((B, 1024), dtype=np.float32)
    perm = np.tile(np.arange(1024, dtype=np.int32), (B, C, 1))
    filt_id = np.full((B, C, 1024), -1, dtype=np.int32)
    lpc = np.zeros((B, C, MAX_FILTERS, MAX_ORDER), dtype=np.float32)
    seq = np.zeros((B, C), dtype=np.int32)
    shape = np.zeros((B, C), dtype=np.int32)
    chan_valid = np.zeros((B, C), dtype=bool)

    from soundkit_tpu.codecs.aac_lc import _tables

    t = _tables()

    for b, frame in enumerate(frames):
        if frame is None:
            continue
        el = frame.elements[0]
        ics_list = el.ics[:C]
        tmax_long = int(t["tns_max_1024"][frame.sample_rate_index])
        tmax_short = int(t["tns_max_128"][frame.sample_rate_index])
        for c, ics in enumerate(ics_list):
            chan_valid[b, c] = True
            quant[b, c] = ics.quant
            seq[b, c] = ics.window_sequence
            shape[b, c] = ics.window_shape
            short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
            # per-line scale
            wbase = 0
            for g in range(ics.num_window_groups):
                for s in range(ics.max_sfb):
                    cb = ics.band_type[g, s]
                    lo = int(ics.swb_offset[s])
                    hi = int(ics.swb_offset[s + 1])
                    for w in range(ics.group_lens[g]):
                        off = (wbase + w) * 128 if short else 0
                        sl = slice(off + lo, off + hi)
                        if cb == ZERO_BT or cb >= NOISE_BT:
                            pass  # scale stays 0 (noise handled host-side)
                        else:
                            scale[b, c, sl] = ics.scale[g, s]
                        if c == 1 and cb in (INTENSITY_BT, INTENSITY_BT2):
                            f = ics.scale[g, s]
                            sign = -1.0 if cb == INTENSITY_BT2 else 1.0
                            if (
                                el.ms_mask is not None
                                and s < el.ms_mask.shape[1]
                                and el.ms_mask[g, s]
                            ):
                                sign = -sign
                            int_factor[b, sl] = sign * f
                wbase += ics.group_lens[g]
            # TNS
            nf = 0
            mmax = min(tmax_short if short else tmax_long, ics.max_sfb)
            for w in range(ics.num_windows):
                bottom = ics.num_swb
                for f in ics.tns[w]:
                    top = bottom
                    bottom = max(0, top - f.length)
                    order = min(f.order, MAX_ORDER)
                    if order == 0 or nf >= MAX_FILTERS:
                        continue
                    start = int(ics.swb_offset[min(bottom, mmax)])
                    end = int(ics.swb_offset[min(top, mmax)])
                    if end - start <= 0:
                        continue
                    off = w * 128 if short else 0
                    lpc[b, c, nf, :order] = _lpc_from_parcor(f.coefs[:order])
                    filt_id[b, c, off + start : off + end] = nf
                    if f.direction:
                        seg = np.arange(off + start, off + end, dtype=np.int32)
                        perm[b, c, off + start : off + end] = seg[::-1]
                    nf += 1
        # M/S lines (CPE)
        if el.kind == "CPE" and el.ms_mask is not None:
            ics0, ics1 = el.ics[0], el.ics[1]
            short = ics0.window_sequence == EIGHT_SHORT_SEQUENCE
            wbase = 0
            for g in range(ics0.num_window_groups):
                for s in range(min(ics0.max_sfb, el.ms_mask.shape[1])):
                    if not el.ms_mask[g, s]:
                        continue
                    if ics0.band_type[g, s] >= NOISE_BT or ics1.band_type[g, s] >= NOISE_BT:
                        continue
                    lo = int(ics0.swb_offset[s])
                    hi = int(ics0.swb_offset[s + 1])
                    for w in range(ics0.group_lens[g]):
                        off = (wbase + w) * 128 if short else 0
                        ms_mask[b, off + lo : off + hi] = True
                wbase += ics0.group_lens[g]

    return FrameBatch(
        quant=quant, scale=scale, ms_mask=ms_mask, int_factor=int_factor,
        perm=perm, filt_id=filt_id, lpc=lpc, seq=seq, shape=shape,
        chan_valid=chan_valid,
    )


# ---------------------------------------------------------------------------
# device decode
# ---------------------------------------------------------------------------

def _tns_scan(coef, perm, filt_id, lpc):
    """Chunked sequential all-pole filter over spectral positions.

    coef: [B, C, 1024]; lpc: [B, C, F, MAX_ORDER]; each position has at
    most one active filter; history resets implicitly at region starts
    because positions before the region keep filt_id == -1.
    """
    import jax
    import jax.numpy as jnp

    B, C, N = coef.shape
    x = jnp.take_along_axis(coef, perm, axis=-1)

    # state: (history of last MAX_ORDER outputs [B,C,MAX_ORDER],
    #         previous position's filter id [B,C]); history resets when
    # the filter id changes so adjacent regions stay independent
    def chunk_step(carry, chunk_idx):
        hist, prev_fid = carry
        outs = []
        base = chunk_idx * TNS_CHUNK
        for j in range(TNS_CHUNK):
            pos = base + j
            xj = jax.lax.dynamic_slice_in_dim(x, pos, 1, axis=-1)[..., 0]
            fid = jax.lax.dynamic_slice_in_dim(filt_id, pos, 1, axis=-1)[..., 0]
            act = fid >= 0
            fresh = fid != prev_fid
            hist = jnp.where(fresh[..., None], 0.0, hist)
            lrow = jnp.take_along_axis(
                lpc, jnp.maximum(fid, 0)[..., None, None].astype(jnp.int32)
                .repeat(MAX_ORDER, -1), axis=2,
            )[..., 0, :]
            pred = jnp.sum(lrow * hist, axis=-1)
            yj = jnp.where(act, xj - pred, xj)
            hist = jnp.where(
                act[..., None],
                jnp.concatenate([yj[..., None], hist[..., :-1]], axis=-1),
                hist,
            )
            prev_fid = fid
            outs.append(yj)
        return (hist, prev_fid), jnp.stack(outs, axis=-1)

    hist0 = jnp.zeros((B, C, MAX_ORDER), dtype=coef.dtype)
    fid0 = jnp.full((B, C), -1, dtype=filt_id.dtype)
    (_, _), chunks = jax.lax.scan(chunk_step, (hist0, fid0), jnp.arange(N // TNS_CHUNK))
    # chunks: [n_chunks, B, C, TNS_CHUNK] -> [B, C, N]
    y = jnp.moveaxis(chunks, 0, 2).reshape(B, C, N)
    y = jnp.take_along_axis(y, perm, axis=-1)  # undo direction flip
    return y


def aac_decode_frame_device(
    quant, scale, ms_mask, int_factor, perm, filt_id, lpc, seq, shape,
    prev_shape, chan_valid, saved,
):
    """One frame for all streams. Returns (pcm [B, C, 1024], new_saved,
    new_prev_shape).  All inputs jnp arrays; jit this.

    Matmul precision is pinned to float32: on the GPU a float32
    matmul defaults to TF32 (10-bit mantissa), which would cap IMDCT
    accuracy far below the >90 dB bars that the host decoder is held
    to.
    """
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("float32"):
        return _aac_decode_frame_device(
            quant, scale, ms_mask, int_factor, perm, filt_id, lpc, seq,
            shape, prev_shape, chan_valid, saved,
        )


def _aac_decode_frame_device(
    quant, scale, ms_mask, int_factor, perm, filt_id, lpc, seq, shape,
    prev_shape, chan_valid, saved,
):
    import jax.numpy as jnp

    B, C, N = quant.shape

    # dequant (elementwise)
    q = quant.astype(jnp.float32)
    coef = jnp.sign(q) * jnp.abs(q) ** (4.0 / 3.0) * scale

    # M/S butterflies between channel 0/1
    if C >= 2:
        m = coef[:, 0]
        s = coef[:, 1]
        l = jnp.where(ms_mask, m + s, m)
        r = jnp.where(ms_mask, m - s, s)
        # intensity: right from left
        has_int = int_factor != 0.0
        r = jnp.where(has_int, l * int_factor, r)
        coef = jnp.stack([l, r], axis=1)

    # TNS
    coef = _tns_scan(coef, perm, filt_id, lpc)

    flat = coef.reshape(B * C, N)

    # long path
    M_long = jnp.asarray(imdct_matrix(1024).astype(np.float32))
    z_long = flat @ M_long.T  # [B*C, 2048]
    bank = jnp.asarray(window_bank())  # [4,2,2,2048]
    seq_f = seq.reshape(-1)
    shape_f = shape.reshape(-1)
    prev_f = prev_shape.reshape(-1)
    w_long = bank[seq_f, prev_f, shape_f]  # [B*C, 2048]
    z_long = z_long * w_long

    # short path
    M_short = jnp.asarray(imdct_matrix(128).astype(np.float32))
    subs = flat.reshape(B * C, 8, 128) @ M_short.T  # [B*C, 8, 256]
    sbank = jnp.asarray(short_window_bank())  # [2,2,8,256]
    w_short = sbank[prev_f, shape_f]  # [B*C, 8, 256]
    subs = subs * w_short
    # overlap the 8 subwindows into a 2048 frame starting at 448
    z_short = jnp.zeros((B * C, 2048), dtype=subs.dtype)
    for i in range(8):
        z_short = z_short.at[:, 448 + i * 128 : 448 + i * 128 + 256].add(subs[:, i])

    is_short = (seq_f == EIGHT_SHORT_SEQUENCE)[:, None]
    z = jnp.where(is_short, z_short, z_long).reshape(B, C, 2048)

    valid = chan_valid[..., None]
    out = jnp.where(valid, saved + z[..., :1024], 0.0)
    new_saved = jnp.where(valid, z[..., 1024:], saved)
    # an idle lane keeps its window shape too: the next frame's left
    # window half follows the last frame it really decoded
    new_shape = jnp.where(chan_valid, shape, prev_shape)
    return out / 32768.0, new_saved, new_shape


def init_state(B: int, C: int = 2):
    return (
        np.zeros((B, C, 1024), dtype=np.float32),  # saved
        np.zeros((B, C), dtype=np.int32),  # prev window shape
    )


# ---------------------------------------------------------------------------
# compact-transfer variant: integer wire forms reconstructed on device
# (ships ~6MB instead of ~21MB of h2d per 512-stream frame batch)
# ---------------------------------------------------------------------------

@dataclass
class CompactFrameBatch:
    quant: np.ndarray      # [B, C, 1024] int16 (host falls back if escapes overflow)
    line_sf: np.ndarray    # [B, C, 1024] uint8: scalefactor per line, 0 = silent
    is_pos: np.ndarray     # [B, 1024] int8: intensity position
    is_sign: np.ndarray    # [B, 1024] int8: intensity sign (-1/0/+1); 0 = none
    ms_mask: np.ndarray    # [B, 1024] uint8
    regions: np.ndarray    # [B, C, MAX_FILTERS, 3] int16: start, end, direction
    lpc: np.ndarray        # [B, C, MAX_FILTERS, MAX_ORDER] f32
    seq: np.ndarray        # [B, C] int32
    shape: np.ndarray      # [B, C] int32
    chan_valid: np.ndarray # [B, C] uint8


def _perm_filt_from_regions(regions, B, C, N):
    """Reconstruct the TNS involutive permutation + filter-id maps from
    per-filter (start, end, direction) regions, on device."""
    import jax.numpy as jnp

    idx = jnp.arange(N, dtype=jnp.int32)[None, None, :]
    perm = jnp.broadcast_to(idx, (B, C, N))
    filt_id = jnp.full((B, C, N), -1, dtype=jnp.int32)
    for f in range(MAX_FILTERS):
        start = regions[:, :, f, 0].astype(jnp.int32)[..., None]
        end = regions[:, :, f, 1].astype(jnp.int32)[..., None]
        direction = regions[:, :, f, 2].astype(jnp.int32)[..., None]
        inside = (idx >= start) & (idx < end)
        filt_id = jnp.where(inside, f, filt_id)
        rev = start + end - 1 - idx
        perm = jnp.where(inside & (direction != 0), rev, perm)
    return perm, filt_id


def aac_decode_frame_device_compact(
    quant, line_sf, is_pos, is_sign, ms_mask, regions, lpc, seq, shape,
    prev_shape, chan_valid, saved,
):
    """Compact-wire device step: reconstructs scale / intensity factors /
    TNS perm+filt_id on device, then runs the standard decode."""
    import jax.numpy as jnp

    B, C, N = quant.shape
    scale = jnp.where(
        line_sf > 0, jnp.exp2(0.25 * (line_sf.astype(jnp.float32) - 100.0)), 0.0
    )
    int_factor = jnp.where(
        is_sign != 0,
        is_sign.astype(jnp.float32) * jnp.exp2(-0.25 * is_pos.astype(jnp.float32)),
        0.0,
    )
    perm, filt_id = _perm_filt_from_regions(regions, B, C, N)

    return aac_decode_frame_device(
        quant.astype(jnp.int32), scale, ms_mask != 0, int_factor, perm, filt_id,
        lpc, seq, shape, prev_shape, chan_valid != 0, saved,
    )


# ---------------------------------------------------------------------------
# packed compact wire: ALL compact fields in ONE host buffer so the
# host->device feed is a single transfer (each separate jnp.asarray
# costs its own issue overhead plus a staging copy)
# ---------------------------------------------------------------------------

def compact_wire_layout(B: int):
    """(name, offset, dtype, shape) for every compact field inside the
    packed uint8 buffer, plus the total byte size. Fields are ordered
    by alignment (f32/i32, i16, bytes); offsets stay 4-byte aligned."""
    fields = [
        ("lpc", np.float32, (B, 2, MAX_FILTERS, MAX_ORDER)),
        ("seq", np.int32, (B, 2)),
        ("shape", np.int32, (B, 2)),
        ("quant", np.int16, (B, 2, 1024)),
        ("regions", np.int16, (B, 2, MAX_FILTERS, 3)),
        ("line_sf", np.uint8, (B, 2, 1024)),
        ("is_pos", np.int8, (B, 1024)),
        ("is_sign", np.int8, (B, 1024)),
        ("ms_mask", np.uint8, (B, 1024)),
        ("chan_valid", np.uint8, (B, 2)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


def unpack_compact_wire(buf, B: int):
    """Slice + bitcast the packed buffer back into compact fields
    (device-side, inside jit; little-endian bitcast)."""
    import jax.numpy as jnp
    from jax import lax

    out = {}
    for name, off, dt, shp in compact_wire_layout(B)[0]:
        n = int(np.prod(shp))
        width = np.dtype(dt).itemsize
        raw = lax.slice(buf, (off,), (off + n * width,))
        jdt = jnp.dtype(dt)
        if width == 1:
            x = lax.bitcast_convert_type(raw, jdt)
        else:
            x = lax.bitcast_convert_type(raw.reshape(n, width), jdt)
        out[name] = x.reshape(shp)
    return out


def aac_decode_frame_device_compact_packed(buf, prev_shape, saved):
    """One-transfer variant of :func:`aac_decode_frame_device_compact`:
    ``buf`` is the packed uint8 wire from
    ``codecs.aac_lc_native.prepare_compact_batch_packed``. The wire
    always carries two channels; the carried state's channel count
    (mono models) selects how many are decoded."""
    B, C = prev_shape.shape[0], prev_shape.shape[1]
    f = unpack_compact_wire(buf, B)
    return aac_decode_frame_device_compact(
        f["quant"][:, :C], f["line_sf"][:, :C], f["is_pos"], f["is_sign"],
        f["ms_mask"], f["regions"][:, :C], f["lpc"][:, :C], f["seq"][:, :C],
        f["shape"][:, :C], prev_shape, f["chan_valid"][:, :C], saved,
    )


# ---------------------------------------------------------------------------
# v3 wire: ~3.6 KB/lane (vs compact's ~10.6 KB). quant as i8 + escape
# list, scalefactor / MS / intensity tables as run-length segments
# expanded on device, TNS as raw reflection indices with the sin
# dequant + lattice->direct conversion on device: fewer h2d bytes,
# and the host writes ~3x less memory per AU.
# ---------------------------------------------------------------------------

V3_ESC = 32
V3_RUNS = 128


def v3_wire_layout(B: int):
    """(name, offset, dtype, shape) of every v3 field inside the packed
    uint8 buffer + total size. Ordered by alignment; 4-byte offsets."""
    fields = [
        ("esc_idx", np.uint16, (B, V3_ESC)),
        ("esc_val", np.int16, (B, V3_ESC)),
        ("regions", np.int16, (B, 2, MAX_FILTERS, 3)),
        ("quant", np.int8, (B, 2, 1024)),
        ("sf_len", np.uint8, (B, 2, V3_RUNS)),
        ("sf_val", np.uint8, (B, 2, V3_RUNS)),
        ("msis_len", np.uint8, (B, V3_RUNS)),
        ("msis_ms", np.uint8, (B, V3_RUNS)),
        ("msis_pos", np.int8, (B, V3_RUNS)),
        ("msis_sign", np.int8, (B, V3_RUNS)),
        ("refl", np.int8, (B, 2, MAX_FILTERS, MAX_ORDER)),
        ("crb", np.uint8, (B, 2, MAX_FILTERS)),
        ("order", np.uint8, (B, 2, MAX_FILTERS)),
        ("seq", np.uint8, (B, 2)),
        ("shape", np.uint8, (B, 2)),
        ("chan_valid", np.uint8, (B, 2)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


def unpack_v3_wire(buf, B: int):
    """Slice + bitcast the packed v3 buffer (device-side, inside jit)."""
    import jax.numpy as jnp
    from jax import lax

    out = {}
    for name, off, dt, shp in v3_wire_layout(B)[0]:
        n = int(np.prod(shp))
        width = np.dtype(dt).itemsize
        raw = lax.slice(buf, (off,), (off + n * width,))
        jdt = jnp.dtype(dt)
        if width == 1:
            x = lax.bitcast_convert_type(raw, jdt)
        else:
            x = lax.bitcast_convert_type(raw.reshape(n, width), jdt)
        out[name] = x.reshape(shp)
    return out


def _rle_expand(lens, vals, n: int = 1024):
    """Expand run-length (lens, vals) tables along the last axis to a
    per-line value map: line i takes vals[r] for the unique run r with
    cum(lens)[r-1] <= i < cum(lens)[r]. Lines past the covered total
    (silent lanes: all-zero lens) clamp to vals[-1], which the host
    keeps 0."""
    import jax
    import jax.numpy as jnp

    ends = jnp.cumsum(lens.astype(jnp.int32), axis=-1)
    idx = jnp.arange(n, dtype=jnp.int32)
    S = ends.shape[-1]
    flat = ends.reshape(-1, S)
    seg = jax.vmap(lambda e: jnp.searchsorted(e, idx, side="right"))(flat)
    seg = seg.reshape(*ends.shape[:-1], n).astype(jnp.int32)
    seg = jnp.minimum(seg, S - 1)
    return jnp.take_along_axis(vals, seg, axis=-1)


def _tns_refl_to_lpc(refl, crb, order):
    """sin dequant of raw TNS reflection indices + lattice->direct-form
    conversion, on device (ISO 13818-7 tns_data; host reference:
    native/src/aac_parse.cpp decode_ics / fill_lane_compact)."""
    import jax.numpy as jnp
    from jax import lax

    c = refl.astype(jnp.float32)
    half = jnp.exp2(crb.astype(jnp.float32) - 1.0)  # 1 << (crb-1)
    iqfac = jnp.maximum((half - 0.5) / (jnp.pi / 2.0), 1e-9)[..., None]
    iqfac_m = jnp.maximum((half + 0.5) / (jnp.pi / 2.0), 1e-9)[..., None]
    kk = jnp.sin(c / jnp.where(c >= 0, iqfac, iqfac_m))
    m_idx = jnp.arange(MAX_ORDER, dtype=jnp.int32)
    order32 = order.astype(jnp.int32)[..., None]
    kk = jnp.where(m_idx < order32, kk, 0.0)

    lpc = jnp.zeros_like(kk)
    for m in range(MAX_ORDER):
        kkm = kk[..., m : m + 1]
        rev = jnp.flip(lpc, -1)
        rev_pad = jnp.concatenate([rev, jnp.zeros_like(rev)], axis=-1)
        # rev_pad[20-m+i] == lpc[m-1-i] for i < m
        sl = lax.slice_in_dim(rev_pad, MAX_ORDER - m, 2 * MAX_ORDER - m, axis=-1)
        new = jnp.where(m_idx < m, lpc + kkm * sl, lpc)
        new = jnp.where(m_idx == m, kkm, new)
        lpc = jnp.where(m < order32, new, lpc)
    return lpc


def aac_decode_frame_device_v3_packed(buf, prev_shape, saved):
    """Device step over the packed v3 wire from
    ``codecs.aac_lc_native.prepare_v3_batch_packed``."""
    import jax.numpy as jnp

    B, C = prev_shape.shape[0], prev_shape.shape[1]
    N = 1024
    f = unpack_v3_wire(buf, B)

    # quant: i8 + escape scatter (sentinel idx 0xFFFF is out of bounds
    # and dropped)
    q = f["quant"].astype(jnp.int32).reshape(B, 2 * N)
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    q = q.at[bidx, f["esc_idx"].astype(jnp.int32)].add(
        f["esc_val"].astype(jnp.int32), mode="drop"
    )
    quant = q.reshape(B, 2, N)[:, :C]

    # per-line scalefactors from RLE runs
    line_sf = _rle_expand(f["sf_len"][:, :C], f["sf_val"][:, :C], N)
    scale = jnp.where(
        line_sf > 0, jnp.exp2(0.25 * (line_sf.astype(jnp.float32) - 100.0)), 0.0
    )

    # pair-level MS / intensity maps from RLE runs
    ms_line = _rle_expand(f["msis_len"], f["msis_ms"], N)
    is_pos = _rle_expand(f["msis_len"], f["msis_pos"], N)
    is_sign = _rle_expand(f["msis_len"], f["msis_sign"], N)
    int_factor = jnp.where(
        is_sign != 0,
        is_sign.astype(jnp.float32) * jnp.exp2(-0.25 * is_pos.astype(jnp.float32)),
        0.0,
    )

    lpc = _tns_refl_to_lpc(f["refl"][:, :C], f["crb"][:, :C], f["order"][:, :C])
    regions = f["regions"][:, :C]
    perm, filt_id = _perm_filt_from_regions(regions, B, C, N)

    return aac_decode_frame_device(
        quant, scale, ms_line != 0, int_factor, perm, filt_id, lpc,
        f["seq"][:, :C].astype(jnp.int32), f["shape"][:, :C].astype(jnp.int32),
        prev_shape, f["chan_valid"][:, :C] != 0, saved,
    )


# ---------------------------------------------------------------------------
# v4 wire: raw AU + section program; spectral Huffman decode ON DEVICE
# (ops/aac_entropy.py).  ~1.9 KB/lane vs v3's ~3.6 KB, and the host
# never decodes spectral values (length-only walk).
# ---------------------------------------------------------------------------

V4_RUNS = 128
V4_PNS = 16
V4_AU_CAP = 1024


def v4_wire_layout(B: int):
    """(name, offset, dtype, shape) of every v4 field inside the packed
    uint8 buffer + total size (4-byte aligned offsets)."""
    fields = [
        ("runs", np.uint32, (B, 2, V4_RUNS)),
        ("pns", np.uint32, (B, 2, V4_PNS)),
        ("regions", np.int16, (B, 2, MAX_FILTERS, 3)),
        ("spec_bit", np.uint16, (B, 2)),
        ("sf_len", np.uint8, (B, 2, V3_RUNS)),
        ("sf_val", np.uint8, (B, 2, V3_RUNS)),
        ("msis_len", np.uint8, (B, V3_RUNS)),
        ("msis_ms", np.uint8, (B, V3_RUNS)),
        ("msis_pos", np.int8, (B, V3_RUNS)),
        ("msis_sign", np.int8, (B, V3_RUNS)),
        ("refl", np.int8, (B, 2, MAX_FILTERS, MAX_ORDER)),
        ("crb", np.uint8, (B, 2, MAX_FILTERS)),
        ("order", np.uint8, (B, 2, MAX_FILTERS)),
        ("n_runs", np.uint8, (B, 2)),
        ("seq", np.uint8, (B, 2)),
        ("shape", np.uint8, (B, 2)),
        ("chan_valid", np.uint8, (B, 2)),
        ("au", np.uint8, (B, V4_AU_CAP)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


def unpack_v4_wire(buf, B: int):
    """Slice+bitcast every v4 field out of the packed device buffer."""
    import jax.numpy as jnp
    from jax import lax

    out = {}
    for name, off, dt, shp in v4_wire_layout(B)[0]:
        n = int(np.prod(shp))
        width = np.dtype(dt).itemsize
        raw = lax.slice(buf, (off,), (off + n * width,))
        jdt = jnp.dtype(dt)
        if width == 1:
            x = lax.bitcast_convert_type(raw, jdt)
        else:
            x = lax.bitcast_convert_type(raw.reshape(n, width), jdt)
        out[name] = x.reshape(shp)
    return out


def aac_decode_frame_device_v4_packed(buf, prev_shape, saved, max_steps: int):
    """Device step over the packed v4 wire from
    ``codecs.aac_lc_native.prepare_v4_batch_packed``: device entropy
    decode of the raw AUs, then the standard synthesis.  jit with
    static max_steps (codecs.aac_lc_native bucket-computes it)."""
    import jax.numpy as jnp

    from soundkit_tpu.ops.aac_entropy import aac_spectral_decode_device

    B, C = prev_shape.shape[0], prev_shape.shape[1]
    N = 1024
    f = unpack_v4_wire(buf, B)

    # AU bytes -> big-endian u32 words, one row per CHANNEL lane
    au = f["au"].reshape(B, V4_AU_CAP // 4, 4).astype(jnp.uint32)
    words = (
        (au[..., 0] << 24) | (au[..., 1] << 16) | (au[..., 2] << 8) | au[..., 3]
    )
    words2 = jnp.repeat(words, 2, axis=0)  # [2B, W]

    runs = f["runs"].reshape(B * 2, V4_RUNS)
    runs_cb = (runs & 15).astype(jnp.int32)
    runs_ncw = ((runs >> 4) & 63).astype(jnp.int32)
    runs_out = ((runs >> 10) & 4095).astype(jnp.int32)
    n_runs = f["n_runs"].reshape(B * 2).astype(jnp.int32)
    bitpos = f["spec_bit"].reshape(B * 2).astype(jnp.int32)

    quant = aac_spectral_decode_device(
        words2, bitpos, runs_cb, runs_ncw, runs_out, n_runs, max_steps
    ).reshape(B, 2, N)[:, :C]

    # PNS bands: +-1 sign noise drawn on device (energies come from
    # the line_sf runs like any coded band; signs are a per-(lane,
    # line) hash -- spec-conformant noise, independent of the host LCG)
    pns = f["pns"][:, :C]  # [B, C, V4_PNS] u32: start | nlines<<12
    line = jnp.arange(N, dtype=jnp.uint32)[None, None, None, :]
    start = (pns & 4095)[..., None]
    nl = ((pns >> 12) & 1023)[..., None]
    in_run = (line >= start) & (line < start + nl) & (nl > 0)
    pns_mask = jnp.any(in_run, axis=2)  # [B, C, N]
    lane_id = jnp.arange(B, dtype=jnp.uint32)[:, None, None]
    h = (line[:, :, 0] * jnp.uint32(2654435761)
         + lane_id * jnp.uint32(40503) + jnp.uint32(12345))
    sign = jnp.where(((h >> jnp.uint32(13)) & 1) == 1, 1, -1).astype(jnp.int32)
    quant = jnp.where(pns_mask, sign, quant)

    line_sf = _rle_expand(f["sf_len"][:, :C], f["sf_val"][:, :C], N)
    scale = jnp.where(
        line_sf > 0, jnp.exp2(0.25 * (line_sf.astype(jnp.float32) - 100.0)), 0.0
    )
    ms_line = _rle_expand(f["msis_len"], f["msis_ms"], N)
    is_pos = _rle_expand(f["msis_len"], f["msis_pos"], N)
    is_sign = _rle_expand(f["msis_len"], f["msis_sign"], N)
    int_factor = jnp.where(
        is_sign != 0,
        is_sign.astype(jnp.float32) * jnp.exp2(-0.25 * is_pos.astype(jnp.float32)),
        0.0,
    )
    lpc = _tns_refl_to_lpc(f["refl"][:, :C], f["crb"][:, :C], f["order"][:, :C])
    perm, filt_id = _perm_filt_from_regions(f["regions"][:, :C], B, C, N)

    return aac_decode_frame_device(
        quant, scale, ms_line != 0, int_factor, perm, filt_id, lpc,
        f["seq"][:, :C].astype(jnp.int32), f["shape"][:, :C].astype(jnp.int32),
        prev_shape, f["chan_valid"][:, :C] != 0, saved,
    )
