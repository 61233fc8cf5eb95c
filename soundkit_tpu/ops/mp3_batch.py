"""Batched device MP3 granule decode.

North-star kernels (BASELINE.json: "nanomp3's IMDCT + polyphase
synthesis filterbank" batched over streams): one jitted step decodes
one granule for ``[B, C]`` lanes —

- requantize: elementwise pow-4/3 * per-line scale (VPU)
- MS stereo: full-spectrum butterflies (Layer III MS covers the whole
  spectrum); intensity via host-precomputed per-line factors
- alias reduction: the 8-butterfly boundary network as gather +
  elementwise ops with per-lane boundary masks
- IMDCT: [B*C*32, 18] @ [18, 36] long matmul and blocked short
  [., 6] @ [6, 12] matmuls, window bank gathers, frequency inversion
- polyphase: 18 rounds of [., 32] @ [32, 64] matrixing into a FIFO +
  the windowed U-dot (static gather indices), carried [B, C, 1024]
  state

Host preparation flattens parsed granules (codecs.mp3_native) into
fixed-shape tensors; ragged lanes freeze via ``lane_valid``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.mp3_native import Granule, Mp3Frame, Mp3Header
from soundkit_tpu.ops import mp3_dsp


@functools.lru_cache(maxsize=1)
def _u_indices() -> np.ndarray:
    idx = np.zeros(512, dtype=np.int32)
    for i in range(8):
        idx[64 * i : 64 * i + 32] = np.arange(128 * i, 128 * i + 32)
        idx[64 * i + 32 : 64 * i + 64] = np.arange(128 * i + 96, 128 * i + 128)
    return idx


@functools.lru_cache(maxsize=1)
def _alias_idx():
    """Static index/coef arrays for the 31-boundary butterfly network."""
    a_idx = []  # position below boundary
    b_idx = []  # position above
    cs = []
    ca = []
    for sb in range(1, 32):
        for i in range(8):
            a_idx.append(18 * sb - 1 - i)
            b_idx.append(18 * sb + i)
            cs.append(mp3_dsp.CS[i])
            ca.append(mp3_dsp.CA[i])
    return (
        np.array(a_idx, np.int32),
        np.array(b_idx, np.int32),
        np.array(cs, np.float32),
        np.array(ca, np.float32),
    )


@functools.lru_cache(maxsize=1)
def _win_bank() -> np.ndarray:
    """[4, 36] long-path windows by block type (type 2 row unused)."""
    return mp3_dsp.imdct_windows().astype(np.float32)


@dataclass
class GranuleBatch:
    quant: np.ndarray       # [B, C, 576] int32 (post-reorder for short)
    scale: np.ndarray       # [B, C, 576] f32
    ms: np.ndarray          # [B] bool
    block_type: np.ndarray  # [B, C] int32
    mixed: np.ndarray       # [B, C] bool
    n_alias_sb: np.ndarray  # [B, C] int32: boundaries to apply (0/1/31)
    lane_valid: np.ndarray  # [B, C] bool


def prepare_granule_batch(
    grs: List[Optional[List[Granule]]], hdrs: List[Optional[Mp3Header]], channels: int = 2
) -> GranuleBatch:
    """grs[b] = per-stream granule channel list (already parsed)."""
    B, C = len(grs), channels
    quant = np.zeros((B, C, 576), dtype=np.int32)
    scale = np.zeros((B, C, 576), dtype=np.float32)
    ms = np.zeros(B, dtype=bool)
    bt = np.zeros((B, C), dtype=np.int32)
    mixed = np.zeros((B, C), dtype=bool)
    nal = np.zeros((B, C), dtype=np.int32)
    valid = np.zeros((B, C), dtype=bool)
    for b, (chans, hdr) in enumerate(zip(grs, hdrs)):
        if chans is None or hdr is None:
            continue
        ms[b] = hdr.nb_channels == 2 and hdr.mode == 1 and bool(hdr.mode_ext & 2)
        for c, g in enumerate(chans[:C]):
            valid[b, c] = True
            xr_scale = g.exponents.astype(np.float32)
            q = g.spectrum
            if g.block_type == 2:
                # host-side reorder of ints + scales (pure permutation)
                q = mp3_dsp.reorder_short(g, hdr, q.astype(np.float64)).astype(np.int32)
                xr_scale = mp3_dsp.reorder_short(g, hdr, g.exponents).astype(np.float32)
            quant[b, c] = q
            scale[b, c] = xr_scale
            bt[b, c] = g.block_type
            mixed[b, c] = bool(g.switch_point)
            nal[b, c] = (
                0 if (g.block_type == 2 and not g.switch_point)
                else (1 if g.block_type == 2 else 31)
            )
    return GranuleBatch(quant, scale, ms, bt, mixed, nal, valid)


def mp3_granule_device(quant, scale, ms, block_type, mixed, n_alias_sb,
                       lane_valid, overlap, v_fifo):
    """One granule for all lanes.

    Returns (pcm [B, C, 576], new_overlap [B, C, 32, 18],
    new_v_fifo [B, C, 1024]).  jit me.

    Matmul precision pinned to float32 (see aac_batch: the GPU's TF32
    default would cap IMDCT/polyphase accuracy well below the oracle
    bars).
    """
    import jax

    with jax.default_matmul_precision("float32"):
        return _mp3_granule_device(quant, scale, ms, block_type, mixed,
                                   n_alias_sb, lane_valid, overlap, v_fifo)


def _mp3_granule_device(quant, scale, ms, block_type, mixed, n_alias_sb,
                        lane_valid, overlap, v_fifo):
    import jax.numpy as jnp

    B, C, _ = quant.shape
    L = B * C

    q = quant.astype(jnp.float32)
    xr = jnp.sign(q) * jnp.abs(q) ** (4.0 / 3.0) * scale

    # MS stereo (full spectrum)
    if C >= 2:
        inv = jnp.float32(1.0 / np.sqrt(2.0))
        m, s = xr[:, 0], xr[:, 1]
        l = jnp.where(ms[:, None], (m + s) * inv, m)
        r = jnp.where(ms[:, None], (m - s) * inv, s)
        xr = jnp.stack([l, r], axis=1)

    # alias reduction
    a_idx, b_idx, cs, ca = _alias_idx()
    a_idx_j = jnp.asarray(a_idx)
    b_idx_j = jnp.asarray(b_idx)
    cs_j = jnp.asarray(cs)
    ca_j = jnp.asarray(ca)
    xa = xr[..., a_idx_j]
    xb = xr[..., b_idx_j]
    # butterfly index boundary number = position // 8 + 1
    bnum = jnp.asarray((np.arange(248) // 8 + 1).astype(np.int32))
    active = bnum[None, None, :] <= n_alias_sb[..., None]
    new_a = jnp.where(active, xa * cs_j - xb * ca_j, xa)
    new_b = jnp.where(active, xb * cs_j + xa * ca_j, xb)
    xr = xr.at[..., a_idx_j].set(new_a)
    xr = xr.at[..., b_idx_j].set(new_b)

    flat = xr.reshape(L, 32, 18)

    # long IMDCT for all subbands
    M36 = jnp.asarray(mp3_dsp.imdct_matrix(36).astype(np.float32))
    wins = jnp.asarray(_win_bank())
    z_long = jnp.einsum("lsk,nk->lsn", flat, M36)  # [L, 32, 36]
    bt_f = block_type.reshape(L)
    # per-lane window: block type (mixed lanes use type 0 for sb 0/1)
    w_long = wins[jnp.where(bt_f == 2, 0, bt_f)]  # [L, 36]
    w_norm = wins[0]
    sb_ids = jnp.arange(32)[None, :, None]
    mixed_f = mixed.reshape(L)[:, None, None]
    w_sel = jnp.where(
        mixed_f & (sb_ids < 2), w_norm[None, None, :], w_long[:, None, :]
    )
    z_long = z_long * w_sel

    # short IMDCT: [L, 32, 3, 6] -> [L, 32, 3, 12]
    M12 = jnp.asarray(mp3_dsp.imdct_matrix(12).astype(np.float32))
    ws = jnp.asarray(mp3_dsp.short_window().astype(np.float32))
    xs = flat.reshape(L, 32, 6, 3)  # freq-major interleave: [f, w]
    xs = jnp.swapaxes(xs, 2, 3)  # [L, 32, 3, 6]
    zs = jnp.einsum("lswk,nk->lswn", xs, M12) * ws  # [L, 32, 3, 12]
    z_short = jnp.zeros((L, 32, 36), dtype=zs.dtype)
    for w in range(3):
        z_short = z_short.at[:, :, 6 + 6 * w : 18 + 6 * w].add(zs[:, :, w])

    is_short = (bt_f == 2)[:, None, None]
    sb_is_short = is_short & ~(mixed_f & (sb_ids < 2))
    z = jnp.where(sb_is_short, z_short, z_long)  # [L, 32, 36]
    z = z.reshape(B, C, 32, 36)

    out = z[..., :18] + overlap
    new_overlap = jnp.where(lane_valid[..., None, None], z[..., 18:], overlap)

    # frequency inversion
    inv_mask = np.ones((32, 18), np.float32)
    inv_mask[1::2, 1::2] = -1.0
    out = out * jnp.asarray(inv_mask)

    # polyphase synthesis: 18 rounds
    N = jnp.asarray(mp3_dsp.synth_matrix().astype(np.float32))
    D = jnp.asarray(mp3_dsp.synth_window().astype(np.float32))
    u_idx = jnp.asarray(_u_indices())
    fifo = v_fifo.reshape(L, 1024)
    outs = []
    out_l = out.reshape(L, 32, 18)
    for r in range(18):
        v = out_l[:, :, r] @ N.T  # [L, 64]
        fifo = jnp.concatenate([v, fifo[:, :960]], axis=1)
        u = fifo[:, u_idx]  # [L, 512]
        w = u * D
        outs.append(w.reshape(L, 16, 32).sum(axis=1))
    pcm = jnp.stack(outs, axis=1).reshape(B, C, 576)
    pcm = jnp.where(lane_valid[..., None], pcm, 0.0)
    new_fifo = jnp.where(
        lane_valid.reshape(L, 1)[..., None].reshape(L, 1), fifo, v_fifo.reshape(L, 1024)
    ).reshape(B, C, 1024)
    return pcm, new_overlap, new_fifo


def init_state(B: int, C: int = 2):
    return (
        np.zeros((B, C, 32, 18), dtype=np.float32),
        np.zeros((B, C, 1024), dtype=np.float32),
    )


def mp3_granule_device_compact(quant_i16, expq, ms, block_type, mixed,
                               n_alias_sb, lane_valid, overlap, v_fifo):
    """Compact-wire variant: int16 quant + int16 quarter-exponents
    (sentinel -32768 = silent line); scale reconstructed on device."""
    import jax.numpy as jnp

    scale = jnp.where(
        expq == -32768, 0.0, jnp.exp2(0.25 * expq.astype(jnp.float32))
    )
    return mp3_granule_device(
        quant_i16.astype(jnp.int32), scale, ms, block_type, mixed,
        n_alias_sb, lane_valid, overlap, v_fifo,
    )


def mp3_granules_device_compact_multi(quant_i16, expq, ms, block_type, mixed,
                                      n_alias_sb, lane_valid, overlap, v_fifo):
    """G granule batches in ONE device program: a ``lax.scan`` of the
    compact single-granule step over the leading G axis.

    Inputs are the compact wire with a [G, ...] granule axis; returns
    (pcm [G, B, C, 576], overlap, fifo).  One dispatch and one H2D
    transfer amortize G granules — the serving hot path's answer to
    per-granule dispatch overhead on thin links.  jit me.
    """
    import jax

    def step(carry, xs):
        ov, ff = carry
        q, e, m_, bt, mx, nal, lv = xs
        pcm, ov, ff = mp3_granule_device_compact(q, e, m_, bt, mx, nal, lv, ov, ff)
        return (ov, ff), pcm

    (overlap, v_fifo), pcm = jax.lax.scan(
        step, (overlap, v_fifo),
        (quant_i16, expq, ms, block_type, mixed, n_alias_sb, lane_valid),
    )
    return pcm, overlap, v_fifo


# ---------------------------------------------------------------------------
# packed wire: the whole granule batch in ONE host buffer / ONE
# transfer (same rationale as ops.aac_batch.compact_wire_layout —
# per-array jnp.asarray issue overhead dominates thin links)
# ---------------------------------------------------------------------------

def mp3_wire_layout(B: int):
    """(name, offset, dtype, shape) inside the packed uint8 granule
    wire + total bytes. Always carries both channels; the device step
    slices to the model's channel count."""
    fields = [
        ("bt", np.int32, (B, 2)),
        ("nal", np.int32, (B, 2)),
        ("quant", np.int16, (B, 2, 576)),
        ("expq", np.int16, (B, 2, 576)),
        ("mixed", np.uint8, (B, 2)),
        ("ms", np.uint8, (B,)),
        ("valid", np.uint8, (B, 2)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


def unpack_mp3_wire(buf, B: int):
    import jax.numpy as jnp
    from jax import lax

    out = {}
    for name, off, dt, shp in mp3_wire_layout(B)[0]:
        n = int(np.prod(shp))
        width = np.dtype(dt).itemsize
        raw = lax.slice(buf, (off,), (off + n * width,))
        if width == 1:  # every 1-byte field here is uint8
            x = raw
        else:
            x = lax.bitcast_convert_type(raw.reshape(n, width), jnp.dtype(dt))
        out[name] = x.reshape(shp)
    return out


def mp3_granule_device_compact_packed(buf, overlap, v_fifo):
    """One-transfer variant of :func:`mp3_granule_device_compact`;
    ``buf`` from models.mp3_batch_model.BatchedMp3Decoder (packed pop)."""
    B, C = overlap.shape[0], overlap.shape[1]
    f = unpack_mp3_wire(buf, B)
    return mp3_granule_device_compact(
        f["quant"][:, :C], f["expq"][:, :C], f["ms"] != 0,
        f["bt"][:, :C], f["mixed"][:, :C] != 0, f["nal"][:, :C],
        f["valid"][:, :C] != 0, overlap, v_fifo,
    )
