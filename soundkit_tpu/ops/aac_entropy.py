"""Device AAC spectral entropy decoder — the SIMD bitstream interpreter.

The host syntax parse costs ~8-10 ms per 1024-lane
batch and the v3 wire ~3.6 KB/lane, versus ~0.04 ms of device compute —
the spectral Huffman decode is ~80% of that host cost and ~85% of those
wire bytes.  This module moves the spectral VLC decode onto the chip:

- lanes ship their RAW access-unit bytes (~0.5 KB) plus a small
  per-band "section program" (codebook, codeword count, output base per
  (group, sfb, window) run, <=512 B/lane) and the bit offset where each
  channel's spectral_data starts,
- the device runs one `lax.while_loop` whose body decodes ONE Huffman
  codeword PER LANE per iteration: 32-bit window gather from the lane's
  AU words, one flat 16-bit-prefix LUT lookup (11 codebooks x 65536
  int32 entries, values pre-unpacked into the entry), branchless sign
  extraction, and the codebook-11 escape (count-leading-ones via
  `lax.clz` + explicit mantissa bits), then scatters up to 4 quantized
  lines into the output buffer.  All ~300-500 sequential codewords of a
  frame amortize across the full lane batch each step (SPMD over
  lanes, not bits).

Numerically equal to the host parsers' quantized spectrum
(tests/test_aac_entropy.py runs it over the full fixture corpus).

Reference hot loop being replaced:
soundkit-aac-lc/src/spectral.rs:742-995 (table-driven VLC on the host).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

MAX_RUNS = 192     # (group, sfb, window) band runs per channel
MAX_AU_BYTES = 1536
LUT_BITS = 16

_CB_INFO = {
    1: (4, 3, True), 2: (4, 3, True),
    3: (4, 3, False), 4: (4, 3, False),
    5: (2, 9, True), 6: (2, 9, True),
    7: (2, 8, False), 8: (2, 8, False),
    9: (2, 13, False), 10: (2, 13, False),
    11: (2, 17, False),
}


@functools.lru_cache(maxsize=1)
def _raw_tables():
    from soundkit_tpu.codecs.aac_lc import TABLES_PATH

    return dict(np.load(TABLES_PATH))


@functools.lru_cache(maxsize=1)
def build_spectral_lut() -> np.ndarray:
    """[11, 2^16] int32: entry = len(5 bits, 0 = invalid) |
    (val0+16)<<5 | (val1+16)<<11 | (val2+16)<<17 | (val3+16)<<23.

    For signed codebooks the values are final; for unsigned ones they
    are magnitudes (signs stream after the codeword).  Codebook 11
    magnitudes of 16 mark escapes.
    """
    from soundkit_tpu.codecs.aac_lc import _unpack_index

    t = _raw_tables()
    lut = np.zeros((11, 1 << LUT_BITS), dtype=np.int32)
    for cb in range(1, 12):
        codes = t[f"spectral_codes_{cb - 1}"]
        bits = t[f"spectral_bits_{cb - 1}"]
        dim, base, signed = _CB_INFO[cb]
        for idx, (code, ln) in enumerate(zip(codes, bits)):
            ln = int(ln)
            if ln == 0:
                continue
            vals = _unpack_index(cb, idx)
            packed = ln
            for i in range(4):
                v = vals[i] if i < dim else 0
                packed |= (v + 16) << (5 + 6 * i)
            lo = int(code) << (LUT_BITS - ln)
            hi = lo + (1 << (LUT_BITS - ln))
            lut[cb - 1, lo:hi] = packed
    return lut


def section_runs(band_type, group_lens, swb_offset, max_sfb, short: bool):
    """Flatten the (group, sfb, window) spectral walk into decode-order
    runs of (codebook, n_codewords, out_start).  Mirrors the host walk
    in codecs/aac_lc.py spectral_data."""
    runs: List[Tuple[int, int, int]] = []
    win_base = []
    acc = 0
    for g in range(len(group_lens)):
        win_base.append(acc)
        acc += group_lens[g]
    for g in range(len(group_lens)):
        for s in range(max_sfb):
            cb = int(band_type[g][s] if hasattr(band_type, "__getitem__") else 0)
            if cb == 0 or cb >= 13 or cb == 12:
                continue
            lo = int(swb_offset[s])
            hi = int(swb_offset[s + 1])
            dim = _CB_INFO[cb][0]
            n_cw = (hi - lo + dim - 1) // dim
            for w in range(group_lens[g]):
                off = (win_base[g] + w) * 128 if short else 0
                runs.append((cb, n_cw, off + lo))
    if len(runs) > MAX_RUNS:
        raise ValueError(f"{len(runs)} runs > MAX_RUNS")
    return runs


def pack_au_words(aus: List[bytes]) -> np.ndarray:
    """[B, MAX_AU_BYTES//4] uint32, big-endian within each word."""
    B = len(aus)
    buf = np.zeros((B, MAX_AU_BYTES), dtype=np.uint8)
    for b, au in enumerate(aus):
        n = min(len(au), MAX_AU_BYTES)
        buf[b, :n] = np.frombuffer(au[:n], np.uint8)
    return buf.reshape(B, -1, 4)[..., ::-1].copy().view(np.uint32).reshape(B, -1)


def pack_runs(all_runs: List[List[Tuple[int, int, int]]]):
    B = len(all_runs)
    cb = np.zeros((B, MAX_RUNS), np.int32)
    ncw = np.zeros((B, MAX_RUNS), np.int32)
    out = np.zeros((B, MAX_RUNS), np.int32)
    nr = np.zeros(B, np.int32)
    for b, runs in enumerate(all_runs):
        nr[b] = len(runs)
        for i, (c, n, o) in enumerate(runs):
            cb[b, i] = c
            ncw[b, i] = n
            out[b, i] = o
    return cb, ncw, out, nr


# ---------------------------------------------------------------------------
# device interpreter
# ---------------------------------------------------------------------------

def max_steps_for(runs_ncw, n_runs, bucket: int = 64) -> int:
    """Static scan length covering the worst lane, rounded up to a
    bucket so jit caches stay warm across batches."""
    per_lane = np.where(
        np.arange(runs_ncw.shape[1])[None, :] < np.asarray(n_runs)[:, None],
        np.asarray(runs_ncw), 0,
    ).sum(axis=1)
    worst = int(per_lane.max()) if per_lane.size else 0
    return max(((worst + bucket - 1) // bucket) * bucket, bucket)


def aac_spectral_decode_device(words, bitpos0, runs_cb, runs_ncw, runs_out,
                               n_runs, max_steps: int = 0):
    """Decode every lane's spectral codewords -> quant [B, 1024] int32.

    words:   [B, W] uint32 big-endian AU words
    bitpos0: [B] int32 bit offset of the channel's spectral_data
    runs_*:  [B, MAX_RUNS] the section program, n_runs [B]
    max_steps: static scan length (see max_steps_for); 0 = data-
      dependent while_loop.  Serving uses the fixed-length scan,
      whose static length keys the compile cache; each iteration
      decodes one codeword on every lane.

    One iteration = one codeword on every active lane.  jit with
    static_argnums=(6,) (integer-only; no precision concerns).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    B, W = words.shape
    lut = jnp.asarray(build_spectral_lut())  # [11, 65536]
    lanes = jnp.arange(B)

    # per-codebook static props as gatherable vectors (index cb-1)
    cb_range = np.arange(1, 12)
    dim_v = jnp.asarray([_CB_INFO[c][0] for c in cb_range], jnp.int32)
    signed_v = jnp.asarray([1 if _CB_INFO[c][2] else 0 for c in cb_range],
                           jnp.int32)

    def window32(bitpos):
        """Next 32 bits MSB-first at bitpos for each lane (uint32)."""
        wi = (bitpos >> 5).astype(jnp.int32)
        sh = (bitpos & 31).astype(jnp.uint32)
        w0 = jnp.take_along_axis(words, wi[:, None] % W, axis=1)[:, 0]
        w1 = jnp.take_along_axis(words, (wi[:, None] + 1) % W, axis=1)[:, 0]
        hi = jnp.where(sh == 0, w0, (w0 << sh))
        lo = jnp.where(sh == 0, jnp.uint32(0), (w1 >> (jnp.uint32(32) - sh)))
        return hi | lo

    def bits_top(win, n):
        """Top ``n`` bits of the 32-bit window (n may be 0)."""
        return jnp.where(n == 0, jnp.uint32(0),
                         win >> (jnp.uint32(32) - n.astype(jnp.uint32)))

    quant0 = jnp.zeros((B, 1056), jnp.int32)  # 1024 + spill for inactive

    def cond(state):
        bitpos, run_i, cw_i, quant = state
        return jnp.any(run_i < n_runs)

    def body(state):
        bitpos, run_i, cw_i, quant = state
        active = run_i < n_runs
        ri = jnp.minimum(run_i, MAX_RUNS - 1)
        cb = jnp.take_along_axis(runs_cb, ri[:, None], axis=1)[:, 0]
        cb = jnp.maximum(cb, 1)
        ncw = jnp.take_along_axis(runs_ncw, ri[:, None], axis=1)[:, 0]
        base = jnp.take_along_axis(runs_out, ri[:, None], axis=1)[:, 0]
        dim = dim_v[cb - 1]
        is_signed = signed_v[cb - 1] == 1

        # -- codeword ------------------------------------------------------
        win = window32(bitpos)
        idx16 = (win >> jnp.uint32(32 - LUT_BITS)).astype(jnp.int32)
        entry = lut[cb - 1, idx16]
        cw_len = entry & 31
        vals = jnp.stack(
            [((entry >> (5 + 6 * i)) & 63) - 16 for i in range(4)], axis=1
        )  # [B, 4] signed values or magnitudes
        in_dim = jnp.arange(4)[None, :] < dim[:, None]
        vals = jnp.where(in_dim, vals, 0)
        bitpos = jnp.where(active, bitpos + cw_len, bitpos)

        # -- sign bits (unsigned codebooks) --------------------------------
        nz = (vals != 0) & in_dim
        need_sign = nz & (~is_signed[:, None])
        # bit index for value i = number of sign-needing values before i
        before = jnp.cumsum(need_sign.astype(jnp.int32), axis=1) - need_sign
        swin = window32(bitpos)
        sbit = (swin[:, None] >> (jnp.uint32(31) - before.astype(jnp.uint32))) & 1
        vals = jnp.where(need_sign & (sbit == 1), -vals, vals)
        nsign = jnp.sum(need_sign, axis=1)
        bitpos = jnp.where(active, bitpos + nsign, bitpos)

        # -- codebook 11 escapes (|v| == 16), value 0 then value 1 ---------
        def do_escape(i, carry):
            bitpos, vals = carry
            v = vals[:, i]
            esc = (jnp.abs(v) == 16) & (cb == 11) & active
            ewin = window32(bitpos)
            n1 = jax.lax.clz(~ewin)  # leading ones
            n1 = jnp.minimum(n1, 24).astype(jnp.int32)
            n = 4 + n1
            bitpos_e = bitpos + n1 + 1
            mwin = window32(bitpos_e)
            mant = bits_top(mwin, n).astype(jnp.int32)
            mag = (1 << n) | mant
            newv = jnp.where(v < 0, -mag, mag)
            vals = vals.at[:, i].set(jnp.where(esc, newv, v))
            bitpos = jnp.where(esc, bitpos_e + n, bitpos)
            return bitpos, vals

        bitpos, vals = do_escape(0, (bitpos, vals))
        bitpos, vals = do_escape(1, (bitpos, vals))

        # -- scatter the up-to-4 lines ------------------------------------
        pos = base + cw_i * dim
        # clip the final partial codeword of a band to the band width:
        # out positions beyond the next run's base would overrun; the
        # host walk never reads past hi, and n_cw*dim == width for all
        # real swb widths (all are multiples of 4), so plain writes are
        # exact; inactive lanes write to the spill region
        for i in range(4):
            tgt = jnp.where(active & (i < dim), pos + i, 1040)
            quant = quant.at[lanes, tgt].set(
                jnp.where(active, vals[:, i], 0), mode="drop"
            )

        # -- advance run/codeword counters ---------------------------------
        cw_next = cw_i + 1
        done_run = cw_next >= ncw
        run_i = jnp.where(active & done_run, run_i + 1, run_i)
        cw_i = jnp.where(active, jnp.where(done_run, 0, cw_next), cw_i)
        return bitpos, run_i, cw_i, quant

    bitpos = bitpos0.astype(jnp.int32)
    run_i = jnp.zeros(B, jnp.int32)
    cw_i = jnp.zeros(B, jnp.int32)
    state = (bitpos, run_i, cw_i, quant0)
    if max_steps:
        def scan_body(st, _):
            return body(st), None

        state, _ = jax.lax.scan(scan_body, state, None, length=max_steps)
        bitpos, run_i, cw_i, quant = state
    else:
        bitpos, run_i, cw_i, quant = jax.lax.while_loop(cond, body, state)
    return quant[:, :1024]
