"""MP3 Layer III numeric decode: requantize, stereo, alias reduction,
IMDCT, polyphase synthesis filterbank.

These are the north-star device kernels (BASELINE.json: "nanomp3's
IMDCT + polyphase synthesis filterbank" as batched kernels): the IMDCT
is a [18 -> 36] matmul per subband and the synthesis filterbank is a
[32 -> 64] matmul plus a windowed FIFO dot — both matmul-shaped.  This
module is the numpy reference; ``ops.mp3_batch`` runs the same
matrices under jnp over ``[streams, ...]``.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from soundkit_tpu.codecs.mp3_native import Granule, Mp3Frame, Mp3Header, _tables

# alias-reduction coefficients (ISO 11172-3 Table B.9 ci values)
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
CA = _CI * CS


@functools.lru_cache(maxsize=4)
def imdct_matrix(n_out: int) -> np.ndarray:
    """[n_out, n_out//2] IMDCT: x[n] = sum_k X[k] cos(pi/(2N)(2n+1+N/2)(2k+1))."""
    N = n_out
    half = N // 2
    n = np.arange(N)[:, None]
    k = np.arange(half)[None, :]
    return np.cos(np.pi / (2 * N) * (2 * n + 1 + half) * (2 * k + 1))


@functools.lru_cache(maxsize=1)
def imdct_windows() -> np.ndarray:
    """[4, 36] windows for block types 0..3 (type 2 = short, unused here)."""
    w = np.zeros((4, 36))
    n = np.arange(36)
    w[0] = np.sin(np.pi / 36 * (n + 0.5))
    w[1, :18] = np.sin(np.pi / 36 * (n[:18] + 0.5))
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
    w[3, 6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
    w[3, 12:18] = 1.0
    w[3, 18:] = np.sin(np.pi / 36 * (n[18:] + 0.5))
    return w


@functools.lru_cache(maxsize=1)
def short_window() -> np.ndarray:
    return np.sin(np.pi / 12 * (np.arange(12) + 0.5))


@functools.lru_cache(maxsize=1)
def synth_matrix() -> np.ndarray:
    """[64, 32] polyphase matrixing: N[i][k] = cos((16+i)(2k+1) pi/64)."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64)


@functools.lru_cache(maxsize=1)
def synth_window() -> np.ndarray:
    """[512] ISO Table B.3 D window from the extracted enwindow
    half-table (enwindow = D * 65536).

    Mirror structure (validated to 126 dB vs oracle): D[i] = E[i] for
    i <= 256; D[512-i] = -E[i], EXCEPT +E[i] at i in {64, 128, 192}
    (the positions feeding output sample 0 of each 32-round).
    """
    e = _tables()["enwindow"].astype(np.float64) / 65536.0
    d = np.zeros(512)
    d[:257] = e
    for i in range(1, 256):
        d[512 - i] = (e[i] if (i & 63) == 0 else -e[i])
    return d


def requantize(gr: Granule) -> np.ndarray:
    q = gr.spectrum.astype(np.float64)
    return np.sign(q) * np.abs(q) ** (4.0 / 3.0) * gr.exponents


def reorder_short(gr: Granule, hdr: Mp3Header, xr: np.ndarray) -> np.ndarray:
    """Band-ordered short data -> [f0w0 f0w1 f0w2 f1w0 ...] per subband."""
    if gr.block_type != 2:
        return xr
    t = _tables()
    sizes = t["band_size_short"][hdr.sr_index]
    out = xr.copy()
    start = 36 if gr.switch_point else 0
    first_band = 3 if gr.switch_point else 0
    pos = start
    for b in range(first_band, 13):
        size = int(sizes[b])
        block = xr[pos : pos + 3 * size]
        if len(block) < 3 * size:
            break
        resh = block.reshape(3, size).T.reshape(-1)  # window-major -> freq-major
        out[pos : pos + 3 * size] = resh
        pos += 3 * size
    return out


def apply_ms(xr0: np.ndarray, xr1: np.ndarray) -> None:
    m = xr0.copy()
    s = xr1.copy()
    inv = 1.0 / np.sqrt(2.0)
    xr0[:] = (m + s) * inv
    xr1[:] = (m - s) * inv


def apply_intensity_mpeg1(
    gr1: Granule, hdr: Mp3Header, xr0: np.ndarray, xr1: np.ndarray
) -> None:
    """Basic MPEG-1 intensity stereo for long blocks: bands above the
    right channel's last nonzero line."""
    t = _tables()
    band_index = np.concatenate([[0], np.cumsum(t["band_size_long"][hdr.sr_index])])
    nz = np.nonzero(xr1)[0]
    bound = int(nz[-1]) + 1 if len(nz) else 0
    for b in range(21):
        lo, hi = int(band_index[b]), int(band_index[b + 1])
        if lo < bound:
            continue
        is_pos = int(gr1.scale_factors[b]) if b < 21 else 7
        if is_pos >= 7:
            continue
        ratio = np.tan(is_pos * np.pi / 12.0)
        l = xr0[lo:hi].copy()
        xr0[lo:hi] = l * (ratio / (1.0 + ratio))
        xr1[lo:hi] = l * (1.0 / (1.0 + ratio))


def antialias(gr: Granule, xr: np.ndarray) -> None:
    if gr.block_type == 2 and not gr.switch_point:
        return
    n_bound = 1 if (gr.block_type == 2 and gr.switch_point) else 31
    for sb in range(1, n_bound + 1):
        base = 18 * sb
        for i in range(8):
            a = xr[base - 1 - i]
            b = xr[base + i]
            xr[base - 1 - i] = a * CS[i] - b * CA[i]
            xr[base + i] = b * CS[i] + a * CA[i]


class ChannelSynth:
    """IMDCT + overlap + frequency inversion + polyphase with state."""

    def __init__(self) -> None:
        self.overlap = np.zeros((32, 18))
        self.v = np.zeros(1024)  # polyphase FIFO

    def granule(self, gr: Granule, hdr: Mp3Header, xr: np.ndarray) -> np.ndarray:
        """One granule [576] -> 576 PCM samples (mono channel)."""
        # IMDCT per subband
        sb_out = np.zeros((32, 36))
        M36 = imdct_matrix(36)
        M12 = imdct_matrix(12)
        wins = imdct_windows()
        ws = short_window()
        for sb in range(32):
            X = xr[18 * sb : 18 * (sb + 1)]
            long_block = gr.block_type != 2 or (gr.switch_point and sb < 2)
            if long_block:
                bt = gr.block_type if not (gr.switch_point and sb < 2) else (
                    gr.block_type if gr.block_type != 2 else 0
                )
                z = (M36 @ X) * wins[bt if bt != 2 else 0]
                sb_out[sb] = z
            else:
                z = np.zeros(36)
                for w in range(3):
                    sub = (M12 @ X[w::3][:6]) * ws
                    z[6 + 6 * w : 18 + 6 * w] += sub
                sb_out[sb] = z

        # overlap-add
        out = sb_out[:, :18] + self.overlap
        self.overlap = sb_out[:, 18:].copy()

        # frequency inversion: odd subbands, odd samples
        out[1::2, 1::2] *= -1.0

        # polyphase synthesis: 18 rounds of 32 -> 32
        N = synth_matrix()
        D = synth_window()
        pcm = np.zeros(576)
        for r in range(18):
            s = out[:, r]
            v = N @ s  # [64]
            self.v = np.roll(self.v, 64)
            self.v[:64] = v
            # build U[512]
            u = np.zeros(512)
            for i in range(8):
                u[64 * i : 64 * i + 32] = self.v[128 * i : 128 * i + 32]
                u[64 * i + 32 : 64 * i + 64] = self.v[128 * i + 96 : 128 * i + 128]
            w = u * D
            pcm[32 * r : 32 * r + 32] = w.reshape(16, 32).sum(axis=0)
        return pcm


class Mp3Synth:
    """Full frame synthesis over parsed granules."""

    def __init__(self) -> None:
        self.channels: List[ChannelSynth] = []

    def _ch(self, i: int) -> ChannelSynth:
        while len(self.channels) <= i:
            self.channels.append(ChannelSynth())
        return self.channels[i]

    def process_frame(self, frame: Mp3Frame) -> np.ndarray:
        """Returns [channels, samples] float."""
        hdr = frame.header
        nch = hdr.nb_channels
        outs = [[] for _ in range(nch)]
        for granules in frame.granules:
            xrs = [requantize(g) for g in granules]
            xrs = [reorder_short(g, hdr, x) for g, x in zip(granules, xrs)]
            if nch == 2 and hdr.mode == 1:
                if hdr.mode_ext & 2:
                    apply_ms(xrs[0], xrs[1])
                if hdr.mode_ext & 1 and granules[1].block_type != 2:
                    apply_intensity_mpeg1(granules[1], hdr, xrs[0], xrs[1])
            for c in range(nch):
                antialias(granules[c], xrs[c])
                outs[c].append(self._ch(c).granule(granules[c], hdr, xrs[c]))
        return np.stack([np.concatenate(o) for o in outs])
