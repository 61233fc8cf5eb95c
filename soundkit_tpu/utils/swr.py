"""SILK 8/12/16 kHz -> 48 kHz resampler, matched to the libavcodec opus
decoder's libswresample setup (filter_size 16, defaults otherwise, and
the bandwidth-dependent zero preroll that compensates the FIR delay).

That stream map is linear and time-invariant after its first few
outputs, so it is stored as a probed table
(native/generated/silk_resampler.npz, written by
``native/tools/gen_silk_resampler.py``): per-phase FIR taps, the
output offset, the start-up correction and the output count.  This
module evaluates the table in float64 and agrees with libswresample's
float32 stream to ~1e-7.  Only the resampling follows the oracle (the
reference delegates its resampling to the rubato crate the same way);
the SILK codec math itself is owned (codecs/opus_silk.py).
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

#: libswresample's filter length at these ratios; a flush appends
#: half of it, mirrored, to the buffered input
_FILTER_LENGTH = 16

_TABLE = (Path(__file__).resolve().parent.parent / "native" / "generated"
          / "silk_resampler.npz")


@functools.lru_cache(maxsize=3)
def _table(bw: int):
    t = np.load(_TABLE)
    return (t[f"taps_{bw}"], int(t[f"off_{bw}"]), int(t[f"delay_{bw}"]),
            t[f"corr_{bw}"])


class SilkResampler:
    """Streaming resampler: push SILK-rate samples, get 48 kHz f32."""

    def __init__(self, in_rate: int, bandwidth: int, channels: int = 1):
        self._taps, self._off, self._delay, self._corr = _table(bandwidth)
        self._R = 48000 // in_rate
        if self._R != self._taps.shape[0]:
            raise ValueError(f"rate {in_rate} does not match bandwidth "
                             f"{bandwidth}")
        self.channels = channels
        # inputs from global index ``_base`` on (the table already holds
        # the zero preroll's effect on the stream), the first inputs
        # for the start-up correction, and the input count
        self._x = np.zeros((0, channels))
        self._base = 0
        self._head = np.zeros((0, channels))
        self._n = 0
        self._emitted = 0

    def _outputs(self, m0: int, m1: int) -> np.ndarray:
        """Stream outputs y[m0:m1] from the inputs buffered so far."""
        taps, off, R = self._taps, self._off, self._R
        J = taps.shape[1]
        m = np.arange(m0, m1)
        n = (m - off) // R
        p = (m - off) % R
        k = n[:, None] - np.arange(J)[None, :]            # [M, J]
        ok = (k >= 0) & (k < self._n)
        kx = np.clip(k - self._base, 0, max(self._x.shape[0] - 1, 0))
        xk = self._x[kx] if self._x.shape[0] else np.zeros(
            k.shape + (self.channels,))                    # [M, J, C]
        y = np.einsum("mj,mjc->mc", np.where(ok, taps[p], 0.0), xk)
        rows = self._corr.shape[0]
        if m0 < rows:
            head = self._head
            y[: rows - m0] += (self._corr[m0:min(m1, rows), : head.shape[0]]
                               @ head)
        return y.astype(np.float32)

    def _append(self, x: np.ndarray) -> None:
        k0 = self._corr.shape[1]
        if self._head.shape[0] < k0:
            self._head = np.concatenate([self._head, x])[:k0]
        self._x = np.concatenate([self._x, x])
        self._n += x.shape[0]

    def _take(self, out_samples: int) -> np.ndarray:
        avail = self._R * self._n - self._delay
        n = max(0, min(out_samples, avail - self._emitted))
        y = self._outputs(self._emitted, self._emitted + n)
        self._emitted += n
        # keep only the inputs the next output can still reach
        keep = max((self._emitted - self._off) // self._R
                   - self._taps.shape[1], 0)
        if keep > self._base:
            self._x = self._x[keep - self._base:]
            self._base = keep
        return y

    def process(self, pcm: np.ndarray, out_samples: int) -> np.ndarray:
        """pcm: [n, ch] float at the SILK rate; returns [m, ch] f32 at
        48 kHz with m <= out_samples (the oracle requests exactly the
        packet duration per superframe; the first NB frame comes up 24
        samples short of it — the oracle's delayed_samples)."""
        x = np.asarray(pcm, np.float32).astype(np.float64)
        self._append(x.reshape(-1, self.channels))
        return self._take(out_samples)

    def drain(self, out_samples: int) -> np.ndarray:
        """Flush up to ``out_samples`` buffered samples, the oracle's
        opus_flush_resample on a bandwidth switch: libswresample pads
        the input with a mirror of its last samples, then emits."""
        if out_samples <= 0:
            return np.zeros((0, self.channels), dtype=np.float32)
        reflect = (min(self._n, _FILTER_LENGTH) + 1) // 2
        self._append(self._x[self._x.shape[0] - reflect:][::-1])
        return self._take(out_samples)
