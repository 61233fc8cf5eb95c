"""Probe libswresample's SILK -> 48 kHz resampler into a committed
table (native/generated/silk_resampler.npz).

The SILK decoders upsample their 8/12/16 kHz output to 48 kHz exactly
like the libavcodec opus decoder: libswresample with filter_size 16,
defaults otherwise, and a bandwidth-dependent zero preroll that
compensates the FIR delay.  That stream map is linear, and
time-invariant after its first few outputs, so impulse probes give it
completely: per-phase FIR taps, an output offset, the start-up
correction, and the output count.  ``utils/swr.SilkResampler``
evaluates the table, so serving needs no libav.

Run:  python -m soundkit_tpu.native.tools.gen_silk_resampler
(needs libswresample; only when the table has to be regenerated)
"""
from __future__ import annotations

import ctypes

import numpy as np

_AV_SAMPLE_FMT_FLT = 3
_LAYOUT_MONO = 4
_LAYOUT_STEREO = 3

# resampler group delay at the SILK rate, per bandwidth (NB/MB/WB),
# matching the oracle's silk_resample_delay table
SILK_RESAMPLE_DELAY = {0: 4, 1: 8, 2: 11}


class _Libs:
    _cached = None

    @classmethod
    def get(cls):
        if cls._cached is None:
            swr = ctypes.CDLL("libswresample.so.4", mode=ctypes.RTLD_GLOBAL)
            util = ctypes.CDLL("libavutil.so", mode=ctypes.RTLD_GLOBAL)
            swr.swr_alloc.restype = ctypes.c_void_p
            swr.swr_init.argtypes = [ctypes.c_void_p]
            swr.swr_convert.restype = ctypes.c_int
            swr.swr_convert.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ]
            swr.swr_free.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
            util.av_opt_set_int.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int,
            ]
            cls._cached = (swr, util)
        return cls._cached


class SwrResampler:
    """libswresample streaming FLT resampler: push SILK-rate samples,
    get 48 kHz."""

    def __init__(self, in_rate: int, bandwidth: int, channels: int = 1):
        swr, util = _Libs.get()
        self._swr = swr
        self._ctx = ctypes.c_void_p(swr.swr_alloc())
        if not self._ctx:
            raise RuntimeError("swr_alloc failed")
        layout = _LAYOUT_MONO if channels == 1 else _LAYOUT_STEREO
        for name, val in (
            (b"in_sample_fmt", _AV_SAMPLE_FMT_FLT),
            (b"out_sample_fmt", _AV_SAMPLE_FMT_FLT),
            (b"in_channel_layout", layout),
            (b"out_channel_layout", layout),
            (b"out_sample_rate", 48000),
            (b"filter_size", 16),
            (b"in_sample_rate", in_rate),
        ):
            util.av_opt_set_int(self._ctx, name, val, 0)
        if swr.swr_init(self._ctx) != 0:
            raise RuntimeError("swr_init failed")
        self.channels = channels
        # zero preroll to compensate the FIR group delay
        delay = SILK_RESAMPLE_DELAY[bandwidth]
        silence = np.zeros(delay * channels, dtype=np.float32)
        self._convert(silence, delay, 0)

    def _convert(self, data: np.ndarray, n_in: int, n_out: int
                 ) -> np.ndarray:
        out = np.zeros(max(n_out, 1) * self.channels, dtype=np.float32)
        inptr = (ctypes.c_void_p * 1)(
            ctypes.cast(
                data.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p
            )
            if n_in else None
        )
        outptr = (ctypes.c_void_p * 1)(
            ctypes.cast(out.ctypes.data_as(ctypes.c_void_p),
                        ctypes.c_void_p)
        )
        got = self._swr.swr_convert(self._ctx, outptr, n_out,
                                    inptr if n_in else None, n_in)
        if got < 0:
            raise RuntimeError("swr_convert failed")
        return out[: got * self.channels]

    def process(self, pcm: np.ndarray, out_samples: int) -> np.ndarray:
        """pcm: [n, ch] float at the SILK rate; returns [m, ch] f32 at
        48 kHz with m <= out_samples (the oracle requests exactly the
        packet duration per superframe; the first NB frame comes up 24
        samples short of it — the oracle's delayed_samples)."""
        flat = np.ascontiguousarray(
            pcm.astype(np.float32).reshape(-1)
        )
        out = self._convert(flat, pcm.shape[0], out_samples)
        return out.reshape(-1, self.channels)

    def drain(self, out_samples: int) -> np.ndarray:
        """Flush up to ``out_samples`` buffered samples (NULL-input
        convert), the oracle's opus_flush_resample on a bandwidth
        switch."""
        if out_samples <= 0:
            return np.zeros((0, self.channels), dtype=np.float32)
        out = self._convert(
            np.zeros(0, dtype=np.float32), 0, out_samples)
        return out.reshape(-1, self.channels)

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._swr.swr_free(ctypes.byref(self._ctx))
                self._ctx = None
        except Exception:
            pass


RATES = (8000, 12000, 16000)
FILTER_LENGTH = 16  # filter_size 16 at an upsampling ratio
START_ROWS = 1920   # outputs covered by the start-up correction
START_INPUTS = 48   # inputs whose impulse responses it covers


def _impulse(rate: int, bw: int, k: int, n_in: int) -> np.ndarray:
    r = SwrResampler(rate, bw, 1)
    x = np.zeros((n_in, 1))
    x[k, 0] = 1.0
    return r.process(x, 100 * n_in)[:, 0].astype(np.float64)


def probe(bw: int) -> dict:
    """Probe one bandwidth: taps [R, J], off, delay, corr [M0, K0]
    with the stream map (zero state at the start)

        y[m] = sum_j taps[p, j] * x[n - j] + sum_k corr[m, k] * x[k]
        n = (m - off) // R,  p = (m - off) % R,

    and R * (inputs so far) - delay outputs available."""
    rate = RATES[bw]
    R = 48000 // rate
    n_in = 400
    probe_n = 200  # clear of the start-up transient
    y = _impulse(rate, bw, probe_n, n_in)
    delay = R * n_in - len(y)
    nz = np.flatnonzero(np.abs(y) > 0)
    off = int(nz[0]) - probe_n * R
    J = -(-(int(nz[-1]) - int(nz[0]) + 1) // R)
    taps = np.zeros((R, J))
    for j in range(J):
        for p in range(R):
            m = off + R * (probe_n + j) + p
            if 0 <= m < len(y):
                taps[p, j] = y[m]
    m = np.arange(START_ROWS)
    n = (m - off) // R
    p = (m - off) % R
    corr = np.zeros((START_ROWS, START_INPUTS))
    for k in range(START_INPUTS):
        got = _impulse(rate, bw, k, n_in)[:START_ROWS]
        j = n - k
        ok = (j >= 0) & (j < J)
        plan = np.where(ok, taps[p, np.clip(j, 0, J - 1)], 0.0)
        corr[: len(got), k] = got - plan[: len(got)]
    corr[np.abs(corr) < 1e-9] = 0.0
    return {"taps": taps, "off": off, "delay": delay, "corr": corr}


def main() -> None:
    from pathlib import Path

    out = {}
    for bw in range(3):
        for key, val in probe(bw).items():
            out[f"{key}_{bw}"] = np.asarray(val)
    path = (Path(__file__).resolve().parent.parent / "generated"
            / "silk_resampler.npz")
    np.savez_compressed(path, **out)
    print("wrote", path)


if __name__ == "__main__":
    main()
