"""Windowed-sinc polyphase resampler.

Batched device equivalent of rubato 0.14 ``SincFixedIn`` as configured by
the reference (sinc_len 256, f_cutoff 0.95, oversampling 256,
BlackmanHarris2 window — ``soundkit/src/audio_pipeline.rs:188-194``,
``soundkit-decoder/src/lib.rs:109-123``).

Because the supported rate matrix is whitelisted rational ratios
(audio_pipeline.rs:10-12), we use an *exact* polyphase decomposition
(L = out/gcd phases) instead of rubato's oversample-and-interpolate
scheme: the L phase filters are sliced from one upsampled prototype,
and the whole conversion lowers to ONE strided conv with L output
channels — an im2col matmul when batched over streams.
The reference itself only asserts output-length consistency between
streaming and one-shot paths (soundkit-decoder/src/lib.rs:3084-3134);
sample-level parity with rubato is approximate by construction and the
quality bar is enforced by SNR tests instead.

Output contract (both host and device paths, used by the streaming
wrapper for chunk invariance): after T total input frames, exactly
``ceil(T * L / M)`` output frames exist; output k is the filtered
estimate of input position ``k*M/L`` delayed by ``sinc_len/2`` input
frames.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

SINC_LEN = 256
CUTOFF = 0.95


def _blackman_harris2(x: np.ndarray) -> np.ndarray:
    """Squared 4-term Blackman-Harris over x in [0, 1] (rubato BlackmanHarris2)."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * x)
        + a2 * np.cos(4 * np.pi * x)
        - a3 * np.cos(6 * np.pi * x)
    )
    return w * w


@functools.lru_cache(maxsize=64)
def design_polyphase(
    in_rate: int, out_rate: int, sinc_len: int = SINC_LEN, cutoff: float = CUTOFF
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Design the polyphase bank for in_rate -> out_rate.

    Returns ``(taps_rev, offsets, L, M)`` where ``taps_rev[p, q]`` are
    the phase-p taps ordered for correlation (y[c*L+p] =
    sum_q taps_rev[p, q] * xpad[c*M + offsets[p] + q]) over input
    padded on the left with ``sinc_len - 1`` zeros, and ``offsets[p] =
    floor(p*M/L)``.
    """
    g = math.gcd(in_rate, out_rate)
    L, M = out_rate // g, in_rate // g
    S = sinc_len
    K = S * L

    j = np.arange(K, dtype=np.float64)
    t = (j - K / 2) / L  # tap position in input-sample units
    c = cutoff * min(1.0, L / M)  # anti-alias cutoff rel. input Nyquist
    proto = c * np.sinc(c * t) * _blackman_harris2(j / K)

    taps_rev = np.zeros((L, S), dtype=np.float64)
    offsets = np.zeros(L, dtype=np.int64)
    for p in range(L):
        r = (p * M) % L
        offsets[p] = (p * M) // L
        # y[k] = sum_q proto[r + L*q] * x[i0 - q]  (see derivation in ops notes)
        phase = proto[r::L][:S]
        taps_rev[p] = phase[::-1]
        s = taps_rev[p].sum()
        if abs(s) > 1e-12:
            taps_rev[p] /= s  # exact unity DC gain per phase

    return taps_rev.astype(np.float32), offsets, L, M


def out_len(total_in: int, L: int, M: int) -> int:
    """ceil(total_in * L / M): outputs producible after total_in frames."""
    return (total_in * L + M - 1) // M


def resample_np(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """One-shot host resample. x: [channels, n] f32 -> [channels, n_out]."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    if in_rate == out_rate:
        return x.copy()
    taps_rev, offsets, L, M = design_polyphase(in_rate, out_rate)
    S = taps_rev.shape[1]
    n = x.shape[1]
    n_out = out_len(n, L, M)
    n_cycles = (n_out + L - 1) // L

    # left pad S-1 (history), right pad so every window is in bounds
    need = (n_cycles - 1) * M + int(offsets.max()) + S
    right = max(0, need - (n - 1) - (S - 1) - 1)
    xp = np.pad(x, ((0, 0), (S - 1, right)))

    wins = np.lib.stride_tricks.sliding_window_view(xp, S, axis=1)  # [C, P, S]
    out = np.empty((x.shape[0], n_cycles, L), dtype=np.float32)
    for p in range(L):
        sel = wins[:, int(offsets[p]) :: 1, :][:, : n_cycles * M : M, :]
        out[:, :, p] = np.einsum("cns,s->cn", sel[:, :n_cycles], taps_rev[p])
    return out.reshape(x.shape[0], n_cycles * L)[:, :n_out]


# ---------------------------------------------------------------------------
# device path: one strided conv with L output channels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _conv_kernel(in_rate: int, out_rate: int) -> Tuple[np.ndarray, int, int, int]:
    """Embed the polyphase bank into a [L, 1, S + M - 1] conv kernel."""
    taps_rev, offsets, L, M = design_polyphase(in_rate, out_rate)
    S = taps_rev.shape[1]
    Kc = S + M - 1
    kern = np.zeros((L, 1, Kc), dtype=np.float32)
    for p in range(L):
        o = int(offsets[p])
        kern[p, 0, o : o + S] = taps_rev[p]
    return kern, L, M, Kc


def resample(x, in_rate: int, out_rate: int):
    """Batched device resample. x: [streams, n] f32 -> [streams, n_out].

    Lowers to one ``conv_general_dilated`` (stride M, L output
    channels) — a matmul over im2col'd windows.  Jittable; shapes
    static.
    """
    import jax.numpy as jnp
    from jax import lax

    if in_rate == out_rate:
        return x
    kern, L, M, Kc = _conv_kernel(in_rate, out_rate)
    S = SINC_LEN
    n = x.shape[-1]
    n_out = out_len(n, L, M)
    n_cycles = (n_out + L - 1) // L

    need = (n_cycles - 1) * M + Kc
    right = max(0, need - (n + S - 1))
    xp = jnp.pad(x, ((0, 0), (S - 1, right)))[:, None, :]  # [B, 1, N']

    out = lax.conv_general_dilated(
        xp,
        jnp.asarray(kern),
        window_strides=(M,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,  # a TF32 conv would degrade SNR
    )  # [B, L, n_c]
    out = out[:, :, :n_cycles]
    out = jnp.transpose(out, (0, 2, 1)).reshape(x.shape[0], n_cycles * L)
    return out[:, :n_out]


def resample_stateful(x, hist, in_rate: int, out_rate: int):
    """Carried-state chunked resample: seam-free streaming on device.

    ``x``: [B, n] f32 chunk; ``hist``: [B, SINC_LEN-1] carried input
    history (zeros for the first chunk).  Requires ``n * L % M == 0``
    (choose the chunk so the polyphase phase realigns at the boundary;
    e.g. 44.1k->8k has L/M = 80/441, so n must be a multiple of 441)
    — then concatenating chunk outputs equals the one-shot
    :func:`resample` of the concatenated input exactly, because each
    window sees the true preceding samples instead of zeros.

    Returns (out [B, n*L//M], new_hist [B, SINC_LEN-1]).
    """
    import jax.numpy as jnp
    from jax import lax

    if in_rate == out_rate:
        return x, hist
    kern, L, M, Kc = _conv_kernel(in_rate, out_rate)
    S = SINC_LEN
    n = x.shape[-1]
    if (n * L) % M != 0:
        raise ValueError(f"chunk length {n} must satisfy n*{L} % {M} == 0")
    n_out = n * L // M
    n_cycles = (n_out + L - 1) // L

    xa = jnp.concatenate([hist, x], axis=1)  # [B, S-1+n]
    need = (n_cycles - 1) * M + Kc
    right = max(0, need - xa.shape[1])
    xp = jnp.pad(xa, ((0, 0), (0, right)))[:, None, :]

    out = lax.conv_general_dilated(
        xp, jnp.asarray(kern), window_strides=(M,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,  # a TF32 conv would degrade SNR
    )
    out = out[:, :, :n_cycles]
    out = jnp.transpose(out, (0, 2, 1)).reshape(x.shape[0], n_cycles * L)[:, :n_out]
    new_hist = xa[:, -(S - 1):]
    return out, new_hist


def resample_init_state(B: int) -> "np.ndarray":
    return np.zeros((B, SINC_LEN - 1), dtype=np.float32)
