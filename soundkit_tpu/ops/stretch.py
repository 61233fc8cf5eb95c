"""Phase-vocoder time stretch / pitch shift kernel.

Device-batched replacement for the reference's Rubber Band C++ dependency
(soundkit-rubberband{,-sys}; SURVEY.md §2.3 rebuild plan: phase
vocoder + windowed-sinc polyphase as owned kernels).  The algorithm is
fully vectorized (no per-frame Python loop): STFT -> per-bin true
frequency estimation -> cumulative synthesis phase -> ISTFT with
window-squared normalization; pitch shift = stretch by ratio*pitch
then polyphase resample by 1/pitch (ops.resample).

Runs in numpy on the host path; the identical math runs under jnp for
batched device use (rfft/irfft are XLA-supported).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

FRAME = 2048
HOP_A = 512


def _princarg(x: np.ndarray) -> np.ndarray:
    return (x + np.pi) % (2 * np.pi) - np.pi


ENVELOPE_ORDER = FRAME // 32  # cepstral lifter cutoff (64 @ FRAME=2048)


def _spectral_envelope(mag: np.ndarray, order: int = ENVELOPE_ORDER) -> np.ndarray:
    """Cepstrally smoothed spectral envelope of ``mag`` [..., K].

    Real cepstrum of log|X|, low-quefrency lifter (factor-2 fold for the
    symmetric negative quefrencies), back to log-spectral domain.
    """
    logm = np.log(np.maximum(mag, 1e-9))
    ceps = np.fft.irfft(logm, n=FRAME, axis=-1)
    lift = np.zeros(FRAME)
    lift[0] = 1.0
    lift[1:order] = 2.0
    env_log = np.fft.rfft(ceps * lift, n=FRAME, axis=-1).real
    return np.exp(env_log[..., : mag.shape[-1]])


def _warp_envelope(env: np.ndarray, warp: float) -> np.ndarray:
    """Evaluate ``env`` at bin positions ``k * warp`` (linear interp,
    right-clamped) — shifts the envelope down in frequency by ``warp``."""
    K = env.shape[-1]
    pos = np.arange(K) * warp
    i0 = np.clip(pos.astype(np.int64), 0, K - 1)
    i1 = np.clip(i0 + 1, 0, K - 1)
    fr = np.clip(pos - i0, 0.0, 1.0)
    return env[..., i0] * (1.0 - fr) + env[..., i1] * fr


def _nearest_peak_np(mag: np.ndarray) -> np.ndarray:
    """Index of the nearest local spectral maximum per bin [..., K]."""
    K = mag.shape[-1]
    lo = np.concatenate([np.full_like(mag[..., :1], -np.inf), mag[..., :-1]], -1)
    hi = np.concatenate([mag[..., 1:], np.full_like(mag[..., :1], -np.inf)], -1)
    is_peak = (mag >= lo) & (mag > hi)
    k = np.arange(K)
    big = 2 * K
    ffill = np.maximum.accumulate(np.where(is_peak, k, -1), axis=-1)
    bfill = np.flip(
        np.minimum.accumulate(np.flip(np.where(is_peak, k, big), -1), axis=-1), -1
    )
    dist_f = np.where(ffill >= 0, k - ffill, big)
    dist_b = np.where(bfill < big, bfill - k, big)
    return np.clip(np.where(dist_f <= dist_b, ffill, bfill), 0, K - 1)


def stretch_channels(
    channels: np.ndarray, time_ratio: float, envelope_warp: float = 1.0
) -> np.ndarray:
    """Time-stretch planar f32 [C, n] by ``time_ratio`` (>1 = longer).

    Pure phase vocoder; length out ~= n * time_ratio.  When
    ``envelope_warp`` != 1, each frame's magnitude is flattened by its
    cepstral envelope and re-shaped with the envelope evaluated at
    ``k * envelope_warp`` — the formant-preservation primitive
    (reference: rubberband_set_formant_scale, soundkit-rubberband
    lib.rs:628-630; here an owned kernel, not a library call).
    """
    x = np.atleast_2d(np.asarray(channels, dtype=np.float64))
    C, n = x.shape
    if n == 0 or (abs(time_ratio - 1.0) < 1e-9 and abs(envelope_warp - 1.0) < 1e-9):
        return x.astype(np.float32).copy()

    hop_s = max(1, int(round(HOP_A * time_ratio)))
    win = np.hanning(FRAME)

    # analysis frames [C, T, FRAME]
    pad = FRAME + HOP_A * int(np.ceil(n / HOP_A))
    xp = np.pad(x, ((0, 0), (FRAME // 2, pad)))
    T = (xp.shape[1] - FRAME) // HOP_A + 1
    idx = np.arange(FRAME)[None, :] + HOP_A * np.arange(T)[:, None]
    frames = xp[:, idx] * win  # [C, T, FRAME]
    spec = np.fft.rfft(frames, axis=-1)  # [C, T, K]
    K = spec.shape[-1]

    mag = np.abs(spec)
    phase = np.angle(spec)

    if abs(envelope_warp - 1.0) > 1e-9:
        env = _spectral_envelope(mag)
        mag = mag / np.maximum(env, 1e-9) * _warp_envelope(env, envelope_warp)

    # per-bin instantaneous frequency (vectorized over frames)
    omega = 2 * np.pi * np.arange(K) / FRAME  # rad/sample
    dphi = np.diff(phase, axis=1, prepend=phase[:, :1])
    dev = _princarg(dphi - omega[None, None, :] * HOP_A)
    true_freq = omega[None, None, :] + dev / HOP_A  # [C, T, K]

    # synthesis phases: cumulative sum of true_freq * hop_s
    syn_phase = np.cumsum(true_freq * hop_s, axis=1)
    syn_phase += phase[:, :1, :] - syn_phase[:, :1, :]  # anchor first frame

    # identity phase locking (Laroche & Dolson 1999): every bin inherits
    # its nearest spectral peak's synthesis rotation, keeping the
    # analysis phase RELATIONSHIPS within each peak region.  Without it
    # the per-bin phases decorrelate on broadband/transient content and
    # the overlap-add partially cancels (measured -3.7 dB on the music
    # fixture; locked: level preserved).
    nearest = _nearest_peak_np(mag)
    rot = np.take_along_axis(syn_phase, nearest, -1) - np.take_along_axis(
        phase, nearest, -1
    )
    syn_phase = phase + rot

    out_spec = mag * np.exp(1j * syn_phase)
    out_frames = np.fft.irfft(out_spec, n=FRAME, axis=-1) * win

    # overlap-add with window^2 normalization
    out_len = hop_s * (T - 1) + FRAME
    out = np.zeros((C, out_len))
    norm = np.zeros(out_len)
    win2 = win * win
    for t in range(T):  # scatter-add; T is small (n/512)
        out[:, t * hop_s : t * hop_s + FRAME] += out_frames[:, t]
        norm[t * hop_s : t * hop_s + FRAME] += win2
    out /= np.maximum(norm, 1e-8)[None, :]

    target = int(round(n * time_ratio))
    start = FRAME // 2
    out = out[:, start : start + target]
    if out.shape[1] < target:
        out = np.pad(out, ((0, 0), (0, target - out.shape[1])))
    return out.astype(np.float32)


def pitch_ratio_fraction(pitch_scale: float, max_den: int = 64) -> Tuple[int, int]:
    frac = Fraction(pitch_scale).limit_denominator(max_den)
    return frac.numerator, frac.denominator


def stretch_pitch(
    channels: np.ndarray,
    time_ratio: float,
    pitch_scale: float,
    formant_scale: Optional[float] = None,
) -> np.ndarray:
    """Combined time stretch + pitch shift.

    Stretch by time_ratio * pitch_scale, then resample by 1/pitch_scale
    so duration = n * time_ratio and pitch moves by pitch_scale.

    ``formant_scale=None`` (default): the spectral envelope follows the
    pitch shift.  ``formant_scale=F``: the envelope lands at F x the
    original formant frequencies regardless of pitch (F=1 = preserved).
    The resample step scales the stretched-domain spectrum by
    ``pitch_scale``, so the vocoder warps the envelope by
    ``pitch_scale / F`` to compensate.
    """
    from soundkit_tpu.ops import resample as rs

    x = np.atleast_2d(np.asarray(channels, dtype=np.float32))
    if abs(pitch_scale - 1.0) < 1e-9:
        warp = 1.0 if formant_scale is None else 1.0 / formant_scale
        return stretch_channels(x, time_ratio, envelope_warp=warp)
    warp = 1.0 if formant_scale is None else pitch_scale / formant_scale
    stretched = stretch_channels(x, time_ratio * pitch_scale, envelope_warp=warp)
    num, den = pitch_ratio_fraction(pitch_scale)
    # resample rate ratio 1/pitch: in_rate=num, out_rate=den
    out = rs.resample_np(stretched, num * 1000, den * 1000)
    target = int(round(x.shape[1] * time_ratio))
    if out.shape[1] >= target:
        return out[:, :target].astype(np.float32)
    return np.pad(out, ((0, 0), (0, target - out.shape[1]))).astype(np.float32)


def stretch_batch_device(x, time_ratio: float, envelope_warp: float = 1.0):
    """Batched device phase vocoder: [B, n] f32 -> [B, out] f32.

    ``envelope_warp`` != 1 applies the formant-preservation primitive
    on device: cepstral envelope (rfft/irfft lifter, same order as the
    host path) flattening + re-application at warped bin positions.

    The same math as :func:`stretch_channels` expressed in jnp for a
    jitted batched serving path (BASELINE "Rubber Band phase-vocoder
    kernels" as owned device work): framing is a gather, rfft/irfft run
    on device, the instantaneous-frequency estimate and synthesis-phase
    accumulation are a cumsum over frames, and overlap-add is a
    ``lax.scan`` of dynamic_update_slice adds over a carried output
    buffer.  ``time_ratio`` and the input length are static (one
    compiled program per (n, ratio) pair — serving uses fixed chunks).

    jit me with static_argnums=(1, 2).
    """
    import jax
    import jax.numpy as jnp

    B, n = x.shape
    hop_s = max(1, int(round(HOP_A * time_ratio)))
    win = jnp.asarray(np.hanning(FRAME).astype(np.float32))

    pad = FRAME + HOP_A * int(np.ceil(n / HOP_A))
    xp = jnp.pad(x, ((0, 0), (FRAME // 2, pad)))
    T = (xp.shape[1] - FRAME) // HOP_A + 1
    idx = np.arange(FRAME)[None, :] + HOP_A * np.arange(T)[:, None]
    frames = xp[:, jnp.asarray(idx)] * win  # [B, T, FRAME]
    spec = jnp.fft.rfft(frames, axis=-1)
    K = spec.shape[-1]

    mag = jnp.abs(spec)
    phase = jnp.angle(spec)

    if abs(envelope_warp - 1.0) > 1e-9:
        logm = jnp.log(jnp.maximum(mag, 1e-9))
        ceps = jnp.fft.irfft(logm, n=FRAME, axis=-1)
        lift = np.zeros(FRAME, np.float32)
        lift[0] = 1.0
        lift[1:ENVELOPE_ORDER] = 2.0
        env_log = jnp.fft.rfft(ceps * jnp.asarray(lift), n=FRAME, axis=-1).real
        env = jnp.exp(env_log[..., :K])
        pos = np.arange(K) * envelope_warp
        i0 = np.clip(pos.astype(np.int64), 0, K - 1)
        i1 = np.clip(i0 + 1, 0, K - 1)
        fr = np.clip(pos - i0, 0.0, 1.0).astype(np.float32)
        env_w = env[..., i0] * (1.0 - fr) + env[..., i1] * fr
        mag = mag / jnp.maximum(env, 1e-9) * env_w

    omega = 2 * jnp.pi * jnp.arange(K) / FRAME
    dphi = jnp.diff(phase, axis=1, prepend=phase[:, :1])
    dev = dphi - omega[None, None, :] * HOP_A
    dev = (dev + jnp.pi) % (2 * jnp.pi) - jnp.pi
    true_freq = omega[None, None, :] + dev / HOP_A

    syn_phase = jnp.cumsum(true_freq * hop_s, axis=1)
    syn_phase = syn_phase + (phase[:, :1, :] - syn_phase[:, :1, :])

    # identity phase locking (same as the host path): bins inherit the
    # nearest spectral peak's synthesis rotation
    neg = jnp.full_like(mag[..., :1], -jnp.inf)
    lo = jnp.concatenate([neg, mag[..., :-1]], -1)
    hi = jnp.concatenate([mag[..., 1:], neg], -1)
    is_peak = (mag >= lo) & (mag > hi)
    kk = jnp.arange(K, dtype=jnp.int32)
    big = 2 * K
    ffill = jax.lax.cummax(jnp.where(is_peak, kk, -1), axis=2)
    bfill = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(is_peak, kk, big), -1), axis=2), -1
    )
    dist_f = jnp.where(ffill >= 0, kk - ffill, big)
    dist_b = jnp.where(bfill < big, bfill - kk, big)
    nearest = jnp.clip(jnp.where(dist_f <= dist_b, ffill, bfill), 0, K - 1)
    rot = jnp.take_along_axis(syn_phase, nearest, -1) - jnp.take_along_axis(
        phase, nearest, -1
    )
    syn_phase = phase + rot

    out_spec = mag * jnp.exp(1j * syn_phase)
    out_frames = jnp.fft.irfft(out_spec, n=FRAME, axis=-1) * win  # [B, T, FRAME]

    out_len = hop_s * (T - 1) + FRAME
    win2 = (win * win)[None, :]

    def ola(carry, xs):
        out, norm, t = carry
        frame = xs  # [B, FRAME]
        pos = t * hop_s
        out = jax.lax.dynamic_update_slice(
            out, jax.lax.dynamic_slice(out, (0, pos), (B, FRAME)) + frame, (0, pos)
        )
        norm = jax.lax.dynamic_update_slice(
            norm, jax.lax.dynamic_slice(norm, (0, pos), (1, FRAME)) + win2, (0, pos)
        )
        return (out, norm, t + 1), None

    out0 = jnp.zeros((B, out_len), jnp.float32)
    norm0 = jnp.zeros((1, out_len), jnp.float32)
    (out, norm, _), _ = jax.lax.scan(
        ola, (out0, norm0, jnp.int32(0)), jnp.swapaxes(out_frames, 0, 1)
    )
    out = out / jnp.maximum(norm, 1e-8)

    target = int(round(n * time_ratio))
    start = FRAME // 2
    res = out[:, start : start + target]
    if res.shape[1] < target:
        res = jnp.pad(res, ((0, 0), (0, target - res.shape[1])))
    return res


def pitch_shift_batch_device(x, time_ratio: float, pitch_scale: float,
                             formant_scale: Optional[float] = None):
    """Fully on-device batched pitch shift: [B, n] f32 -> [B, out].

    Composes the device vocoder with the device polyphase resampler
    (ops.resample.resample — one conv_general_dilated) inside one
    jittable program: stretch by ``time_ratio * pitch_scale`` (with the
    envelope warp compensating the resample's spectral scaling when
    ``formant_scale`` is set, same algebra as :func:`stretch_pitch`),
    then resample by ``1/pitch_scale``.

    jit me with static_argnums=(1, 2, 3).
    """
    from soundkit_tpu.ops import resample as rs

    if abs(pitch_scale - 1.0) < 1e-9:
        warp = 1.0 if formant_scale is None else 1.0 / formant_scale
        return stretch_batch_device(x, time_ratio, warp)
    warp = 1.0 if formant_scale is None else pitch_scale / formant_scale
    stretched = stretch_batch_device(x, time_ratio * pitch_scale, warp)
    num, den = pitch_ratio_fraction(pitch_scale)
    out = rs.resample(stretched, num * 1000, den * 1000)
    target = int(round(x.shape[1] * time_ratio))
    if out.shape[1] >= target:
        return out[:, :target]
    import jax.numpy as jnp

    return jnp.pad(out, ((0, 0), (0, target - out.shape[1])))
