"""Channel impairment simulator — batched propagation models.

Beyond-parity subsystem: the reference qualifies its receivers only under
seeded AWGN and static sample/frequency offsets (tests/common/mod.rs:5-48;
no fading, multipath, or phase-noise model exists anywhere in
/root/reference/src).  Production SDR stacks are qualified against channel
models, so this module provides deterministic, batched impairments that
compose with every mod/demod pair in the package:

- ``cfo_apply`` / ``phase_noise_apply`` / ``iq_imbalance_apply`` —
  oscillator and front-end imperfections.
- ``multipath_apply`` — static echoes (DVB-T guard-interval margin).
- ``fading_taps`` + ``fading_apply`` — time-varying Rayleigh/Rician taps
  with a Jakes or Gaussian Doppler spectrum, generated at a low tap rate
  on the host (seeded ``np.random.Generator`` → reproducible) and
  linearly interpolated to the sample rate on device.
- ``watterson_apply`` — the CCIR 520 / ITU-R F.1487 two-path HF
  ionospheric model (independent Gaussian-spread taps), the standard
  qualification channel for the FT8/FT4/PSK31 modes this package ships.

Conventions: host randomness comes in as a ``np.random.Generator`` (same
role as ``util.awgn``); the per-sample application runs inside one device
program via ``cjit``.  All impairments accept ``(..., n)`` batches and
apply the SAME channel realization to every leading row — independent
realizations are a leading axis on the tap process itself.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .dsp.device import cjit as _cjit
from .dsp.osc import rotate_host

__all__ = [
    "cfo_apply", "phase_noise_apply", "iq_imbalance_apply",
    "multipath_apply", "fading_taps", "fading_apply", "watterson_apply",
]


def cfo_apply(x, cfo_hz: float, fs: float, phase0: float = 0.0):
    """Carrier frequency offset: y = x · e^{j2π·cfo·t + jφ₀}.

    Thin channel-facing alias of ``dsp.osc.rotate`` (returns just the
    impaired signal, not the phase tail).
    """
    y, _ = rotate_host(np.asarray(x), float(cfo_hz), float(fs),
                       float(phase0))
    return np.asarray(y).astype(np.complex64)


@_cjit
def _mul_cexp(x, phi):
    return (jnp.asarray(x) * jnp.exp(1j * jnp.asarray(phi, jnp.float32))
            ).astype(jnp.complex64)


def phase_noise_apply(rng: np.random.Generator, x, linewidth_hz: float,
                      fs: float):
    """Wiener (random-walk) oscillator phase noise.

    A free-running oscillator with Lorentzian linewidth ``Δν`` accumulates
    phase increments N(0, 2πΔν/fs) per sample; the integrated walk is
    computed on host in float64 (1 M samples of f64 is nothing, and cumsum
    precision matters more than device time here), the rotation on device.
    Same realization across leading batch dims.
    """
    x = np.asarray(x)
    n = x.shape[-1]
    if n == 0 or linewidth_hz <= 0.0:
        return x.astype(np.complex64)
    step = np.sqrt(2.0 * np.pi * float(linewidth_hz) / float(fs))
    phi = np.cumsum(step * rng.standard_normal(n)).astype(np.float32)
    return np.asarray(_mul_cexp(x, phi)).astype(np.complex64)


@_cjit
def _iq_imb(x, mu_re, mu_im, nu_re, nu_im):
    z = jnp.asarray(x)
    mu = mu_re + 1j * mu_im
    nu = nu_re + 1j * nu_im
    return (mu * z + nu * jnp.conj(z)).astype(jnp.complex64)


def iq_imbalance_apply(x, amp_db: float = 0.0, phase_deg: float = 0.0):
    """Receiver I/Q gain+phase imbalance: y = μ·x + ν·conj(x).

    ``amp_db``/``phase_deg`` are the I-vs-Q gain and quadrature errors;
    μ = (1 + g·e^{-jφ})/2, ν = (1 − g·e^{jφ})/2 with g = 10^{amp/20}, so
    (0 dB, 0°) is exactly the identity and the image-rejection ratio is
    |μ/ν|².
    """
    g = 10.0 ** (float(amp_db) / 20.0)
    ph = np.deg2rad(float(phase_deg))
    mu = 0.5 * (1.0 + g * np.exp(-1j * ph))
    nu = 0.5 * (1.0 - g * np.exp(1j * ph))
    if nu == 0.0:
        return np.asarray(x).astype(np.complex64)
    y = _iq_imb(np.asarray(x), np.float32(mu.real), np.float32(mu.imag),
                np.float32(nu.real), np.float32(nu.imag))
    return np.asarray(y).astype(np.complex64)


@_cjit(static_argnames=("delays",))
def _multipath(x, g_re, g_im, delays):
    z = jnp.asarray(x)
    g = (jnp.asarray(g_re, jnp.float32) + 1j * jnp.asarray(g_im, jnp.float32))
    y = jnp.zeros_like(z)
    for k, d in enumerate(delays):
        if d == 0:
            y = y + g[k] * z
        else:
            pad = jnp.zeros(z.shape[:-1] + (d,), z.dtype)
            y = y + g[k] * jnp.concatenate([pad, z[..., :-d]], axis=-1)
    return y.astype(jnp.complex64)


def multipath_apply(x, delays_samp, gains, normalize: bool = True):
    """Static multipath: y[n] = Σ_k g_k · x[n − d_k] (causal, same length).

    ``delays_samp`` are non-negative integer sample delays, ``gains``
    complex path gains.  ``normalize`` scales so Σ|g|² = 1 (unit average
    power through the channel).  Equivalent to an explicit sparse-FIR
    convolution truncated to the input length — the deterministic echo
    model for DVB-T guard-interval margin tests.
    """
    d = tuple(int(v) for v in np.asarray(delays_samp).reshape(-1))
    g = np.asarray(gains, np.complex128).reshape(-1)
    if len(d) != g.size:
        raise ValueError(f"delays ({len(d)}) and gains ({g.size}) disagree")
    if any(v < 0 for v in d):
        raise ValueError("delays_samp must be non-negative")
    if normalize:
        p = np.sqrt(np.sum(np.abs(g) ** 2))
        if p > 0:
            g = g / p
    y = _multipath(np.asarray(x), g.real.astype(np.float32),
                   g.imag.astype(np.float32), d)
    return np.asarray(y).astype(np.complex64)


def fading_taps(rng: np.random.Generator, n_out: int, rate_hz: float,
                doppler_hz: float, spectrum: str = "jakes",
                n_paths: int = 1, rice_k_db: float | None = None):
    """(n_paths, n_out) unit-power complex tap processes at ``rate_hz``.

    Frequency-domain synthesis (Smith's method): shape white complex
    Gaussian spectra by √PSD and inverse-FFT.  ``spectrum``:

    - ``"jakes"`` — classic land-mobile S(f) ∝ 1/√(1−(f/f_d)²), |f|<f_d
      (``doppler_hz`` = maximum Doppler f_d).
    - ``"gaussian"`` — S(f) ∝ exp(−f²/2σ²) with σ = ``doppler_hz``
      (the Watterson per-path spectrum; σ = spread/2).

    ``rice_k_db`` adds a direct (LOS) component with Rice factor K,
    keeping total power 1.  Host-side by design: the process is
    bandlimited to a few Hz, so n_out stays tiny (generate at a low tap
    rate and let ``fading_apply`` interpolate to fs on device).
    """
    if n_out <= 0 or n_paths <= 0:
        return np.zeros((max(n_paths, 0), max(n_out, 0)), np.complex64)
    if doppler_hz <= 0.0:
        raise ValueError("doppler_hz must be > 0 (use multipath_apply for "
                         "a static channel)")
    m = 1 << max(int(np.ceil(np.log2(max(n_out, 8)))) + 1, 4)
    f = np.fft.fftfreq(m, d=1.0 / float(rate_hz))
    if spectrum == "jakes":
        fd = float(doppler_hz)
        r = np.clip(np.abs(f) / fd, 0.0, 0.999)
        psd = np.where(np.abs(f) < fd, 1.0 / np.sqrt(1.0 - r * r), 0.0)
    elif spectrum == "gaussian":
        sigma = float(doppler_hz)
        psd = np.exp(-0.5 * (f / sigma) ** 2)
    else:
        raise ValueError(f"unknown spectrum {spectrum!r}")
    shape = np.sqrt(psd)
    out = np.empty((n_paths, n_out), np.complex64)
    for p in range(n_paths):
        w = (rng.standard_normal(m) + 1j * rng.standard_normal(m))
        h = np.fft.ifft(w * shape)[:n_out]
        h = h / np.sqrt(np.mean(np.abs(h) ** 2))
        if rice_k_db is not None:
            k_lin = 10.0 ** (float(rice_k_db) / 10.0)
            h = (np.sqrt(k_lin / (k_lin + 1.0)) +
                 np.sqrt(1.0 / (k_lin + 1.0)) * h)
            h = h / np.sqrt(np.mean(np.abs(h) ** 2))
        out[p] = h.astype(np.complex64)
    return out


@_cjit(static_argnames=("delays", "n"))
def _fading(x, h_re, h_im, pos, delays, n):
    z = jnp.asarray(x)
    hr = jnp.asarray(h_re, jnp.float32)          # (P, n_taps)
    hi = jnp.asarray(h_im, jnp.float32)
    t = jnp.asarray(pos, jnp.float32)            # (n,) fractional tap index
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, hr.shape[-1] - 2)
    frac = t - i0.astype(jnp.float32)
    y = jnp.zeros(z.shape[:-1] + (n,), jnp.complex64)
    for k, d in enumerate(delays):
        a = hr[k, i0] * (1 - frac) + hr[k, i0 + 1] * frac
        b = hi[k, i0] * (1 - frac) + hi[k, i0 + 1] * frac
        hk = (a + 1j * b).astype(jnp.complex64)
        if d == 0:
            y = y + hk * z
        else:
            pad = jnp.zeros(z.shape[:-1] + (d,), z.dtype)
            y = y + hk * jnp.concatenate([pad, z[..., :-d]], axis=-1)
    return y.astype(jnp.complex64)


def fading_apply(x, fs: float, taps, tap_rate_hz: float, delays_samp,
                 path_gains_db=None, normalize: bool = True):
    """Time-varying multipath: y[n] = Σ_k g_k·h_k(n/fs)·x[n − d_k].

    ``taps`` is (n_paths, n_taps) from ``fading_taps`` at ``tap_rate_hz``;
    each path's process is linearly interpolated to the sample rate inside
    one device program (a process bandlimited to f_d sampled ≥32× over is
    sub-0.1 % interpolation error), multiplied in, and summed across the
    delay lines.  ``normalize`` scales path gains so Σ g² = 1.
    """
    x = np.asarray(x)
    h = np.asarray(taps, np.complex64)
    if h.ndim == 1:
        h = h[None, :]
    d = tuple(int(v) for v in np.asarray(delays_samp).reshape(-1))
    if h.shape[0] != len(d):
        raise ValueError(f"taps paths ({h.shape[0]}) and delays ({len(d)}) "
                         "disagree")
    if any(v < 0 for v in d):
        raise ValueError("delays_samp must be non-negative")
    g = (np.ones(len(d)) if path_gains_db is None else
         10.0 ** (np.asarray(path_gains_db, np.float64).reshape(-1) / 20.0))
    if g.size != len(d):
        raise ValueError("path_gains_db length mismatch")
    if normalize and g.size:
        g = g / np.sqrt(np.sum(g ** 2))
    h = h * g[:, None].astype(np.complex64)
    n = x.shape[-1]
    if n == 0:
        return x.astype(np.complex64)
    if h.shape[-1] < 2:
        h = np.concatenate([h, h], axis=-1)
    need = (n - 1) * float(tap_rate_hz) / float(fs)
    if h.shape[-1] - 1 < need:
        raise ValueError(
            f"taps too short: {h.shape[-1]} samples at {tap_rate_hz} Hz "
            f"covers {(h.shape[-1] - 1) / tap_rate_hz:.3f} s < "
            f"{(n - 1) / fs:.3f} s of signal")
    pos = (np.arange(n, dtype=np.float64) * float(tap_rate_hz) / float(fs)
           ).astype(np.float32)
    y = _fading(x, np.ascontiguousarray(h.real), np.ascontiguousarray(h.imag),
                pos, d, n)
    return np.asarray(y).astype(np.complex64)


def watterson_apply(rng: np.random.Generator, x, fs: float,
                    delay_s: float = 1e-3, spread_hz: float = 0.5,
                    path_gains_db=(0.0, 0.0)):
    """CCIR 520 / ITU-R F.1487 Watterson HF ionospheric channel.

    Two independent Rayleigh paths, each with a Gaussian Doppler spectrum
    of RMS width ``spread_hz``/2, separated by ``delay_s``.  The standard
    qualification points: "moderate" = (1 ms, 0.5 Hz), "disturbed" =
    (2 ms, 1 Hz).  Unit average output power.
    """
    x = np.asarray(x)
    n = x.shape[-1]
    if n == 0:
        return x.astype(np.complex64)
    sigma = max(float(spread_hz) / 2.0, 1e-3)
    tap_rate = max(64.0 * sigma, 16.0)
    n_taps = int(np.ceil((n - 1) / float(fs) * tap_rate)) + 2
    taps = fading_taps(rng, n_taps, tap_rate, sigma, spectrum="gaussian",
                       n_paths=2)
    delays = (0, max(int(round(float(delay_s) * float(fs))), 1))
    return fading_apply(x, fs, taps, tap_rate, delays,
                        path_gains_db=path_gains_db, normalize=True)
