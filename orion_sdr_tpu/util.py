"""Measurement toolkit — the spectral yardsticks every test asserts against.

Semantics mirror /root/reference/src/util.rs (Hann single-bin SNR, clamped
power spectrum, narrowband/wideband spectrum SNR, AM occupied bandwidth), so
this package's roundtrip tests gate on the same numbers the reference's do.
All functions accept numpy or JAX arrays and return Python floats / numpy —
they are measurement code, not hot-path kernels.
"""

from __future__ import annotations

import numpy as np

SIGNAL_THRESHOLD = 0.1  # RMS below which a block is treated as silence (util.rs:297)
PSK31_BW_HZ = 62.5      # raised-cosine pulse: 2× baud (util.rs:300)


def _np(x):
    return np.asarray(x)


def rms(x) -> float:
    x = _np(x)
    if x.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.abs(x).astype(np.float64) ** 2)))


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (util.rs:18-22)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def tone(fs: float, f_hz: float, n: int, amp: float = 1.0) -> np.ndarray:
    """Real sine tone (util.rs:25-29)."""
    k = np.arange(n, dtype=np.float64)
    return (amp * np.sin(2.0 * np.pi * f_hz * k / fs)).astype(np.float32)


def gen_complex_tone(fs: float, f_hz: float, n: int) -> np.ndarray:
    """Complex baseband tone e^{j2πft} (util.rs:32-39)."""
    k = np.arange(n, dtype=np.float64)
    ph = 2.0 * np.pi * f_hz * k / fs
    return (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)


def snr_db_at(fs: float, f_hz: float, x) -> float:
    """Single-bin Hann-windowed DFT SNR at f_hz (util.rs:42-61)."""
    x = _np(x).astype(np.float64)
    if len(x) == 0:
        return 0.0
    n = len(x)
    w = hann(n).astype(np.float64)
    ph = 2.0 * np.pi * f_hz * np.arange(n) / fs
    re = float(np.sum(w * x * np.cos(ph)))
    im = float(np.sum(w * x * np.sin(ph)))
    sig = np.hypot(re, im) / (w.sum() + 1e-12)
    p_total = float(np.mean(x * x))
    p_sig = sig * sig
    p_noise = max(p_total - p_sig, 1e-12)
    return float(10.0 * np.log10(p_sig / p_noise))


def power_spectrum(samples, fs: float):
    """Hann-windowed power spectrum in dB; FFT size = next pow2 clamped [64,4096].

    Returns (power_db[bins], bin_hz) with bins = n/2+1 (util.rs:96-133).

    Complex input policy: the reference API is real-only; complex samples
    are analyzed as-is (windowed complex FFT, positive-frequency bins
    reported) — an explicit extension, NOT a silent cast to the real part.
    """
    samples = _np(samples)
    cplx = np.iscomplexobj(samples)
    samples = samples.astype(np.complex128 if cplx else np.float64)
    n = 1 << max(int(np.ceil(np.log2(max(len(samples), 1)))), 0)
    n = int(np.clip(n, 64, 4096))
    buf = np.zeros(n, dtype=samples.dtype)
    m = min(len(samples), n)
    buf[:m] = samples[:m]
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    spec = np.fft.fft(buf * w)
    scale = 1.0 / n
    bins = n // 2 + 1
    mag_sq = (np.abs(spec[:bins]) * scale) ** 2
    return 10.0 * np.log10(mag_sq + 1e-12), fs / n


def nb_spectrum_snr_db(samples, fs: float, carrier_hz: float) -> float:
    """Peak bin (±3-bin AFC search) vs median of bins ≥10 away (util.rs:139-175)."""
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3:
        return 0.0
    peak_bin = min(int(round(carrier_hz / bin_hz)), n_bins - 1)
    lo, hi = max(peak_bin - 3, 0), min(peak_bin + 3, n_bins - 1)
    sig_bin = lo + int(np.argmax(power_db[lo:hi + 1]))
    idx = np.arange(n_bins)
    mask = (idx > 0) & (np.abs(idx - sig_bin) >= 10)
    noise = power_db[mask]
    if noise.size == 0:
        return 0.0
    return float(power_db[sig_bin] - np.median(noise))


def wb_spectrum_snr_db(samples, fs: float, carrier_hz: float, occupied_hz: float) -> float:
    """Mean in-band power vs median out-of-band (OFDM-style; util.rs:184-218)."""
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3 or bin_hz <= 0:
        return 0.0
    carrier_bin = int(round(carrier_hz / bin_hz))
    half = int(round((occupied_hz / 2.0) / bin_hz))
    lo = max(carrier_bin - half, 0)
    hi = min(carrier_bin + half, n_bins - 1)
    if lo > hi:
        return 0.0
    occ_mean = float(np.mean(power_db[lo:hi + 1]))
    idx = np.arange(n_bins)
    mask = (idx > 0) & ((idx < lo) | (idx > hi))
    outside = power_db[mask]
    if outside.size == 0:
        return 0.0
    return occ_mean - float(np.median(outside))


def spectrum_bw_hz(samples, fs: float, carrier_hz: float, threshold_db: float = 35.0) -> float:
    """AM occupied bandwidth: outermost bins within 35 dB of carrier (util.rs:228-296)."""
    search_hz, carrier_drop_db, guard = 4000.0, 35.0, 3
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3:
        return bin_hz
    nominal = min(int(round(carrier_hz / bin_hz)), n_bins - 1)
    lo, hi = max(nominal - 3, 0), min(nominal + 3, n_bins - 1)
    carrier_bin = lo + int(np.argmax(power_db[lo:hi + 1]))
    cutoff = power_db[carrier_bin] - carrier_drop_db
    search_bins = int(np.ceil(search_hz / bin_hz))

    lsb_lo = max(carrier_bin - search_bins, 0)
    lsb_hi = max(carrier_bin - guard, 0)
    left_edge = carrier_bin
    if lsb_lo < lsb_hi:
        above = np.nonzero(power_db[lsb_lo:lsb_hi + 1] >= cutoff)[0]
        if above.size:
            left_edge = lsb_lo + int(above[0])

    usb_lo = min(carrier_bin + guard, n_bins - 1)
    usb_hi = min(carrier_bin + search_bins, n_bins - 1)
    right_edge = carrier_bin
    if usb_lo < usb_hi:
        above = np.nonzero(power_db[usb_lo:usb_hi + 1] >= cutoff)[0]
        if above.size:
            right_edge = usb_lo + int(above[-1])

    return float((max(right_edge, left_edge) - left_edge + 1) * bin_hz)


def awgn(rng: np.random.Generator, shape, scale: float, complex_: bool = True):
    """Deterministic test AWGN (mirrors tests/common/mod.rs seeded xorshift role)."""
    if complex_:
        return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) /
                np.sqrt(2.0)).astype(np.complex64)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class trace:
    """Profiling context: ``with util.trace("/tmp/prof"): run()`` captures a
    ``jax.profiler`` trace (TensorBoard/Perfetto) of every device program in
    the block — the observability story the reference lacked (SURVEY §5:
    tracing absent; only util.rs:62's wall-clock measure). Falls back to a
    no-op if the profiler is unavailable on the current backend."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self._active = False

    def __enter__(self):
        try:
            import jax
            jax.profiler.start_trace(self.log_dir)
            self._active = True
        except Exception:
            self._active = False
        return self

    def __exit__(self, *exc):
        if self._active:
            import jax
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
        return False


def measure(fn, n_samples: int, repeats: int = 1):
    """Wall-clock throughput of ``fn`` processing ``n_samples`` per call:
    returns (Msps, seconds) — the reference's util::measure (util.rs:62-71),
    used by the tier-3 throughput tests."""
    import time
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    dt = time.perf_counter() - t0
    return (n_samples * repeats / dt / 1e6 if dt > 0 else float("inf")), dt


def atan2_approx(y, x):
    """Fast atan2: Rajan-family minimax polynomial, max err ≈ 0.0015 rad
    (ref: util.rs:302-322 claims 0.0005 for its variant, but its transcription
    drops the (1−r) factor — see the inline note). Vectorized; used by the
    FM/PM discriminators."""
    import jax.numpy as jnp
    y = jnp.asarray(y, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    ax, ay = jnp.abs(x), jnp.abs(y)
    mn = jnp.minimum(ax, ay)
    mx = jnp.maximum(ax, ay)
    r = mn / (mx + jnp.float32(1.1920929e-07))
    # Rajan et al. minimax: atan(r) ≈ (π/4)r + r(1−r)(0.2447 + 0.0663r);
    # the reference's comment cites this family (its transcription drops the
    # (1−r) factor, which would put a 0.18 rad step at r=1 — reproduced here
    # in corrected form; error ≲ 0.0015 rad, continuous at the octant seam).
    phi = r * jnp.float32(np.pi / 4) + r * (1.0 - r) * (
        jnp.float32(0.2447) + jnp.float32(0.0663) * r)
    phi = jnp.where(ax < ay, jnp.float32(np.pi / 2) - phi, phi)
    sign_y = jnp.where(y < 0.0, -1.0, 1.0)
    return jnp.where(x < 0.0, (jnp.float32(np.pi) - phi) * sign_y,
                     phi * sign_y).astype(jnp.float32)


# ── spectrum scanning (beyond the reference) ─────────────────────────────────

from dataclasses import dataclass as _dataclass


@_dataclass
class SpectrumSegment:
    """One occupied sub-band found by :func:`spectrum_scan`."""
    center_hz: float     # power-weighted centroid
    bw_hz: float         # occupied width at the detection threshold
    power_db: float      # mean in-segment PSD, dB re full-scale/bin
    snr_db: float        # mean in-segment PSD over the noise floor


def _welch_psd(iq, nfft: int):
    """Welch-averaged periodogram of a complex capture: Hann segments,
    50 % overlap, ONE batched device FFT over all segments."""
    import jax.numpy as jnp
    from .dsp.device import cjit as _cjit

    @_cjit
    def _psd(z, nfft: int):
        z = jnp.asarray(z)
        hop = nfft // 2
        n_seg = max((z.shape[-1] - nfft) // hop + 1, 1)
        idx = jnp.arange(n_seg)[:, None] * hop + jnp.arange(nfft)[None, :]
        segs = z[idx]
        w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(nfft) / nfft)
        spec = jnp.fft.fft(segs * w.astype(jnp.complex64), axis=-1)
        scale = jnp.float32(1.0 / (nfft * 0.5))   # Hann coherent gain = 0.5
        return jnp.mean(jnp.abs(spec * scale) ** 2, axis=0).astype(jnp.float32)

    return np.fft.fftshift(np.asarray(_psd(iq, nfft)))


def spectrum_scan(iq, fs: float, rbw_hz: float | None = None,
                  threshold_db: float = 10.0,
                  min_bw_hz: float | None = None,
                  gap_bins: int = 2):
    """Detect occupied sub-bands in a complex wideband capture.

    Beyond the reference (whose util.rs stops at single-capture spectra):
    the gateway front end of scan-then-receive — Welch-average the whole
    capture (one batched device FFT), estimate the noise floor as the
    median PSD bin, mark bins ``threshold_db`` above it, close gaps of up
    to ``gap_bins`` (pilot combs, mask ripple), and report each
    contiguous segment wider than ``min_bw_hz`` as a
    :class:`SpectrumSegment`, strongest first. Feed the centers to
    ``OfdmFrameBandStreamDemod``/``DvbTBandStreamDemod``.

    ``rbw_hz``: resolution bandwidth (default fs/4096, clamped so nfft
    lands in [256, 65536]). ``min_bw_hz`` defaults to 4·rbw.
    """
    iq = np.asarray(iq)
    if iq.ndim != 1:
        raise ValueError("spectrum_scan takes a 1-D capture")
    if len(iq) < 256:
        raise ValueError("capture too short to scan (need ≥256 samples)")
    if rbw_hz is None:
        rbw_hz = fs / 4096.0
    nfft = 1 << int(np.clip(np.round(np.log2(fs / max(rbw_hz, 1e-9))),
                            8, 16))
    nfft = min(nfft, 1 << int(np.floor(np.log2(len(iq)))))
    psd = _welch_psd(iq.astype(np.complex64), nfft)
    psd_db = 10.0 * np.log10(psd + 1e-20)
    freqs = (np.arange(nfft) - nfft // 2) * (fs / nfft)
    floor_db = float(np.median(psd_db))
    mask = psd_db > floor_db + threshold_db
    # close short gaps so pilot combs / mask ripple stay one segment
    if gap_bins > 0 and mask.any():
        occ = np.flatnonzero(mask)
        gaps = np.diff(occ)
        for i in np.flatnonzero((gaps > 1) & (gaps <= gap_bins + 1)):
            mask[occ[i]:occ[i + 1]] = True
    if min_bw_hz is None:
        min_bw_hz = 4.0 * fs / nfft
    min_bins = max(int(np.ceil(min_bw_hz / (fs / nfft))), 1)

    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], mask.astype(np.int8), [0]])))
    spans = list(zip(edges[::2], edges[1::2]))
    # merge segments separated by less than min_bw: a channel whose PSD
    # grazes the threshold (short burst diluted by Welch averaging, pilot
    # comb) must not split into fragments narrower than anything we report
    merged = []
    for a, b in spans:
        if merged and a - merged[-1][1] < min_bins:
            merged[-1][1] = b
        else:
            merged.append([a, b])
    out = []
    for a, b in merged:
        if b - a < min_bins:
            continue
        p = psd[a:b]
        center = float(np.sum(freqs[a:b] * p) / np.sum(p))
        mean_db = float(10.0 * np.log10(np.mean(p) + 1e-20))
        out.append(SpectrumSegment(
            center_hz=center,
            bw_hz=float((b - a) * fs / nfft),
            power_db=mean_db,
            snr_db=mean_db - floor_db))
    out.sort(key=lambda s: -s.power_db)
    return out
