"""FIR design + application.

Design functions run at trace time in numpy and produce constant tap arrays
(the equivalent of the reference's FirLowpass::design / Kaiser helpers,
/root/reference/src/dsp/fir.rs:8-157). Application is a batched convolution
that XLA lowers to a conv or an FFT overlap-save — one fused program over
the whole capture instead of a per-sample circular-buffer walk.

Streaming: every apply function accepts/returns an explicit tail ``state``
(the last ``ntaps-1`` inputs), which is exactly the halo exchanged between
devices when a long capture is time-sharded (overlap-save).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

# ── Design (trace-time, numpy) ───────────────────────────────────────────────


def fir_lowpass_design(fs: float, pass_hz: float, trans_hz: float) -> np.ndarray:
    """Sinc + Hann lowpass, unit DC gain (ref: dsp/fir.rs:14-45)."""
    pass_hz = max(pass_hz, 10.0)
    trans_hz = max(trans_hz, pass_hz * 0.2)
    ntaps = max(int(np.ceil(fs / trans_hz)), 31) | 1
    fc = pass_hz / fs
    m = np.arange(ntaps) - ntaps // 2
    sinc = np.where(
        m == 0,
        2.0 * fc,
        (2.0 * fc) * np.sin(2.0 * np.pi * fc * m) / np.where(m == 0, 1.0, np.pi * m),
    )
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(ntaps) / (ntaps - 1.0))
    taps = sinc * w
    return (taps / taps.sum()).astype(np.float32)


def kaiser_beta(a_db: float) -> float:
    """Kaiser window β for stopband attenuation (ref: dsp/fir.rs:74-82)."""
    if a_db > 50.0:
        return 0.1102 * (a_db - 8.7)
    if a_db >= 21.0:
        return 0.5842 * (a_db - 21.0) ** 0.4 + 0.07886 * (a_db - 21.0)
    return 0.0


def bessel_i0(x):
    """Modified Bessel I0 via power series (ref: dsp/fir.rs:86-103)."""
    x = np.asarray(x, dtype=np.float64)
    half = 0.5 * x
    term = np.ones_like(x)
    acc = np.ones_like(x)
    for k in range(1, 41):
        term = term * half / k
        acc = acc + term * term
    return acc


def kaiser_lowpass_taps(num_taps: int, cutoff_norm: float, stopband_db: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, odd length, unit DC gain.

    Ref: dsp/fir.rs:113-145. ``cutoff_norm`` is the −6 dB cutoff as a
    fraction of fs.
    """
    m = max(num_taps, 3) | 1
    mid = m // 2
    fc = min(max(cutoff_norm, 1e-4), 0.4999)
    beta = kaiser_beta(stopband_db)
    i0b = bessel_i0(np.float64(beta))
    d = np.arange(m, dtype=np.float64) - mid
    ideal = np.where(d == 0, 2.0 * fc, np.sin(2.0 * np.pi * fc * d) / np.where(d == 0, 1.0, np.pi * d))
    r = d / mid
    w = bessel_i0(beta * np.sqrt(np.maximum(1.0 - r * r, 0.0))) / i0b
    taps = ideal * w
    return (taps / taps.sum()).astype(np.float32)


def kaiser_transition_norm(num_taps: int, stopband_db: float) -> float:
    """Δf/fs ≈ (A−8)/(14.36·M) (ref: dsp/fir.rs:147-152)."""
    m = float(max(num_taps, 3) | 1)
    return (max(stopband_db, 21.0) - 8.0) / (14.36 * m)


def kaiser_num_taps(transition_norm: float, stopband_db: float) -> int:
    """Odd tap count to hit a transition width (ref: dsp/fir.rs:154-157)."""
    m = int(np.ceil((max(stopband_db, 21.0) - 8.0) / (14.36 * max(transition_norm, 1e-4))))
    return max(m, 3) | 1


def half_cosine_taps(sps: int) -> np.ndarray:
    """Unit-energy Hann matched-filter taps for PSK31 (ref: dsp/fir.rs:317-340)."""
    if sps <= 1:
        return np.ones(max(sps, 1), dtype=np.float32)
    h = 0.5 - 0.5 * np.cos(np.pi * np.arange(sps) / (sps - 1.0))
    return (h / np.sqrt((h * h).sum())).astype(np.float32)


def group_delay(taps) -> int:
    return (len(taps) - 1) // 2


# ── Application (JAX) ────────────────────────────────────────────────────────


# Taps from which the FFT overlap-save path replaces the XLA conv. The
# crossover was chosen on earlier hardware and is not measured on the H100
# yet (ROADMAP Q1 item 9).
_FFT_MIN_TAPS = 160
_FFT_BLOCK = 65536


def _fft_overlap_save(x, taps):
    """VALID correlation via FFT overlap-save (long-tap path).

    Block size adapts down for short inputs (power of two ≥ 4·T) so the
    padding waste stays bounded; for long inputs it is ``_FFT_BLOCK``."""
    t = jnp.asarray(np.asarray(taps, np.float32))
    T = t.shape[-1]
    n_out = x.shape[-1] - (T - 1)
    block = min(_FFT_BLOCK,
                max(2048, 1 << int(np.ceil(np.log2(4 * T))),
                    1 << int(np.ceil(np.log2(max(x.shape[-1], 2))))))
    if block <= T:                               # taps longer than _FFT_BLOCK/4
        block = 1 << int(np.ceil(np.log2(2 * T)))
    hop = block - T + 1
    nblk = -(-n_out // hop)
    total = nblk * hop + T - 1
    pad = total - x.shape[-1]
    xb = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, max(pad, 0))])
    idx = np.arange(nblk)[:, None] * hop + np.arange(block)[None, :]
    blocks = xb[..., idx]                        # (..., nblk, BLOCK)
    H = jnp.fft.rfft(t[::-1], block)             # correlation = conv w/ reversed taps
    Y = jnp.fft.rfft(blocks, axis=-1) * H
    y = jnp.fft.irfft(Y, block, axis=-1)[..., T - 1:]
    return y.reshape(x.shape[:-1] + (-1,))[..., :n_out].astype(jnp.float32)


def _fft_overlap_save_bank(x, w):
    """Batched VALID correlation with PER-CHANNEL kernels: ``x`` (C, N),
    ``w`` (C, K) numpy → (C, N−K+1). One rfft/irfft triple for the whole
    bank — a single-channel overlap-save call is dispatch-bound, so C
    separate calls would cost C× that."""
    w = np.asarray(w, np.float32)
    K = w.shape[-1]
    n_out = x.shape[-1] - (K - 1)
    block = min(_FFT_BLOCK,
                max(2048, 1 << int(np.ceil(np.log2(4 * K))),
                    1 << int(np.ceil(np.log2(max(x.shape[-1], 2))))))
    if block <= K:
        block = 1 << int(np.ceil(np.log2(2 * K)))
    hop = block - K + 1
    nblk = -(-n_out // hop)
    total = nblk * hop + K - 1
    xb = jnp.pad(x, ((0, 0), (0, max(total - x.shape[-1], 0))))
    idx = np.arange(nblk)[:, None] * hop + np.arange(block)[None, :]
    blocks = xb[:, idx]                          # (C, nblk, BLOCK)
    H = jnp.fft.rfft(jnp.asarray(w[:, ::-1].copy()), block)     # (C, nf)
    Y = jnp.fft.rfft(blocks, axis=-1) * H[:, None, :]
    y = jnp.fft.irfft(Y, block, axis=-1)[..., K - 1:]
    return y.reshape(x.shape[0], -1)[:, :n_out].astype(jnp.float32)


def fir_filter_aligned_bank(pairs):
    """Aligned same-length filtering of several signals, EACH with its own
    taps, fused into one overlap-save program.

    ``pairs``: list of (x, taps) with every ``x`` (n,) real or complex and
    every ``taps`` odd-length numpy. Returns the list of filtered signals,
    each exactly ``fir_filter_aligned(x, taps)`` up to FFT rounding.
    Complex signals ride as two real channels. Used by composite receivers
    (FM stereo+RDS: 4 long FIRs → one program, ~10.9 → ~2 ms)."""
    xs = [jnp.asarray(x) for x, _ in pairs]
    n = xs[0].shape[-1]
    taps = [np.asarray(t, np.float32) for _, t in pairs]
    gds = [group_delay(t) for t in taps]
    G = max(gds)
    L = max(len(t) - 1 - gd for t, gd in zip(taps, gds))
    K = G + L + 1
    chans, kerns, spec = [], [], []
    r0 = 0
    for x, t, gd in zip(xs, taps, gds):
        # aligned output y[i] = Σ_j t[j]·x[i+gd−j]  →  VALID correlation
        # of x left-padded by G / right-padded by L with kernel
        # w[G+gd−j] = t[j]
        w = np.zeros(K, np.float32)
        w[G + gd - np.arange(len(t))] = t
        lead = x.shape[:-1]
        rows = int(np.prod(lead, dtype=np.int64)) if lead else 1
        if jnp.iscomplexobj(x):
            chans += [x.real.reshape(rows, n), x.imag.reshape(rows, n)]
            kerns.append(np.broadcast_to(w, (2 * rows, K)))
            spec.append(("c", r0, rows, lead))
            r0 += 2 * rows
        else:
            chans.append(x.reshape(rows, n))
            kerns.append(np.broadcast_to(w, (rows, K)))
            spec.append(("r", r0, rows, lead))
            r0 += rows
    X = jnp.pad(jnp.concatenate(chans, axis=0), ((0, 0), (G, L)))
    Y = _fft_overlap_save_bank(X, np.concatenate(kerns, axis=0))
    out = []
    for kind, r, rows, lead in spec:
        if kind == "c":
            y = (Y[r:r + rows] + 1j * Y[r + rows:r + 2 * rows]
                 ).astype(jnp.complex64)
        else:
            y = Y[r:r + rows]
        out.append(y.reshape(lead + (n,)) if lead else y[0])
    return out


def _conv_valid_f32(x, taps):
    """Correlate (..., n) float32 with taps; VALID padding.

    y[i] = sum_j taps[j] * x[i + ntaps-1 - j]  (causal FIR over pre-padded x).

    Two lowerings: FFT overlap-save from ``_FFT_MIN_TAPS`` taps on (whose
    cost does not grow with the tap count, and whose compile time stays
    small where an XLA conv's grows with the kernel size), an XLA conv
    below.
    """
    t = np.asarray(taps, dtype=np.float32)
    T = len(t)
    n_out = x.shape[-1] - (T - 1)
    if T >= _FFT_MIN_TAPS and n_out > 0:
        return _fft_overlap_save(x, t)
    lead = x.shape[:-1]
    xb = x.reshape((-1, 1, x.shape[-1]))
    k = jnp.asarray(t)[::-1].reshape((1, 1, -1))
    y = lax.conv_general_dilated(
        xb, k, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    return y.reshape(lead + (y.shape[-1],))


def _causal_conv(x, taps, state=None):
    """Causal FIR with explicit tail state. Returns (y, new_state)."""
    x = jnp.asarray(x)
    ntaps = len(taps)
    if ntaps == 1:
        y = x * jnp.asarray(taps[0], dtype=jnp.float32)
        return y, state if state is not None else jnp.zeros(x.shape[:-1] + (0,), x.dtype)
    if state is None:
        state = jnp.zeros(x.shape[:-1] + (ntaps - 1,), dtype=x.dtype)
    xp = jnp.concatenate([state, x], axis=-1)
    if jnp.iscomplexobj(xp):
        yr = _conv_valid_f32(xp.real.astype(jnp.float32), taps)
        yi = _conv_valid_f32(xp.imag.astype(jnp.float32), taps)
        y = (yr + 1j * yi).astype(jnp.complex64)
    else:
        y = _conv_valid_f32(xp.astype(jnp.float32), taps)
    return y, xp[..., xp.shape[-1] - (ntaps - 1):]


def fir_apply(x, taps, state=None):
    """Streaming (causal) FIR: output lags input by group_delay(taps).

    Equivalent of FirLowpass(Iq)::process / push (dsp/fir.rs:47-67, 229-257).
    Returns (y, state) where state is the carried input tail.
    """
    return _causal_conv(x, taps, state)


def fir_filter_aligned(x, taps):
    """Group-delay-compensated, same-length filtering (zero edge extension).

    Equivalent of FirLowpassIq::filter_aligned (dsp/fir.rs:260-297): output
    sample i is the filtered value of input sample i; the leading/trailing
    ``group_delay`` samples carry the edge transient.
    """
    x = jnp.asarray(x)
    gd = group_delay(taps)
    n = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, gd)]
    xp = jnp.pad(x, pad)
    y, _ = _causal_conv(xp, taps)
    return y[..., gd:gd + n]


def fir_decimate(x, taps, m: int, state=None):
    """Lowpass + take-every-mth (ref FirDecimator, dsp/decim.rs:10-77).

    Output sample j is the filtered input at index j*m (phase 0), matching the
    reference. Returns (y, state).
    """
    y, state = _causal_conv(x, taps, state)
    return y[..., ::m], state
