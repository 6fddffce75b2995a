"""PSK31 demodulators (behavioral spec: demodulate/psk31.rs).

Decision-feedback matched filtering over the full symbol period with a
first-order decision-directed PLL (AFC, K = 0.05) at each symbol boundary.

Design: the reference runs a per-sample loop
    corrected[n] = s[n] − prev_sym·(1−h[n]);   acc += h[n]·corrected[n]
but the feedback term is linear in prev_sym, so the whole symbol integral
collapses to
    sym = (⟨h, s_k⟩ − prev_sym·Σh(1−h)) · gain / Σh²
The heavy part ⟨h, s_k⟩ for all symbols is ONE matmul of the reshaped
(n_syms, sps) capture against the Hann window — one matmul — leaving only a
light per-symbol `lax.scan` for the PLL/feedback recurrence (batch across
channels/candidates via vmap for throughput, per SURVEY §7).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.osc import rotate
from ..dsp.device import cjit
from ..modulate.psk31 import psk31_sps, psk31_hann

BPSK31_LOOP_GAIN = 0.05
QPSK31_LOOP_GAIN = 0.05


def hard_decide_dbpsk(d_re):
    """±1.0 by sign of the differential real component."""
    return jnp.where(d_re >= 0.0, 1.0, -1.0)


def hard_decide_dqpsk(d_re, d_im):
    """Nearest unit-axis phasor (±1, 0) or (0, ±1), as (re, im)."""
    re_wins = jnp.abs(d_re) >= jnp.abs(d_im)
    dec_re = jnp.where(re_wins, jnp.where(d_re >= 0.0, 1.0, -1.0), 0.0)
    dec_im = jnp.where(re_wins, 0.0, jnp.where(d_im >= 0.0, 1.0, -1.0))
    return dec_re, dec_im


def _wrap_pi(x):
    return jnp.mod(x + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _dfm_core(z, sps: int, gain: float, qpsk: bool,
              prev_sym0=1.0 + 0.0j, phase_acc0=0.0):
    """Shared decision-feedback matched filter + PLL.

    z: (..., n) complex64 baseband at sps samples/symbol (n a multiple of sps).
    Returns (soft, (prev_sym, phase_acc)): soft is (..., n_syms) for BPSK
    (Re of the differential product) or (..., n_syms, 2) for QPSK
    (phase-corrected [Re, Im] differential products).
    """
    seg = z.reshape(z.shape[:-1] + (-1, sps))
    h = jnp.asarray(psk31_hann(sps))
    dots = seg @ h.astype(seg.real.dtype)   # (..., n_syms) — the matmul
    return _pll_scan(dots, sps, gain, qpsk, prev_sym0, phase_acc0)


def _pll_scan(dots, sps: int, gain: float, qpsk: bool,
              prev_sym0=1.0 + 0.0j, phase_acc0=0.0):
    """The per-symbol decision-feedback + PLL recurrence over precomputed
    matched-filter dot products (..., n_syms). Split out so the time-sharded
    path (parallel/streaming.py) can shard the heavy matmul across devices
    and run this light recurrence on the all-gathered dots."""
    h = jnp.asarray(psk31_hann(sps))
    c_fb = jnp.sum(h * (1.0 - h))          # decision-feedback constant Σh(1−h)
    scale = gain / jnp.sum(h * h)
    loop_gain = QPSK31_LOOP_GAIN if qpsk else BPSK31_LOOP_GAIN

    def step(carry, dot_k):
        prev_sym, phase_acc = carry
        sym = (dot_k - prev_sym * c_fb) * scale
        sym_c = sym * jnp.exp(-1j * phase_acc)
        d = sym_c * jnp.conj(prev_sym)
        d_re, d_im = d.real, d.imag
        if qpsk:
            dec_re, dec_im = hard_decide_dqpsk(d_re, d_im)
            cross_im = d_im * dec_re - d_re * dec_im
            out = jnp.stack([d_re, d_im], axis=-1)
        else:
            dec_re = hard_decide_dbpsk(d_re)
            cross_im = d_im * dec_re
            out = d_re
        mag_sq = d_re * d_re + d_im * d_im
        phase_err = jnp.where(mag_sq > 1e-6, cross_im * jax.lax.rsqrt(mag_sq), 0.0)
        phase_acc = _wrap_pi(phase_acc + loop_gain * phase_err)
        return (sym_c, phase_acc), out

    # scan over the symbol axis (second-to-last of dots' layout)
    dots_t = jnp.moveaxis(dots, -1, 0)
    carry0 = (jnp.broadcast_to(jnp.asarray(prev_sym0, jnp.complex64), dots_t.shape[1:]),
              jnp.broadcast_to(jnp.asarray(phase_acc0, jnp.float32), dots_t.shape[1:]))
    carry, soft = jax.lax.scan(step, carry0, dots_t)
    return jnp.moveaxis(soft, 0, -1 if not qpsk else -2), carry


def _prep(iq, fs: float, rf_hz: float, offset: int):
    """Down-mix and trim to whole symbols starting at the symbol boundary
    implied by ``offset`` samples already consumed (ref new_with_offset)."""
    sps = psk31_sps(fs)
    z = jnp.asarray(iq)
    if rf_hz != 0.0:
        z, _ = rotate(z, -rf_hz, fs)
    lead = (sps - (offset % sps)) % sps
    n = z.shape[-1]
    n_syms = max((n - lead) // sps, 0)
    z = jax.lax.slice_in_dim(z, lead, lead + n_syms * sps, axis=-1)
    return z, sps, n_syms


@cjit
def bpsk31_demod(iq, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 offset: int = 0):
    """IQ → one soft value per symbol: Re(sym_c·conj(prev_sym)).
    Positive ⇒ bit 1 (no phase change), negative ⇒ bit 0 (flip)."""
    z, sps, n_syms = _prep(iq, fs, rf_hz, offset)
    if n_syms == 0:
        return jnp.zeros(z.shape[:-1] + (0,), jnp.float32)
    soft, _ = _dfm_core(z, sps, gain, qpsk=False)
    return soft.real.astype(jnp.float32)


@cjit
def qpsk31_demod(iq, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 offset: int = 0):
    """IQ → (n_syms, 2) float32 [Re(d), Im(d)] differential products for the
    Viterbi MLSE (ref Qpsk31Demod)."""
    z, sps, n_syms = _prep(iq, fs, rf_hz, offset)
    if n_syms == 0:
        return jnp.zeros(z.shape[:-1] + (0, 2), jnp.float32)
    soft, _ = _dfm_core(z, sps, gain, qpsk=True)
    return soft.astype(jnp.float32)


def bpsk31_decide(soft) -> np.ndarray:
    """Hard decision: soft ≥ 0 → bit 1 (ref Bpsk31Decider)."""
    return (np.asarray(soft) >= 0.0).astype(np.uint8)


@cjit
def psk31_refine_carriers(iq, fs: float, carriers_hz, qpsk: bool = False,
                          starts=None, length: int = 0,
                          max_df_hz: float = 0.0):
    """Refine waterfall-bin-granular carrier estimates to FFT resolution.

    The waterfall search (sync/psk31_sync.py) is bin-granular, so a
    real carrier can sit up to ±bin/2 off grid — far beyond the
    AFC PLL's pull range. Squaring removes BPSK modulation entirely
    (z = a·±e^{jθ} ⇒ z² = a²e^{2jθ}), leaving a spectral line at 2·Δf
    (z⁴ and 4·Δf for QPSK); one batched FFT of the mixed-down rows resolves
    it to fs/n. Returns (K,) refined carriers_hz.

    ``starts`` ((K,) int32 sample offsets) with static ``length`` restricts
    each estimate to that carrier's detected run (row rolled to its run
    start, truncated to ``length`` samples), and a Hann matched-filter
    lowpass suppresses out-of-band noise before the squaring nonlinearity.
    Without both, full-band noise and the noise-only buffer regions
    intermodulate into the ±baud search window and weak-carrier refinement
    in a crowded band can land several Hz off — fatal for the differential
    demod (10 Hz ≈ 115°/symbol).

    ``max_df_hz`` bounds the true carrier offset when the caller knows it
    (half-baud waterfall bins ⇒ ≤ baud/4). The squared signal also carries
    envelope-modulation sidebands at 2Δf ± k·baud (the Hann pulse shaping
    dips the amplitude at every phase reversal), and with the default
    ±1.12·baud window the k=1 sideband of a noisy carrier can out-peak the
    main line — a characteristic ±baud/2 estimate error. A window of
    p·max_df_hz ≤ baud/2 excludes it. A 3-point parabolic interpolation on
    the FFT ring gives sub-bin accuracy."""
    from ..modulate.psk31 import PSK31_BAUD
    z = jnp.asarray(iq)
    f = jnp.asarray(carriers_hz, jnp.float32).reshape(-1)
    zb, _ = rotate(z[None, :], -f[:, None], fs)
    if starts is not None:
        s = jnp.asarray(starts, jnp.int32).reshape(-1)
        zb = jax.vmap(lambda r, o: jnp.roll(r, -o))(zb, s)
    if length and length < zb.shape[-1]:
        zb = zb[:, :length]
    h = jnp.asarray(psk31_hann(psk31_sps(fs)))
    zb = jax.vmap(lambda r: jnp.convolve(r, h, mode="same"))(zb)
    w = zb * zb
    p = 2
    if qpsk:
        w = w * w
        p = 4
    S = jnp.abs(jnp.fft.fft(w, axis=-1))
    nfft = w.shape[-1]
    freqs = jnp.fft.fftfreq(nfft, 1.0 / fs).astype(jnp.float32)
    lim = p * max_df_hz if max_df_hz > 0.0 else PSK31_BAUD * (p / 2) * 1.12
    Sm = jnp.where(jnp.abs(freqs)[None, :] <= lim, S, -1.0)
    idx = jnp.argmax(Sm, axis=-1)
    # ring-adjacent 3-point parabola: fftfreq steps +fs/n per index even
    # across the 0 wrap, so δ in index units converts linearly to Hz
    sl = jnp.take_along_axis(S, (idx[:, None] - 1) % nfft, axis=-1)[:, 0]
    sp = jnp.take_along_axis(S, idx[:, None], axis=-1)[:, 0]
    sr = jnp.take_along_axis(S, (idx[:, None] + 1) % nfft, axis=-1)[:, 0]
    den = sl - 2.0 * sp + sr
    delta = jnp.where(jnp.abs(den) > 1e-20, 0.5 * (sl - sr) / den, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    df = (freqs[idx] + delta * (fs / nfft)) / p
    return f + df


@cjit
def psk31_demod_multi(iq, fs: float, carriers_hz, gain: float = 1.0,
                      qpsk: bool = False, starts=None):
    """Demodulate ONE capture against K carriers in ONE device program.

    ``carriers_hz`` is a (K,) dynamic array (no retrace per carrier set).
    The mix is a broadcast phase ramp (K, n); per-carrier symbol timing is
    recovered on device (matched-filter conv + symbol-cadence energy fold
    over all sps offsets, argmax per carrier); the matched filter is one
    batched matmul; the K PLL recurrences run in a single vmapped scan.
    Returns ((K, n_syms) soft (BPSK) or (K, n_syms, 2) (QPSK),
    (K,) int32 per-carrier sample offsets) — the channel-batched form of
    bpsk31_demod/qpsk31_demod (beyond-reference: demodulate/psk31.rs is one
    carrier per Block instance with caller-supplied alignment).

    ``starts`` ((K,) int32 sample offsets) rolls each carrier's row to its
    detected run start so the decision-feedback PLL never tracks leading
    noise — in a long capture the PLL random-walks over a noise-only head
    and can take seconds to re-pull once the signal starts (the wrapped
    buffer tail lands past the decoded run, so it is harmless)."""
    z = jnp.asarray(iq)
    sps = psk31_sps(fs)
    f = jnp.asarray(carriers_hz, jnp.float32).reshape(-1)
    K = f.shape[0]
    n = z.shape[-1]
    n_syms = (n - sps) // sps if n >= 2 * sps else 0
    if n_syms == 0:
        shape = (K, 0, 2) if qpsk else (K, 0)
        return jnp.zeros(shape, jnp.float32), jnp.zeros((K,), jnp.int32)
    zb, _ = rotate(z[None, :], -f[:, None], fs)               # (K, n)
    if starts is not None:
        so = jnp.asarray(starts, jnp.int32).reshape(-1)
        zb = jax.vmap(lambda r, o: jnp.roll(r, -o))(zb, so)
    h = jnp.asarray(psk31_hann(sps)).astype(jnp.float32)

    # timing: matched-filter output energy folded to symbol cadence — the
    # Hann-shaped envelope peaks mid-symbol, so the true boundary offset
    # maximizes Σ_k |<h, z[o + k·sps : +sps]>|²
    mf = jax.vmap(lambda r: jnp.convolve(r, h[::-1], mode="valid"))(zb)
    m = (mf.shape[-1] // sps) * sps
    e = jnp.abs(mf[:, :m]) ** 2
    off = jnp.argmax(e.reshape(K, -1, sps).sum(axis=1), axis=-1)  # (K,)

    take = n_syms * sps
    zal = jax.vmap(
        lambda r, o: jax.lax.dynamic_slice(r, (o,), (take,)))(zb, off)
    soft, _ = _dfm_core(zal, sps, gain, qpsk=qpsk)
    return ((soft if qpsk else soft.real).astype(jnp.float32),
            off.astype(jnp.int32))


@cjit
def stream_step(z, phase0, prev_sym, phase_acc, sps: int, gain: float,
                qpsk: bool, carrier_hz: float, fs: float):
    """One whole-symbol-aligned chunk of the live decode pipeline: carry the
    down-mix phase and the DFM/PLL state across feeds (host boundary safe)."""
    if carrier_hz != 0.0:
        z, _ = rotate(z, -carrier_hz, fs, phase0)
    soft, (prev_out, acc_out) = _dfm_core(z, sps, gain, qpsk=qpsk,
                                          prev_sym0=prev_sym,
                                          phase_acc0=phase_acc)
    return soft, prev_out, acc_out
