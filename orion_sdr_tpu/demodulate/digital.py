"""Single-carrier digital demod stages (ref: demodulate/{bpsk,qpsk,qam}.rs).

IQ → psk_qam_demod (carrier removal + gain) → soft symbols → decide / soft_llr.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit as _cjit

from ..constellation import decide
from ..dsp.osc import rotate


@_cjit
def psk_qam_demod(iq, fs, rf_hz=0.0, gain=1.0, phase0=0.0):
    """Carrier removal + gain: soft symbol passthrough (ref: BpskDemod etc.).

    Returns (soft_symbols, phase_out)."""
    z = jnp.asarray(iq)
    if rf_hz != 0.0:
        z, phase0 = rotate(z, -rf_hz, fs, phase0)
    return (z * gain).astype(jnp.complex64), phase0


@_cjit
def digital_demod(iq, order, fs, rf_hz=0.0, gain=1.0, phase0=0.0):
    """IQ → hard bits in one call. Returns (bits, phase_out)."""
    soft, phase = psk_qam_demod(iq, fs, rf_hz, gain, phase0)
    return decide(soft, order), phase


def estimate_cfo_mpsk(iq, fs: float, m: int = 4) -> float:
    """Blind carrier-offset estimate for M-PSK bursts (beyond the
    reference, which assumes a known rf_hz): raising z to the M-th power
    wipes the modulation, leaving a tone at M·CFO — read its frequency
    from the phase ramp of z^M. Capture range ±fs/(2M).

    Vectorized: one elementwise power + one delay-conjugate mean."""
    z = np.asarray(iq)
    ang = float(_cfo_est_kernel(np.ascontiguousarray(z.real, np.float32),
                                np.ascontiguousarray(z.imag, np.float32),
                                int(m)))
    return ang * fs / (2.0 * np.pi * m)


@_cjit
def _cfo_est_kernel(re, im, m: int):
    z = (re + 1j * im) ** m
    prod = jnp.sum(z[..., 1:] * jnp.conj(z[..., :-1]), axis=-1)
    return jnp.arctan2(prod.imag, prod.real).astype(jnp.float32)


def fde_equalize(iq, training, block: int = 256, noise_var: float = 1e-3):
    """Single-carrier frequency-domain equalization (SC-FDE — beyond the
    reference, which has no single-carrier channel equalizer): estimate
    the channel by correlating against a known ``training`` burst at the
    capture start, then apply the MMSE inverse per overlap-save block.

    Design: channel estimate = one FFT ratio; equalization = batched
    FFT → elementwise MMSE weight → IFFT with 50% overlap-save. Returns
    the equalized capture (same length, training included)."""
    t = np.asarray(training)
    z = np.asarray(iq)
    n_t = len(t)
    if n_t < 8 or len(z) < n_t:
        raise ValueError("training must be ≥8 samples and fit the capture")
    L = min(block, 1 << int(np.floor(np.log2(n_t))))
    out = _fde_kernel(np.ascontiguousarray(z.real, np.float32),
                      np.ascontiguousarray(z.imag, np.float32),
                      np.ascontiguousarray(t.real, np.float32),
                      np.ascontiguousarray(t.imag, np.float32),
                      int(L), int(n_t), float(noise_var))
    return np.asarray(out)[:len(z)]


@_cjit
def _fde_kernel(zr, zi, tr, ti, L: int, n_t: int, noise_var: float):
    zz = zr + 1j * zi
    tt = tr + 1j * ti
    # channel estimate: average the per-block spectral ratio over the
    # training region (regularized least squares per bin)
    nb_t = n_t // L
    rxb = zz[: nb_t * L].reshape(nb_t, L)
    txb = tt[: nb_t * L].reshape(nb_t, L)
    rf = jnp.fft.fft(rxb, axis=-1)
    tf = jnp.fft.fft(txb, axis=-1)
    h = (jnp.sum(rf * jnp.conj(tf), axis=0)
         / (jnp.sum(jnp.abs(tf) ** 2, axis=0) + 1e-9))
    # MMSE weight, applied overlap-save with 50% overlap; zero-pad so the
    # block grid covers the whole capture (the output keeps same-length)
    w = jnp.conj(h) / (jnp.abs(h) ** 2 + noise_var)
    n = zz.shape[-1]
    hop = L // 2
    nblk = -(-(n - L) // hop) + 1 if n > L else 1
    total = (nblk - 1) * hop + L
    zz = jnp.concatenate([zz, jnp.zeros(total - n, zz.dtype)])
    idx = jnp.arange(nblk)[:, None] * hop + jnp.arange(L)[None, :]
    blocks = zz[idx]
    eq = jnp.fft.ifft(jnp.fft.fft(blocks, axis=-1) * w, axis=-1)
    # keep each block's central half (discard circular edges)
    q = L // 4
    core = eq[:, q:q + hop].reshape(-1)
    head = eq[0, :q]
    tail = eq[-1, q + hop:]
    return jnp.concatenate([head, core, tail])


def symbol_sync_gardner(x, sps: float, n_out: int, loop_bw: float = 0.02,
                        mu0: float = 0.0):
    """Gardner timing recovery: fractional-delay symbol sampling driven by
    the mid-symbol error e = Re[(y_k − y_{k−1})·conj(y_mid)] — a
    per-symbol recurrence expressed as one lax.scan (beyond the
    reference, which has no timing recovery for single-carrier bursts).

    Returns (symbols[n_out], final_position)."""
    x = np.asarray(x)
    return _gardner_kernel(np.ascontiguousarray(x.real, np.float32),
                           np.ascontiguousarray(x.imag, np.float32),
                           float(sps), int(n_out), float(loop_bw),
                           float(mu0))


@_cjit
def _gardner_kernel(re, im, sps: float, n_out: int, loop_bw: float,
                    mu0: float):
    import jax
    z = re + 1j * im
    # normalize: the Gardner error term is amplitude-squared — the
    # loop gain (and the ±1 error clip) assume unit-RMS symbols
    z = z / jnp.sqrt(jnp.mean(jnp.abs(z) ** 2) + 1e-12)
    n = z.shape[-1]
    kp = loop_bw
    ki = loop_bw * loop_bw / 4.0

    def interp(pos):
        i = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
        frac = pos - i
        return z[i] * (1 - frac) + z[i + 1] * frac

    def step(carry, _):
        pos, rate, prev = carry
        y = interp(pos)
        y_mid = interp(pos - rate / 2.0)
        # NEGATIVE sign: with this interpolator's conventions the
        # raw Gardner term pushes AWAY from the symbol peak (verified
        # against a host reference loop — +sign parks at the
        # metastable midpoint)
        e = -((y - prev) * jnp.conj(y_mid)).real
        e = jnp.clip(e, -1.0, 1.0)
        rate2 = jnp.clip(rate + ki * e, sps * 0.95, sps * 1.05)
        pos2 = pos + rate2 + kp * e
        return (pos2, rate2, y), y

    carry0 = (jnp.float32(sps * 1.0 + mu0), jnp.float32(sps),
              jnp.complex64(0))
    (_pos, _rate, _prev), syms = jax.lax.scan(step, carry0, None,
                                              length=n_out)
    return syms, _pos


def symbol_sync_energy(x, sps: int):
    """Burst timing by polyphase energy: after matched filtering, the RRC
    symbol peaks concentrate energy in one of the sps sample phases —
    pick it, sample there (one reshape + argmax; robust for bursts where
    TX/RX clocks match to ≪1 symbol over the burst).

    Returns (symbols, phase_index), symbols normalized to unit RMS."""
    z = np.asarray(x)
    n = (len(z) // sps) * sps
    grid = z[:n].reshape(-1, sps)
    ph = int(np.argmax(np.mean(np.abs(grid) ** 2, axis=0)))
    syms = grid[:, ph]
    return (syms / (np.sqrt(np.mean(np.abs(syms) ** 2)) + 1e-12)).astype(
        np.complex64), ph


def carrier_sync_dd(syms, order: str, loop_bw: float = 0.03):
    """Decision-directed carrier phase/frequency PLL over recovered
    symbols (scan; error = angle of y against its nearest constellation
    point). Returns derotated symbols."""
    s = np.asarray(syms)
    return np.asarray(_dd_pll_kernel(
        np.ascontiguousarray(s.real, np.float32),
        np.ascontiguousarray(s.imag, np.float32), order, float(loop_bw)))


@_cjit
def _dd_pll_kernel(re, im, order: str, loop_bw: float):
    import jax
    from ..constellation import map_bits, decide
    z = re + 1j * im
    kp = loop_bw
    ki = loop_bw * loop_bw / 4.0

    def step(carry, zk):
        phase, freq = carry
        y = zk * jnp.exp(-1j * phase)
        ref = map_bits(decide(y[None], order), order)[0]
        err = jnp.angle(y * jnp.conj(ref))
        freq2 = freq + ki * err
        phase2 = phase + freq2 + kp * err
        return (phase2, freq2), y

    _, out = jax.lax.scan(step, (jnp.float32(0), jnp.float32(0)), z)
    return out


def burst_demod(iq, order: str, sps: int, preamble_syms, beta: float = 0.35,
                span: int = 8, cfo_sps_max: float = 0.01):
    """Single-carrier burst receiver (beyond the reference): matched RRC →
    polyphase-energy symbol timing → CFO-tolerant segmented preamble
    search → data-aided phase-ramp fit on the known preamble (absolute
    phase + residual CFO; no 90°·k ambiguity, which dense QAM's DD loop
    cannot resolve alone) → light DD tracking over the payload → bits.
    The burst must begin with ``preamble_syms`` (see
    modulate.digital.burst_preamble)."""
    from ..modulate.digital import rrc_taps
    from ..dsp.fir import fir_filter_aligned
    from ..dsp.osc import rotate
    from ..constellation import decide
    import jax.numpy as _j

    z = np.asarray(iq, np.complex64)
    taps = rrc_taps(sps, beta, span)
    zf = np.asarray(fir_filter_aligned(_j.asarray(z), taps))
    if int(len(zf) / sps) - span < len(preamble_syms) + 4:
        raise ValueError("burst too short for the preamble")
    syms, _ph = symbol_sync_energy(zf, sps)
    # locate the preamble with a CFO-tolerant metric: sub-block
    # correlations summed by MAGNITUDE only decohere within each 8-symbol
    # block, so a CFO ramp that would null the full-length correlation
    # still peaks here (no unreliable 4th-power pre-estimate needed — on
    # dense QAM its tone is weak and a wrong estimate is worse than none)
    pre = np.asarray(preamble_syms, np.complex64)
    nb = max(len(pre) // 8, 1)
    blk = len(pre) // nb
    corr = None
    for b in range(nb):
        c = np.abs(np.correlate(syms[b * blk:], pre[b * blk:(b + 1) * blk],
                                mode="valid"))
        m = len(syms) - len(pre) + 1
        c = c[:m]
        corr = c if corr is None else corr[:len(c)] + c
    k = int(np.argmax(corr))
    # …then a data-aided phase-ramp fit on the known preamble pins the
    # residual CFO AND the absolute phase (no 90°·k ambiguity left —
    # dense QAM's decision-directed loop cannot pull in from a large
    # initial phase error on its own)
    seg = syms[k: k + len(pre)]
    dphi = np.unwrap(np.angle(seg * np.conj(pre)))
    j = np.arange(len(pre))
    slope, intercept = np.polyfit(j, dphi, 1)
    idx = np.arange(len(syms)) - k
    syms = syms * np.exp(-1j * (intercept + slope * idx))
    # light decision-directed tracking for whatever drift remains — over
    # the PAYLOAD only (the QPSK preamble decided against a dense QAM grid
    # would walk the loop's phase off before the data starts)
    payload = np.asarray(carrier_sync_dd(syms[k + len(pre):], order,
                                         loop_bw=0.01))
    bits = np.asarray(decide(_j.asarray(payload.astype(np.complex64)),
                             order)).reshape(-1)
    return bits, payload
