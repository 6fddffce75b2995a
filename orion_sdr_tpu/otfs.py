"""OTFS (Orthogonal Time Frequency Space) modulation over the OFDM grid.

The second member of the reference's *planned* multicarrier family
(/root/reference/docs/features.md: "first of a planned multicarrier family
... DFT-s-OFDM/SC-FDMA and OTFS to follow" — unimplemented there; this and
:func:`orion_sdr_tpu.ofdm.dft_precode` implement the family).

OTFS places data symbols on a delay-Doppler (DD) grid ``x[k, l]``
(k = Doppler bin 0..N−1, l = delay bin 0..M−1), spreads them over the
whole time-frequency (TF) frame with the inverse symplectic finite Fourier
transform (ISFFT), and transmits the TF grid as N ordinary CP-OFDM symbols
(the Heisenberg transform). Every DD symbol therefore rides ALL N symbols
× M carriers: under a doubly selective (time- AND frequency-varying)
channel each symbol sees the frame-average SNR instead of its worst
fade — full time-frequency diversity, at OFDM's cost.

Design: the ISFFT/SFFT are one batched 2-D FFT pair over the
(..., N, M) grid (no per-symbol loop), and the TF frame
reuses the whole-frame ``grid_map``/``ofdm_assemble``/``symbol_fft``
machinery — OTFS here is a ~60-line pre/post-transform, not a new stack.

CP-OFDM-based OTFS (a.k.a. OTFS-OFDM) is used, matching the practical
variant: per-symbol CP keeps the one-tap TF equalizer exact for in-guard
delay spread; time variation across the frame is handled by per-symbol
equalization (``pilot_interp`` or a per-symbol estimate) before the SFFT.

Receiver optimality note: because the per-symbol channel is diagonal in
the TF domain and the ISFFT is unitary (white DD data ⇒ white TF data),
per-cell TF LMMSE (``noise_var > 0``) followed by the SFFT IS the exact
linear-MMSE estimate of the DD symbols — there is no better linear
receiver to add. The residual "self-interference" from non-uniform MMSE
gains is the irreducible LMMSE error; closing the remaining gap to ML
detection takes iterative DD-domain cancellation, which the measured
diversity regime (tests/test_otfs.py) does not need.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .constellation import map_bits, BITS_PER_SYMBOL
from .multicarrier import grid_map, ofdm_assemble, symbol_taper, symbol_fft, grid_extract
from .dsp.osc import rotate
from .dsp.device import cjit
from .ofdm import OfdmConfig, zf_equalize, mmse_equalize


def isfft(dd):
    """Inverse symplectic finite Fourier transform, DD → TF (unitary).

    ``dd``: (..., N, M) delay-Doppler grid. Returns the (..., N, M)
    time-frequency grid X[n, m] = (1/√(NM))·Σₖ Σₗ x[k,l]·e^{2πi(nk/N − ml/M)}
    — an inverse DFT along the Doppler axis and a forward DFT along the
    delay axis.
    """
    z = jnp.asarray(dd)
    n, m = z.shape[-2], z.shape[-1]
    out = jnp.fft.fft(jnp.fft.ifft(z, axis=-2), axis=-1)
    return (out * jnp.float32(np.sqrt(n / m))).astype(jnp.complex64)


def sfft(tf):
    """Symplectic finite Fourier transform, TF → DD (inverse of :func:`isfft`)."""
    z = jnp.asarray(tf)
    n, m = z.shape[-2], z.shape[-1]
    out = jnp.fft.fft(jnp.fft.ifft(z, axis=-1), axis=-2)
    return (out * jnp.float32(np.sqrt(m / n))).astype(jnp.complex64)


def otfs_num_symbols(cfg: OfdmConfig, n_bits: int, n_doppler: int) -> int:
    """OFDM symbols an ``n_bits`` OTFS transmission occupies: bits are
    zero-padded up to whole N-symbol OTFS frames."""
    per_frame = n_doppler * cfg.bits_per_ofdm_symbol()
    return n_doppler * (-(-n_bits // per_frame))


@cjit
def otfs_mod(cfg: OfdmConfig, bits, n_doppler: int, phase0=0.0):
    """bits → IQ via the delay-Doppler grid.

    Bits map to constellation points row-major on (Doppler, delay) grids of
    ``n_doppler`` × ``num_data_carriers`` per OTFS frame (zero-padded up to
    whole frames), ISFFT to the TF grid, then transmit as ``n_doppler``
    CP-OFDM symbols per frame through the config's ordinary TX chain
    (taper, gain, RF rotator, TX lowpass). Returns (iq, rf_phase_out).
    """
    g = cfg.grid()
    bits = jnp.asarray(bits)
    m_d = g.num_data_carriers
    bps = cfg.bits_per_ofdm_symbol()
    n_sym = otfs_num_symbols(cfg, bits.shape[-1], n_doppler)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    syms = map_bits(bits, cfg.constellation)
    dd = syms.reshape(syms.shape[:-1] + (n_sym // n_doppler, n_doppler, m_d))
    tf = isfft(dd)
    freq = grid_map(g, tf.reshape(tf.shape[:-3] + (n_sym, m_d)))
    taper = symbol_taper(cfg.samples_per_ofdm_symbol(),
                         cfg.carrier_plan.window_roll_off)
    t = ofdm_assemble(freq, cfg.carrier_plan.cp_len, taper=taper) * cfg.gain
    if cfg.rf_hz != 0.0:
        t, phase0 = rotate(t, cfg.rf_hz, cfg.fs, phase0)
    if cfg.tx_lowpass is not None:
        t = cfg.tx_lowpass.apply(t)
    return t.astype(jnp.complex64), phase0


@cjit
def otfs_demod(cfg: OfdmConfig, iq, n_doppler: int, n_symbols=None,
               estimate=None, noise_var: float = 0.0, phase0=0.0):
    """IQ → soft delay-Doppler symbols (..., n_sym, num_data_carriers).

    The TF grid is recovered with the ordinary per-symbol FFT, one-tap
    equalized, then SFFT'd back to the DD domain. ``estimate``: (n_fft,)
    held or (n_sym, n_fft) per-symbol channel; when
    ``cfg.equalizer_method == 'pilot_interp'`` and the plan carries
    pilots, the channel is instead re-estimated every symbol — the right
    mode for the time-varying channels OTFS exists for. ``noise_var`` > 0
    selects the LMMSE one-tap equalizer instead of ZF: essential for
    OTFS's diversity to pay off, since ZF would amplify the noise of a
    faded cell by 1/|h|² and the SFFT would then average that blow-up
    into EVERY symbol. ``n_symbols`` must cover whole OTFS frames.
    Output flattens the per-frame (N, M) grids back to (n_sym, M) rows,
    mirroring the TX mapping, so ``ofdm_decide``/``ofdm_soft_demod``
    apply unchanged.
    """
    g = cfg.grid()
    z = jnp.asarray(iq)
    if cfg.rf_hz != 0.0:
        z, phase0 = rotate(z, -cfg.rf_hz, cfg.fs, phase0)
    freq = symbol_fft(z, g.n_fft, g.cp_len, backoff=cfg.rx_window_backoff,
                      n_symbols=n_symbols)
    eq = ((lambda x, h: mmse_equalize(x, h, noise_var)) if noise_var > 0.0
          else zf_equalize)
    if cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size:
        from .ofdm import channel_estimate_pilots
        known = g.pilot_values * np.complex64(cfg.gain)
        est = channel_estimate_pilots(freq, g.pilot_bins, known, g.n_fft)
        freq = eq(freq, est)
    elif estimate is not None:
        freq = eq(freq, estimate)
    tf = grid_extract(g, freq) / cfg.gain
    n_sym, m_d = tf.shape[-2], tf.shape[-1]
    dd = sfft(tf.reshape(tf.shape[:-2] + (n_sym // n_doppler, n_doppler, m_d)))
    return (dd.reshape(dd.shape[:-3] + (n_sym, m_d)).astype(jnp.complex64),
            phase0)
