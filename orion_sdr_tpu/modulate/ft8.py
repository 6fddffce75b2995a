"""FT8/FT4 CPFSK modulators (behavioral spec: modulate/ft8.rs, modulate/ft4.rs).

FT8: 8-FSK, 6.25 baud, 1920 samples/symbol @ 12 kHz, 79 symbols
(3×7 Costas + 58 data) = 151 680 samples. FT4: 4-FSK, 576 samples/symbol,
105 symbols (2 ramps + 4×4 Costas + 87 data) = 60 480 samples.

Design: the reference's per-sample phasor recurrence (with renorm) is a
closed form — within symbol k the phase is θ_k + (n+1)·φ_k where φ_k is the
tone's per-sample increment and θ_k = Σ_{j<k} sps·φ_j. The per-symbol phase
origins are an exact float64 cumsum over ≤105 symbols (host), and the sample
grid is one (n_syms, sps) broadcast + exp on device — no recurrence, no
drift, phase-continuous by construction.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.osc import rotate
from ..dsp.device import cjit

# FT8 protocol constants (public WSJT-X definition)
FT8_TONE_SPACING_HZ = 6.25
FT8_BAUD = 6.25
FT8_SAMPLES_PER_SYM = 1920          # 12000 / 6.25
FT8_TOTAL_SYMS = 79
FT8_DATA_SYMS = 58
FT8_TONES = 8
FT8_FRAME_LEN = FT8_TOTAL_SYMS * FT8_SAMPLES_PER_SYM   # 151_680

FT8_COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], np.uint8)
FT8_SYNC_POS = ((0, 7), (36, 43), (72, 79))

# FT4 protocol constants
FT4_TONE_SPACING_HZ = 20.833334     # 12000 / 576
FT4_BAUD = FT4_TONE_SPACING_HZ
FT4_SAMPLES_PER_SYM = 576
FT4_TOTAL_SYMS = 105                # R S4 D29 S4 D29 S4 D29 S4 R
FT4_DATA_SYMS = 87
FT4_TONES = 4
FT4_FRAME_LEN = FT4_TOTAL_SYMS * FT4_SAMPLES_PER_SYM   # 60_480

FT4_COSTAS = np.array([[0, 1, 3, 2], [1, 0, 2, 3],
                       [2, 3, 1, 0], [3, 2, 0, 1]], np.uint8)
FT4_SYNC_POS = ((1, 5), (34, 38), (67, 71), (100, 104))


def ft8_symbol_sequence(data_tones) -> np.ndarray:
    """58 data tones → 79-symbol sequence with Costas blocks inserted."""
    syms = np.zeros(FT8_TOTAL_SYMS, np.uint8)
    is_sync = np.zeros(FT8_TOTAL_SYMS, bool)
    for s, e in FT8_SYNC_POS:
        syms[s:e] = FT8_COSTAS
        is_sync[s:e] = True
    syms[~is_sync] = np.asarray(data_tones, np.uint8)
    return syms


def ft8_data_positions() -> np.ndarray:
    """Frame positions of the 58 data symbols: [7,36) ∪ [43,72)."""
    is_sync = np.zeros(FT8_TOTAL_SYMS, bool)
    for s, e in FT8_SYNC_POS:
        is_sync[s:e] = True
    return np.flatnonzero(~is_sync)


def ft4_symbol_sequence(data_tones) -> np.ndarray:
    """87 data tones → 105-symbol sequence with ramps + Costas blocks."""
    syms = np.zeros(FT4_TOTAL_SYMS, np.uint8)
    reserved = np.zeros(FT4_TOTAL_SYMS, bool)
    reserved[0] = reserved[104] = True
    for blk, (s, e) in enumerate(FT4_SYNC_POS):
        syms[s:e] = FT4_COSTAS[blk]
        reserved[s:e] = True
    syms[~reserved] = np.asarray(data_tones, np.uint8)
    return syms


def ft4_data_positions() -> np.ndarray:
    reserved = np.zeros(FT4_TOTAL_SYMS, bool)
    reserved[0] = reserved[104] = True
    for s, e in FT4_SYNC_POS:
        reserved[s:e] = True
    return np.flatnonzero(~reserved)


@cjit
def cpfsk_mod(symbols, sps: int, fs: float, base_hz: float, spacing_hz: float,
              gain: float = 1.0, rf_hz: float = 0.0):
    """Phase-continuous rectangular FSK over a tone-index sequence.

    Matches the reference's running-phasor synthesis (sample n of symbol k
    carries phase θ_k + (n+1)·φ_k — the phasor advances before each output).
    Returns (n_syms·sps,) complex64.
    """
    tones = np.asarray(symbols, np.int64)
    phi = 2.0 * np.pi * (base_hz + tones * spacing_hz) / fs   # float64/sym
    theta = np.concatenate([[0.0], np.cumsum(phi * sps)])[:-1]
    theta = np.remainder(theta, 2.0 * np.pi)
    n = jnp.arange(1, sps + 1, dtype=jnp.float32)
    phase = jnp.asarray(theta, jnp.float32)[:, None] + \
        jnp.asarray(phi, jnp.float32)[:, None] * n[None, :]
    out = (gain * jnp.exp(1j * phase)).reshape(-1).astype(jnp.complex64)
    if rf_hz != 0.0:
        out, _ = rotate(out, rf_hz, fs)
    return out


@cjit
def cpfsk_mod_batch(tones, sps: int, fs: float, base_hz: float,
                    spacing_hz: float, gain: float = 1.0):
    """Batched phase-continuous FSK with RUNTIME tone arrays.

    ``cpfsk_mod`` bakes the tone sequence as a trace-time constant (one
    compile per distinct message — right for a single beacon, wrong for
    many-channel TX). This path takes ``tones`` (..., n_sym) as data:
    per-symbol fractional cycle counts accumulate in a cumsum (mod 1, so
    f32 stays exact at the standard rates where each tone spans an integer
    number of cycles) and the per-sample phase is one broadcast. Matches
    cpfsk_mod to ~1e-3 rad at the FT8/FT4 operating points.
    """
    t = jnp.asarray(tones, jnp.float32)
    # cycles per symbol, folded mod 1 (phase mod 2π) before accumulating
    cyc = (base_hz + t * spacing_hz) * (sps / fs)
    cyc_frac = cyc - jnp.floor(cyc)
    start = jnp.concatenate(
        [jnp.zeros(t.shape[:-1] + (1,), jnp.float32),
         jnp.cumsum(cyc_frac[..., :-1], axis=-1)], axis=-1)
    start = start - jnp.floor(start)
    phi = 2.0 * jnp.pi * (base_hz + t * spacing_hz) / fs    # rad/sample
    n = jnp.arange(1, sps + 1, dtype=jnp.float32)
    phase = (2.0 * jnp.pi * start[..., None]
             + phi[..., None] * n[None, :])
    out = (gain * jnp.exp(1j * phase))
    return out.reshape(out.shape[:-2] + (-1,)).astype(jnp.complex64)


def _ft8_template_and_positions():
    syms = np.zeros(FT8_TOTAL_SYMS, np.uint8)
    for s, e in FT8_SYNC_POS:
        syms[s:e] = FT8_COSTAS
    return syms, ft8_data_positions()


def _ft4_template_and_positions():
    syms = np.zeros(FT4_TOTAL_SYMS, np.uint8)
    for blk, (s, e) in enumerate(FT4_SYNC_POS):
        syms[s:e] = FT4_COSTAS[blk]
    return syms, ft4_data_positions()


def ft8_mod_batch(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
                  gain: float = 1.0):
    """Batched FT8 TX: (..., 58) runtime data tones → (..., 151680) IQ.
    Same waveform as ft8_mod (ref Ft8Mod::modulate) without the per-message
    recompile."""
    template, pos = _ft8_template_and_positions()
    t = jnp.asarray(data_tones)
    syms = jnp.broadcast_to(jnp.asarray(template),
                            t.shape[:-1] + (FT8_TOTAL_SYMS,))
    syms = syms.at[..., pos].set(t.astype(jnp.uint8))
    return cpfsk_mod_batch(syms, FT8_SAMPLES_PER_SYM, fs, base_hz,
                           FT8_TONE_SPACING_HZ, gain)


def ft4_mod_batch(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
                  gain: float = 1.0):
    """Batched FT4 TX: (..., 87) runtime data tones → (..., 60480) IQ."""
    template, pos = _ft4_template_and_positions()
    t = jnp.asarray(data_tones)
    syms = jnp.broadcast_to(jnp.asarray(template),
                            t.shape[:-1] + (FT4_TOTAL_SYMS,))
    syms = syms.at[..., pos].set(t.astype(jnp.uint8))
    return cpfsk_mod_batch(syms, FT4_SAMPLES_PER_SYM, fs, base_hz,
                           FT4_TONE_SPACING_HZ, gain)


def ft8_mod(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
            rf_hz: float = 0.0, gain: float = 1.0):
    """58 data tones → 151 680-sample IQ frame (ref Ft8Mod::modulate)."""
    syms = ft8_symbol_sequence(data_tones)
    return cpfsk_mod(tuple(int(t) for t in syms), FT8_SAMPLES_PER_SYM, fs,
                     base_hz, FT8_TONE_SPACING_HZ, gain, rf_hz)


def ft4_mod(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
            rf_hz: float = 0.0, gain: float = 1.0):
    """87 data tones → 60 480-sample IQ frame (ref Ft4Mod::modulate)."""
    syms = ft4_symbol_sequence(data_tones)
    return cpfsk_mod(tuple(int(t) for t in syms), FT4_SAMPLES_PER_SYM, fs,
                     base_hz, FT4_TONE_SPACING_HZ, gain, rf_hz)
