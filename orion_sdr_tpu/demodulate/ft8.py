"""FT8/FT4 tone demodulators (behavioral spec: demodulate/ft8.rs, ft4.rs).

The reference runs a Goertzel correlator per (symbol, tone) and argmaxes.
Here the whole frame is ONE matmul: reshape to (n_syms, sps), multiply by the
(sps, n_tones) tone-phasor matrix, |·|², argmax — pure matmul work, batchable
over frames via leading dims.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit

from ..sync.waterfall import _tone_matrix
from ..modulate.ft8 import (
    FT8_SAMPLES_PER_SYM, FT8_TOTAL_SYMS, FT8_TONE_SPACING_HZ, FT8_TONES,
    FT8_FRAME_LEN, ft8_data_positions,
    FT4_SAMPLES_PER_SYM, FT4_TOTAL_SYMS, FT4_TONE_SPACING_HZ, FT4_TONES,
    FT4_FRAME_LEN, ft4_data_positions,
)


@cjit
def _detect_tones(iq, fs, base_hz, spacing, sps, n_syms, n_tones):
    z = jnp.asarray(iq)[..., : n_syms * sps]
    seg = z.reshape(z.shape[:-1] + (n_syms, sps))
    w = jnp.asarray(_tone_matrix(float(fs), float(base_hz), float(spacing),
                                 sps, n_tones))
    energy = jnp.abs(seg @ w) ** 2
    return jnp.argmax(energy, axis=-1).astype(jnp.uint8)


def ft8_demod(iq, fs: float = 12000.0, base_hz: float = 1000.0):
    """151 680-sample frame → 58 data tone indices (sync stripped), or None
    if the input is too short (ref Ft8Demod::demodulate)."""
    if np.shape(iq)[-1] < FT8_FRAME_LEN:
        return None
    tones = _detect_tones(iq, fs, base_hz, FT8_TONE_SPACING_HZ,
                          FT8_SAMPLES_PER_SYM, FT8_TOTAL_SYMS, FT8_TONES)
    return np.asarray(tones)[..., ft8_data_positions()]


def ft4_demod(iq, fs: float = 12000.0, base_hz: float = 1000.0):
    """60 480-sample frame → 87 data tone indices, or None."""
    if np.shape(iq)[-1] < FT4_FRAME_LEN:
        return None
    tones = _detect_tones(iq, fs, base_hz, FT4_TONE_SPACING_HZ,
                          FT4_SAMPLES_PER_SYM, FT4_TOTAL_SYMS, FT4_TONES)
    return np.asarray(tones)[..., ft4_data_positions()]
