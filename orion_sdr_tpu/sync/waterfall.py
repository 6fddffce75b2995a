"""Symbol-rate magnitude spectrogram ("waterfall") for FT8/FT4/PSK31 sync
(behavioral spec: sync/waterfall.rs).

Design: the reference runs a Goertzel correlator per (symbol, tone) —
O(syms·tones·sps) scalar work. Here the whole grid is ONE matmul: the capture
is reshaped to (num_syms, sps) and multiplied against the (sps, num_tones)
tone-phasor matrix W[i, k] = exp(−j2π·f_k·i/fs), putting the entire search on
one matmul. Log-power output matches the reference: ln(|acc|² + 1e−12), with
out-of-buffer symbols left at 0.0 (safe for max-log scoring).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.device import cjit


@lru_cache(maxsize=64)
def _tone_matrix(fs: float, base_hz: float, tone_spacing_hz: float,
                 sps: int, num_tones: int) -> np.ndarray:
    i = np.arange(sps, dtype=np.float64)[:, None]
    f = base_hz + np.arange(num_tones, dtype=np.float64)[None, :] * tone_spacing_hz
    return np.exp(-2j * np.pi * f * i / fs).astype(np.complex64)


@cjit
def compute_waterfall(iq, fs: float, base_hz: float, tone_spacing_hz: float,
                      samples_per_sym: int, num_syms: int, num_tones: int,
                      time_offset: int = 0):
    """(num_syms, num_tones) log-power grid; symbol s correlates IQ samples
    [time_offset + s·sps, +sps) against each tone phasor."""
    z = jnp.asarray(iq)
    n = z.shape[-1]
    need = time_offset + num_syms * samples_per_sym
    # Zero-pad the tail: a partial final symbol correlates over what exists,
    # fully-missing symbols get |0|² → ln(1e−12); the reference leaves those
    # rows at 0.0, so mark fully-missing rows 0.0 afterwards.
    if need > n:
        z = jnp.pad(z, [(0, 0)] * (z.ndim - 1) + [(0, need - n)])
    z = jax.lax.slice_in_dim(z, time_offset, need, axis=-1)
    seg = z.reshape(z.shape[:-1] + (num_syms, samples_per_sym))
    w = jnp.asarray(_tone_matrix(float(fs), float(base_hz),
                                 float(tone_spacing_hz), samples_per_sym,
                                 num_tones))
    acc = seg @ w                                   # (…, num_syms, num_tones)
    mag = jnp.log(jnp.abs(acc) ** 2 + 1e-12)
    starts = time_offset + np.arange(num_syms) * samples_per_sym
    missing = jnp.asarray(starts >= n)
    return jnp.where(missing[..., :, None], 0.0, mag).astype(jnp.float32)
