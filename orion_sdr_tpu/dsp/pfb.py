"""Polyphase filter-bank (PFB) channelizer — the industrial uniform-grid
channelizer (beyond the reference). Where :class:`Channelizer` mixes and
filters each channel independently (right for a handful of arbitrary
centers), the PFB extracts ALL C uniformly spaced channels with ONE
prototype filter + ONE batched FFT per output step: cost is independent
of the channel count.

Design: the polyphase accumulation is a single einsum over the tap
phases (a matmul), the channel transform one batched FFT — the whole
bank is two fused device ops regardless of C.

Critically sampled analysis bank: channel c is centered at c·fs/C
(c interpreted signed around DC), output rate fs/C.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .device import cjit
from .fir import kaiser_lowpass_taps


def pfb_prototype(n_channels: int, taps_per_phase: int = 12,
                  stopband_db: float = 70.0,
                  cutoff_scale: float = 0.5) -> np.ndarray:
    """Prototype lowpass for a C-channel bank: cutoff at
    ``cutoff_scale``·(fs/2C), length C·taps_per_phase."""
    c = int(n_channels)
    taps = kaiser_lowpass_taps(c * taps_per_phase - 1,
                               cutoff_scale * 0.5 / c, stopband_db)
    out = np.zeros(c * taps_per_phase, np.float32)
    out[:len(taps)] = taps
    return out                           # unity gain after the C-point FFT


@cjit
def _pfb_run(x, proto, n_channels: int):
    c = n_channels
    h = jnp.asarray(proto).reshape(-1, c)          # (P, C) phase taps
    p = h.shape[0]
    n_out = x.shape[-1] // c - (p - 1)
    # polyphase accumulation as P shifted row-slices of the (rows, C)
    # reshaped capture — O(1) extra memory (a gathered (n_out, P·C) frame
    # tensor would hold P copies of the capture)
    xb = x[: (n_out + p - 1) * c].reshape(n_out + p - 1, c)
    acc = jnp.zeros((n_out, c), x.dtype)
    for j in range(p):
        acc = acc + xb[j: j + n_out] * h[j].astype(x.dtype)[None, :]
    # forward FFT across the phase axis puts the tone at +c·fs/C into
    # row c (fftfreq order); the C-point coherent sum restores unity gain
    y = jnp.fft.fft(acc, axis=-1)
    return jnp.moveaxis(y, -1, 0).astype(jnp.complex64)   # (C, n_out)


def pfb_channelize(iq, n_channels: int, taps_per_phase: int = 12,
                   stopband_db: float = 70.0) -> np.ndarray:
    """(n,) complex capture → (C, n//C − P + 1) critically sampled
    channels; channel c sits at ((c + C/2) % C − C/2)·fs/C (signed around
    DC, fftfreq order)."""
    z = np.asarray(iq)
    if z.ndim != 1:
        raise ValueError("pfb_channelize takes a 1-D capture")
    c = int(n_channels)
    if c < 2:
        raise ValueError("need at least 2 channels")
    if len(z) < c * (taps_per_phase + 1):
        raise ValueError("capture shorter than one filter span")
    proto = pfb_prototype(c, taps_per_phase, stopband_db)
    return np.asarray(_pfb_run(z.astype(np.complex64), proto, c))


def pfb_channel_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output row (fftfreq convention)."""
    return np.fft.fftfreq(int(n_channels), 1.0 / fs)
