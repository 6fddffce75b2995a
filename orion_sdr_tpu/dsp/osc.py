"""Oscillators and frequency translation — vectorized phase ramps.

The reference uses a phasor-recurrence NCO/Rotator (one complex multiply per
sample, renormalized every 1024 steps — /root/reference/src/dsp/nco.rs,
dsp/rotator.rs). Here we compute the phase ramp *exactly*:
``exp(j (phase0 + w * (arange(n)+1)))`` — no drift, no renorm, one fused
elementwise kernel. Streaming continuity is carried as the scalar phase.

Phase convention matches the reference: the oscillator *advances first*, so
the phasor applied to sample 0 has phase ``phase0 + w`` (Rotator::next
multiplies z by w before returning it).
"""

from __future__ import annotations

import jax.numpy as jnp

TAU = 6.283185307179586


def _ramp(freq_hz, fs, n, phase0):
    w = TAU * freq_hz / fs
    k = jnp.arange(1, n + 1, dtype=jnp.float32)
    p0 = jnp.asarray(phase0, dtype=jnp.float32)
    ph = p0[..., None] + w * k  # broadcasts batched phase carries
    return ph, jnp.remainder(p0 + w * n, TAU)


def oscillator(freq_hz, fs, n, phase0=0.0):
    """Complex phasor stream e^{j phase[k]}; returns (phasor[n], phase_out)."""
    ph, phase_out = _ramp(freq_hz, fs, n, phase0)
    return jnp.exp(1j * ph).astype(jnp.complex64), phase_out


def rotate(x, freq_hz, fs, phase0=0.0):
    """Frequency-translate IQ by ``freq_hz``: y = x * e^{j phase}.

    Equivalent of Rotator::rotate_block (dsp/rotator.rs:74). Returns
    ``(y, phase_out)`` so blocks can be chained seamlessly.
    """
    x = jnp.asarray(x)
    ph, phase_out = _ramp(freq_hz, fs, x.shape[-1], phase0)
    return (x * jnp.exp(1j * ph)).astype(jnp.complex64), phase_out


def mix_usb(x, freq_hz, fs, phase0=0.0):
    """USB product detector primitive: y = I*cos + Q*sin.

    Equivalent of Rotator::mix_usb_block (dsp/rotator.rs:88).
    """
    x = jnp.asarray(x)
    ph, phase_out = _ramp(freq_hz, fs, x.shape[-1], phase0)
    y = x.real * jnp.cos(ph) + x.imag * jnp.sin(ph)
    return y.astype(jnp.float32), phase_out


# Host-boundary variants (cjit). freq/phase cross as dynamic arrays so
# per-call CFO values don't retrace.
from .device import cjit as _cjit

rotate_host = _cjit(rotate)
mix_usb_host = _cjit(mix_usb)
