"""Analog modulators: CW / AM / SSB / FM / PM.

Batched JAX versions of the reference's src/modulate/{cw,am,ssb,fm,pm}.rs.
Each modulator is a pure whole-capture function; phase accumulators become
cumulative sums, the per-sample phasor recurrences become exact phase ramps,
and the SSB phasing filters run as parallel-scan biquad cascades. Streaming
state is explicit and optional.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dsp.device import cjit as _cjit
import numpy as np

from ..dsp.osc import rotate, oscillator, TAU
from ..dsp.iir import design_butter_lp, lp_cascade, biquad_init


class CwState(NamedTuple):
    env: jnp.ndarray
    phase: jnp.ndarray


@_cjit
def cw_mod(key_env, fs, tone_hz, rise_ms=3.0, fall_ms=3.0, gain=1.0, state: CwState | None = None):
    """Keyed carrier with rise/fall envelope shaping (ref: modulate/cw.rs:10-44).

    ``key_env``: keying envelope in [0, 1]. The envelope one-pole switches its
    time constant on rising vs falling input — a data-dependent recurrence,
    kept as a scan (throughput comes from batching channels).
    """
    x = jnp.clip(jnp.asarray(key_env, dtype=jnp.float32), 0.0, 1.0)
    a_r = float(np.exp(-1.0 / (max(rise_ms, 0.1) * 1e-3 * fs)))
    a_f = float(np.exp(-1.0 / (max(fall_ms, 0.1) * 1e-3 * fs)))
    if state is None:
        state = CwState(env=jnp.zeros(x.shape[:-1], jnp.float32),
                        phase=jnp.zeros(x.shape[:-1], jnp.float32))

    def step(env, tgt):
        a = jnp.where(tgt >= env, a_r, a_f)
        env = a * env + (1.0 - a) * tgt
        return env, env

    xt = jnp.moveaxis(x, -1, 0)
    env_last, envt = jax.lax.scan(step, state.env, xt)
    env = jnp.moveaxis(envt, 0, -1)
    iq, phase_out = rotate((env * gain).astype(jnp.complex64), tone_hz, fs, state.phase)
    return iq, CwState(env=env_last, phase=phase_out)


@_cjit
def am_mod(audio, fs, rf_hz=0.0, carrier_level=1.0, modulation_index=1.0,
           gain=1.0, clamp=False, phase0=0.0):
    """AM DSB: m = (carrier_level + mi·x) [clamped], mixed to rf_hz
    (ref: modulate/am.rs:11-140). Returns (iq, rf_phase_out)."""
    x = jnp.asarray(audio, dtype=jnp.float32)
    m = carrier_level + modulation_index * x
    if clamp:
        m = jnp.clip(m, -1.0, 1.0)
    m = (m * gain).astype(jnp.complex64)
    return rotate(m, rf_hz, fs, phase0)


class SsbState(NamedTuple):
    lp_i: tuple  # (BiquadState, BiquadState)
    lp_q: tuple
    aud_phase: jnp.ndarray
    rf_phase: jnp.ndarray


@_cjit
def ssb_mod(audio, fs, audio_bw_hz, audio_if_hz, rf_hz=0.0, usb=True,
            state: SsbState | None = None):
    """Phasing-method SSB (ref: modulate/ssb.rs:10-140).

    Audio is mixed with an IF quadrature pair, each arm lowpassed at 0.9·BW
    by an LR4 cascade, recombined as I + j·(±Q), then translated to RF.
    """
    x = jnp.asarray(audio, dtype=jnp.float32)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    if state is None:
        mk = lambda: (biquad_init(x.shape[:-1]), biquad_init(x.shape[:-1]))
        state = SsbState(lp_i=mk(), lp_q=mk(),
                         aud_phase=jnp.zeros(x.shape[:-1], jnp.float32),
                         rf_phase=jnp.zeros(x.shape[:-1], jnp.float32))
    p, aud_phase = oscillator(audio_if_hz, fs, x.shape[-1], state.aud_phase)
    side = 1.0 if usb else -1.0
    yi, lp_i = lp_cascade(x * p.real, c, state.lp_i)
    yq, lp_q = lp_cascade(x * p.imag, c, state.lp_q)
    z = (yi + 1j * side * yq).astype(jnp.complex64)
    iq, rf_phase = rotate(z, rf_hz, fs, state.rf_phase)
    return iq, SsbState(lp_i=lp_i, lp_q=lp_q, aud_phase=aud_phase, rf_phase=rf_phase)


class FmState(NamedTuple):
    phase: jnp.ndarray
    rf_phase: jnp.ndarray


@_cjit
def fm_mod(audio, fs, deviation_hz, rf_hz=0.0, gain=1.0, state: FmState | None = None):
    """FM phase accumulator: φ[n] = φ[n-1] + 2π·kf·x[n]/fs (ref: modulate/fm.rs:12-90).

    The reference's per-sample phasor recurrence is a cumulative sum here —
    exact, drift-free, and fully parallel.
    """
    x = jnp.asarray(audio, dtype=jnp.float32)
    if state is None:
        state = FmState(phase=jnp.zeros(x.shape[:-1], jnp.float32),
                        rf_phase=jnp.zeros(x.shape[:-1], jnp.float32))
    kf = TAU * deviation_hz / fs
    phase = state.phase[..., None] + jnp.cumsum(kf * x, axis=-1)
    base = (gain * jnp.exp(1j * phase)).astype(jnp.complex64)
    iq, rf_phase = rotate(base, rf_hz, fs, state.rf_phase)
    phase_out = jnp.remainder(phase[..., -1], TAU)
    return iq, FmState(phase=phase_out, rf_phase=rf_phase)


@_cjit
def pm_mod(audio, fs, kp_rad_per_unit, rf_hz=0.0, gain=1.0, rf_phase0=0.0):
    """PM: instantaneous phase φ = kp·x (ref: modulate/pm.rs:10-60)."""
    x = jnp.asarray(audio, dtype=jnp.float32)
    base = (gain * jnp.exp(1j * kp_rad_per_unit * x)).astype(jnp.complex64)
    return rotate(base, rf_hz, fs, rf_phase0)
