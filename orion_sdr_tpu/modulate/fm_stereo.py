"""FM broadcast stereo multiplex TX (pilot-tone system, ITU-R BS.450) with
an optional RDS subcarrier — beyond the reference (its FM pair is mono:
modulate/fm.rs, demodulate/fm.rs).

Composite (MPX) layout, θ = 2π·19 kHz·t:
  mpx = a·[(L+R)/2 + (L−R)/2 · cos 2θ] + p·cos θ + r·rds(t)·cos 3θ
with audio level a = 0.9, pilot p = 0.09, RDS r = 0.05 by default. The
38/57 kHz subcarriers are generated as the square/cube of the SAME 19 kHz
phasor, so TX and RX phase references cancel exactly (the RX derives its
subcarrier references from the received pilot the same way).

Design: the whole composite is one batched elementwise program; the
RDS Manchester waveform indexes its differential bit stream with a
time-derived gather (no per-bit loop)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit as _cjit
from ..dsp.fir import (kaiser_lowpass_taps, kaiser_num_taps,
                       fir_filter_aligned)
from ..dsp.osc import TAU
from .analog import fm_mod, FmState

FM_STEREO_PILOT_HZ = 19_000.0
RDS_CARRIER_HZ = 57_000.0
FM_STEREO_MIN_FS = 2 * 60_000.0    # composite extends to 57k + ~2.4k


def rds_manchester(bits, fs, n: int, level: float = 1.0):
    """Differentially-encoded biphase (Manchester) RDS baseband at 1187.5
    baud, shaped by a ~2.4 kHz lowpass → (n,) float32. ``bits`` repeat
    cyclically so a short message fills any capture length."""
    from ..codec.rds import RDS_SYMBOL_RATE
    b = np.asarray(bits, np.uint8) & 1
    if len(b) == 0:
        return jnp.zeros(n, jnp.float32)
    d = np.bitwise_xor.accumulate(b)          # d[i] = b[i] ^ d[i-1], d[-1]=0
    parity = int(d[-1])                       # keeps the differential chain
    return _rds_manchester_device(jnp.asarray(d), float(fs), n,   # unbroken
                                  float(level), float(RDS_SYMBOL_RATE),
                                  parity)                         # at wraps


@_cjit
def _rds_manchester_device(d, fs: float, n: int, level: float, rate: float,
                           parity: int):
    t = jnp.arange(n, dtype=jnp.float32) / fs
    k = jnp.floor(t * rate).astype(jnp.int32)
    sym = d[jnp.remainder(k, d.shape[0])]
    # continue the differential state across message repeats: repeat r of
    # the message starts from the accumulated parity r·P, not from 0
    sym = sym ^ ((k // d.shape[0]) * parity % 2).astype(sym.dtype)
    sym = sym.astype(jnp.float32)
    half = (t * rate - k.astype(jnp.float32)) >= 0.5
    raw = (1.0 - 2.0 * sym) * jnp.where(half, -1.0, 1.0)
    taps = kaiser_lowpass_taps(kaiser_num_taps(2400.0 / fs, 50.0),
                               2100.0 / fs, 50.0)
    return (level * fir_filter_aligned(raw, taps)).astype(jnp.float32)


@_cjit
def stereo_mpx(left, right, fs, pilot_level: float = 0.09,
               audio_level: float = 0.9, rds=None,
               pilot_phase0: float = 0.0):
    """(…, n) left/right audio → (…, n) stereo composite. ``rds`` is an
    optional pre-shaped baseband, already at its injection level (see
    rds_manchester's ``level``)."""
    L = jnp.asarray(left, jnp.float32)
    R = jnp.asarray(right, jnp.float32)
    n = L.shape[-1]
    w = TAU * FM_STEREO_PILOT_HZ / fs
    th = jnp.float32(pilot_phase0) + w * jnp.arange(1, n + 1,
                                                    dtype=jnp.float32)
    c1 = jnp.exp(1j * th)                    # pilot phasor
    c2 = c1 * c1                             # 38 kHz, phase-coherent
    mono = 0.5 * (L + R)
    sub = 0.5 * (L - R)
    mpx = audio_level * (mono + sub * c2.real) + pilot_level * c1.real
    if rds is not None:
        c3 = c2 * c1                         # 57 kHz
        mpx = mpx + jnp.asarray(rds, jnp.float32) * c3.real
    return mpx.astype(jnp.float32)


def fm_stereo_mod(left, right, fs, deviation_hz: float = 75e3,
                  rds_bits=None, rds_level: float = 0.05, rf_hz: float = 0.0,
                  state: FmState | None = None):
    """Full broadcast-FM stereo transmitter: composite → FM phase
    accumulator → IQ. ``fs`` is both the audio/MPX and IQ rate (≥120 kHz);
    ``rds_bits`` (e.g. from codec.rds.rds_encode_groups) ride at 57 kHz.
    Returns (iq, FmState)."""
    if fs < FM_STEREO_MIN_FS:
        raise ValueError(f"fm_stereo_mod needs fs ≥ {FM_STEREO_MIN_FS:.0f}"
                         f" for the 57 kHz composite, got {fs}")
    n = np.asarray(left).shape[-1]
    rds = None
    if rds_bits is not None and len(np.asarray(rds_bits)):
        rds = rds_manchester(rds_bits, fs, n, rds_level)
    mpx = stereo_mpx(left, right, fs, rds=rds)
    return fm_mod(mpx, fs, deviation_hz, rf_hz=rf_hz, state=state)
