"""PSK31 modulators: BPSK31 / QPSK31 (behavioral spec: modulate/psk31.rs).

31.25 baud, raised-cosine (α=1) pulse shaping via a Hann-windowed crossfade
between the previous and current phasor, differential phase encoding
(bit 0 = phase change, bit 1 = no change); QPSK31 adds the rate-1/2 K=5
convolutional code.

Design: the reference's per-sample write_symbol loop becomes one outer
product — phasor sequences are cumulative products over symbols (exact for
the ±1/±j alphabet), and the crossfade is
    samples[k, n] = p[k-1]·(1−h[n]) + p[k]·h[n]
i.e. two rank-1 broadcasts over (n_syms, sps), fused by XLA.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..codec.varicode import encode_text
from ..codec.psk31 import conv_encode, DQPSK_EXP
from ..dsp.osc import rotate
from ..dsp.device import cjit

PSK31_BAUD = 31.25
PSK31_SPS_8000 = 256
PSK31_SPS_12000 = 384
PSK31_PREAMBLE_BITS = 32
PSK31_POSTAMBLE_BITS = 32


def psk31_sps(fs: float) -> int:
    """Samples per PSK31 symbol at sample rate fs."""
    return int(round(fs / PSK31_BAUD))


def psk31_hann(sps: int) -> np.ndarray:
    """Half-cosine crossfade window h[n] = 0.5 − 0.5·cos(π·n/(sps−1))."""
    if sps == 0:
        return np.zeros(0, np.float32)
    if sps == 1:
        return np.ones(1, np.float32)
    n = np.arange(sps, dtype=np.float32)
    return (0.5 - 0.5 * np.cos(np.pi * n / (sps - 1))).astype(np.float32)


@cjit
def _crossfade(phasors, phase0, sps: int, gain: float, rf_hz: float = 0.0,
               fs: float = 0.0):
    """Pulse-shape a phasor sequence: out[k·sps+n] = g·(p[k−1] + h[n]·(p[k]−p[k−1]))."""
    h = jnp.asarray(psk31_hann(sps))
    p = jnp.asarray(phasors, dtype=jnp.complex64)
    prev = jnp.concatenate([jnp.full((1,), phase0, jnp.complex64), p[:-1]])
    seg = prev[:, None] * (1.0 - h)[None, :] + p[:, None] * h[None, :]
    out = (gain * seg.reshape(-1)).astype(jnp.complex64)
    if rf_hz != 0.0:
        out, _ = rotate(out, rf_hz, fs)
    return out


def bpsk31_mod_bits(bits, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    phase0: complex = 1.0 + 0.0j):
    """Differential bits (0 = flip, 1 = hold) → IQ; len = n_bits·sps.

    Returns (iq, final_phase) so streams can continue (ref Bpsk31Mod state).
    """
    b = np.asarray(bits, dtype=np.uint8) & 1
    sps = psk31_sps(fs)
    # phase[k] = phase0 · (−1)^(number of 0-bits so far, inclusive)
    flips = np.cumsum(1 - b).astype(np.int64)
    phasors = (np.real(phase0) * np.where(flips % 2 == 1, -1.0, 1.0)).astype(np.complex64)
    iq = _crossfade(phasors, complex(phase0), sps, gain, rf_hz, fs)
    final = complex(phasors[-1]) if len(b) else phase0
    return iq, final


def qpsk31_mod_bits(bits, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    phase0: complex = 1.0 + 0.0j, enc_sr: int = 0):
    """Info bits → conv encode → DQPSK crossfade IQ; len = n_bits·sps.

    Returns (iq, final_phase). ``enc_sr`` continues the encoder state.
    """
    coded = conv_encode(bits, enc_sr)
    dibits = (coded[0::2] * 2 + coded[1::2]).astype(np.int64)
    steps = DQPSK_EXP[dibits]
    # Cumulative product of unit phasors {±1, ±j} is exact in binary fp.
    phasors = (phase0 * np.cumprod(steps)).astype(np.complex64) if len(dibits) \
        else np.zeros(0, np.complex64)
    sps = psk31_sps(fs)
    iq = _crossfade(phasors, complex(phase0), sps, gain, rf_hz, fs)
    final = complex(phasors[-1]) if len(dibits) else phase0
    return iq, final


def bpsk31_mod_text(text, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    preamble_bits: int = PSK31_PREAMBLE_BITS,
                    postamble_bits: int = PSK31_POSTAMBLE_BITS):
    """Text → varicode → BPSK31 IQ (ref Bpsk31Mod::modulate_text)."""
    bits = encode_text(text, preamble_bits, postamble_bits)
    iq, _ = bpsk31_mod_bits(bits, fs, rf_hz, gain)
    return iq


def qpsk31_mod_text(text, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    preamble_bits: int = PSK31_PREAMBLE_BITS,
                    postamble_bits: int = PSK31_POSTAMBLE_BITS):
    """Text → varicode → conv → QPSK31 IQ (ref Qpsk31Mod::modulate_text)."""
    bits = encode_text(text, preamble_bits, postamble_bits)
    iq, _ = qpsk31_mod_bits(bits, fs, rf_hz, gain)
    return iq
