"""Chirp spread spectrum (LoRa-style) transmitter — beyond the reference
(no spread-spectrum modes in /root/reference). Wire compatibility with
LoRa is NOT claimed; this is the open CSS PHY: SF bits per symbol as a
cyclic shift of a linear chirp, preamble of base upchirps + two downchirp
sync symbols, 16-bit CRC on the payload.

Design: every chirp is one slice of a precomputed quadratic phase
ramp (cyclic shift = index arithmetic); the whole frame synthesizes as a
single cumulative-phase program.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit
from ..dsp.osc import TAU

CSS_PREAMBLE_UPCHIRPS = 8


def css_samples_per_symbol(sf: int, bw: float, fs: float) -> int:
    r = fs / bw
    if abs(r - round(r)) > 1e-9 or round(r) < 1:
        raise ValueError(f"fs must be an integer multiple of bw "
                         f"(fs/bw = {r}) — the dechirp decimates "
                         f"fs/bw samples per chip")
    return (1 << sf) * int(round(r))


def _chirp_phase(sf: int, bw: float, fs: float, shift: int,
                 down: bool = False) -> np.ndarray:
    """Instantaneous frequency track of one symbol chirp (Hz)."""
    n = css_samples_per_symbol(sf, bw, fs)
    m = 1 << sf
    k = (np.arange(n) * m / n + shift) % m      # chip index, cyclic
    f = -bw / 2.0 + k * (bw / m)
    return (-f if down else f).astype(np.float32)


def css_mod(payload: bytes, sf: int = 7, bw: float = 125_000.0,
            fs: float | None = None, amplitude: float = 1.0) -> np.ndarray:
    """Payload bytes → complex CSS frame: 8 upchirps, 2 downchirps, then
    payload+CRC16 packed MSB-first into SF-bit symbols."""
    if not (5 <= sf <= 12):
        raise ValueError("sf must be 5..12")
    fs = float(fs if fs is not None else bw)
    data = np.frombuffer(bytes(payload), np.uint8)
    from ..fec.crc import crc16
    crc = crc16(data)
    bits = np.unpackbits(np.concatenate(
        [data, np.uint8([crc >> 8, crc & 0xFF])]))
    pad = (-len(bits)) % sf
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    syms = bits.reshape(-1, sf) @ (1 << np.arange(sf - 1, -1, -1))

    tracks = [_chirp_phase(sf, bw, fs, 0)] * CSS_PREAMBLE_UPCHIRPS
    tracks += [_chirp_phase(sf, bw, fs, 0, down=True)] * 2
    tracks += [_chirp_phase(sf, bw, fs, int(s)) for s in syms]
    freq = np.concatenate(tracks)
    return np.asarray(_freq_to_iq(freq, fs, float(amplitude)))


@cjit
def _freq_to_iq(freq, fs: float, amplitude: float):
    phase = jnp.cumsum(jnp.float32(TAU / fs) * jnp.asarray(freq, jnp.float32))
    return (amplitude * jnp.exp(1j * phase)).astype(jnp.complex64)
