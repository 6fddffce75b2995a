"""Gray-coded constellations: BPSK/QPSK/QAM-16/64/256 map, decide, soft LLRs.

Behavioral spec from /root/reference/src/modulate/{bpsk,qpsk,qam}.rs and
demodulate/{bpsk,qpsk,qam}.rs: per-axis independent Gray coding, unit average
symbol energy (axis scale = 1/sqrt(2(M²−1)/3)), bit layout per symbol =
BITS/2 I-axis bits MSB-first then BITS/2 Q-axis bits MSB-first.

Design: mapping is a table gather over packed bit indices; deciding is a
broadcast threshold count + gray encode + bit unpack — all whole-capture
vectorized ops (no per-symbol loops). Soft LLRs are exact max-log over the
per-axis 1-D constellation (each bit's LLR = min distance² difference),
positive ⇒ bit 0, matching the reference's convention
(demodulate/ofdm.rs:137-610).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

ORDERS = ("bpsk", "qpsk", "qam16", "qam64", "qam256")

BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}


def axis_scale(bits: int) -> float:
    """1/sqrt(average symbol energy) for square QAM (ref: modulate/qam.rs:27-34)."""
    m = 1 << (bits // 2)
    return float(1.0 / np.sqrt(2.0 * (m * m - 1) / 3.0))


def _axis_table(bits: int) -> np.ndarray:
    """Amplitude per Gray-coded axis index (ref: modulate/qam.rs:37-75)."""
    k = bits // 2
    m = 1 << k
    scale = axis_scale(bits)
    table = np.zeros(m, dtype=np.float32)
    for g in range(m):
        gray = g ^ (g >> 1)
        table[gray] = (2 * g + 1 - m) * scale
    return table


def _axis_thresholds(bits: int) -> np.ndarray:
    """M−1 ascending decision midpoints (ref: demodulate/qam.rs:20-42)."""
    k = bits // 2
    m = 1 << k
    scale = axis_scale(bits)
    return ((2 * np.arange(m - 1) - (m - 2)) * scale).astype(np.float32)


# Amplitude of natural level index g (for gray decode: amp_sorted[g])
def _axis_levels(bits: int) -> np.ndarray:
    k = bits // 2
    m = 1 << k
    return ((2 * np.arange(m) + 1 - m) * axis_scale(bits)).astype(np.float32)


def _pack_bits_msb(bits, k):
    """(..., k) uint8 LSBs → (...,) int32 index, MSB-first."""
    weights = jnp.asarray(2 ** np.arange(k - 1, -1, -1), dtype=jnp.int32)
    return jnp.sum((bits & 1).astype(jnp.int32) * weights, axis=-1)


def _unpack_bits_msb(idx, k):
    """(...,) int32 → (..., k) uint8, MSB-first."""
    shifts = jnp.asarray(np.arange(k - 1, -1, -1), dtype=jnp.int32)
    return ((idx[..., None] >> shifts) & 1).astype(jnp.uint8)


def map_bits(bits, order: str):
    """Bits (..., n_bits) uint8 → unit-energy symbols (..., n_syms) complex64.

    n_bits must be a multiple of bits_per_symbol(order); layout matches the
    reference mappers (I-axis bits then Q-axis bits, MSB-first per axis).
    """
    bits = jnp.asarray(bits)
    if order == "bpsk":
        return jnp.where((bits & 1) == 0, 1.0, -1.0).astype(jnp.complex64)
    bps = BITS_PER_SYMBOL[order]
    k = bps // 2
    b = bits.reshape(bits.shape[:-1] + (-1, bps))
    if order == "qpsk":
        s = 1.0 / np.sqrt(2.0)
        re = jnp.where((b[..., 0] & 1) == 0, s, -s)
        im = jnp.where((b[..., 1] & 1) == 0, s, -s)
        return (re + 1j * im).astype(jnp.complex64)
    # amplitude = (2·gray_decode(idx) + 1 − m)·scale, computed arithmetically
    # (prefix-XOR Gray decode): elementwise arithmetic instead of a
    # per-element table gather.
    m = 1 << k
    scale = axis_scale(bps)
    i_idx = _pack_bits_msb(b[..., :k], k)
    q_idx = _pack_bits_msb(b[..., k:], k)

    def amp(idx):
        g = idx ^ (idx >> 1)
        g = g ^ (g >> 2)
        g = g ^ (g >> 4)
        return (2 * g + 1 - m).astype(jnp.float32) * scale

    return (amp(i_idx) + 1j * amp(q_idx)).astype(jnp.complex64)


def decide(symbols, order: str):
    """Hard decision: symbols (..., n_syms) → bits (..., n_syms*bps) uint8.

    Matches the reference deciders' Gray coding exactly.
    """
    z = jnp.asarray(symbols)
    if order == "bpsk":
        return (z.real < 0.0).astype(jnp.uint8)
    if order == "qpsk":
        b0 = (z.real < 0.0).astype(jnp.uint8)
        b1 = (z.imag < 0.0).astype(jnp.uint8)
        return jnp.stack([b0, b1], axis=-1).reshape(z.shape[:-1] + (-1,))
    bps = BITS_PER_SYMBOL[order]
    k = bps // 2
    thr = jnp.asarray(_axis_thresholds(bps))

    def axis_bits(v):
        nat = jnp.sum(v[..., None] > thr, axis=-1).astype(jnp.int32)
        gray = nat ^ (nat >> 1)
        return _unpack_bits_msb(gray, k)

    ib = axis_bits(z.real)
    qb = axis_bits(z.imag)
    return jnp.concatenate([ib, qb], axis=-1).reshape(z.shape[:-1] + (-1,))


def soft_llr(symbols, order: str, gain: float = 1.0):
    """Max-log LLRs, positive ⇒ bit 0 (ref convention, demodulate/ofdm.rs:137+).

    Per-axis exact max-log: for each bit position, LLR = (min dist² over
    bit=1 levels) − (min dist² over bit=0 levels), scaled by ``gain``.
    BPSK fast path = 4·re (ref bpsk_soft_llr).
    Returns (..., n_syms*bps) float32.
    """
    z = jnp.asarray(symbols)
    if order == "bpsk":
        return (4.0 * gain * z.real).astype(jnp.float32)
    if order == "qpsk":
        s = 4.0 * np.sqrt(2.0)  # reference scale (demodulate/ofdm.rs:476-479)
        llr = jnp.stack([s * gain * z.real, s * gain * z.imag], axis=-1)
        return llr.reshape(z.shape[:-1] + (-1,)).astype(jnp.float32)
    bps = BITS_PER_SYMBOL[order]
    k = bps // 2
    levels = _axis_levels(bps)          # amplitude of natural index g
    m = len(levels)
    # bit value of each natural level at each of the k bit positions (Gray)
    gray = np.arange(m) ^ (np.arange(m) >> 1)
    bit_of_level = ((gray[:, None] >> np.arange(k - 1, -1, -1)[None, :]) & 1)  # (m, k)
    lv = jnp.asarray(levels)
    b_mask = jnp.asarray(bit_of_level.astype(np.bool_))

    def axis_llr(v):
        d2 = (v[..., None] - lv) ** 2                       # (..., m)
        big = jnp.asarray(np.float32(1e30))
        # (..., k): for each bit position, min over levels with bit==0 / ==1
        d2e = d2[..., None, :]                              # (..., 1, m)
        mask0 = ~b_mask.T                                   # (k, m)
        mask1 = b_mask.T
        min0 = jnp.min(jnp.where(mask0, d2e, big), axis=-1)  # (..., k)
        min1 = jnp.min(jnp.where(mask1, d2e, big), axis=-1)
        return min1 - min0

    illr = axis_llr(z.real)
    qllr = axis_llr(z.imag)
    llr = jnp.concatenate([illr, qllr], axis=-1).reshape(z.shape[:-1] + (-1,))
    return (gain * llr).astype(jnp.float32)


def constellation_points(order: str) -> np.ndarray:
    """All 2^bps ideal points indexed by the symbol's packed bit index."""
    bps = BITS_PER_SYMBOL[order]
    n = 1 << bps
    bits = ((np.arange(n)[:, None] >> np.arange(bps - 1, -1, -1)[None, :]) & 1).astype(np.uint8)
    return np.asarray(map_bits(bits.reshape(-1), order))
