"""Schmidl & Cox packet sync + integer-CFO training correlation.

Behavioral spec: /root/reference/src/sync/ofdm_sync.rs. Wire compatibility:
the repeated-segment base sequence and the training symbol's frequency
pattern reproduce the reference's fixed-seed xorshift64 generators exactly
(seeds 0x4F46444D50524531 / 0x4F46444D54524E31, ofdm_sync.rs:121-180), so a
frame transmitted by either implementation acquires on the other.

Design: the reference recomputes P(d)/R(d) per offset — O(len·repeat_len).
Because the per-segment sums are contiguous, P and R are sliding-window sums
of c[t] = conj(r[t])·r[t+L] and |r[t+L]|² over (R−1)·L samples — computed
with two cumulative sums, O(len), fully vectorized. The integer-CFO circular
shift search is one dense matmul against rolled known patterns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..dsp.osc import rotate, rotate_host
from ..dsp.device import cjit
from ..multicarrier import symbol_fft

_SEED_REPEAT = 0x4F46_444D_5052_4531
_SEED_TRAINING = 0x4F46_444D_5452_4E31


@dataclass(frozen=True)
class TrainingSymbol:
    n_fft: int
    cp_len: int

    def total_len(self) -> int:
        return self.n_fft + self.cp_len


@dataclass(frozen=True)
class OfdmPreamble:
    """num_repeats × repeat_len S&C repeats + optional training symbol
    (ref: ofdm_sync.rs:46-92)."""
    num_repeats: int
    repeat_len: int
    training_symbol: Optional[TrainingSymbol] = None

    def with_training_symbol(self, n_fft: int, cp_len: int) -> "OfdmPreamble":
        return OfdmPreamble(self.num_repeats, self.repeat_len,
                            TrainingSymbol(n_fft, cp_len))

    def total_len(self) -> int:
        t = self.training_symbol.total_len() if self.training_symbol else 0
        return self.num_repeats * self.repeat_len + t


class OfdmSyncResult(NamedTuple):
    start_sample: int
    cfo_hz: float
    integer_cfo_bins: int
    score: float


def _xorshift64_signs(length: int, seed: int) -> np.ndarray:
    """±1 stream matching the reference's xorshift64 sign draws
    (ofdm_sync.rs:163-180): sign of (state as f32)/u64::MAX − 0.5."""
    mask = (1 << 64) - 1
    state = seed
    out = np.empty(length, dtype=np.float32)
    for i in range(length):
        state = (state ^ (state << 13)) & mask
        state = (state ^ (state >> 7)) & mask
        state = (state ^ (state << 17)) & mask
        out[i] = 1.0 if (np.float32(state) / np.float32(2**64) - 0.5) >= 0.0 else -1.0
    return out


def pseudo_random_unit_sequence(length: int, seed: int) -> np.ndarray:
    """Unit-average-energy QPSK-like sequence, bit-matching the reference."""
    signs = _xorshift64_signs(2 * length, seed)
    s = np.float32(1.0 / np.sqrt(2.0))
    return (signs[0::2] * s + 1j * signs[1::2] * s).astype(np.complex64)


def training_symbol_freq_pattern(n_fft: int) -> np.ndarray:
    return pseudo_random_unit_sequence(n_fft, _SEED_TRAINING)


def generate_ofdm_preamble(preamble: OfdmPreamble) -> np.ndarray:
    """Time-domain preamble: tiled base sequence + (IFFT'd + CP) training
    symbol (ref: ofdm_sync.rs:121-160)."""
    base = pseudo_random_unit_sequence(preamble.repeat_len, _SEED_REPEAT)
    parts = [np.tile(base, preamble.num_repeats)]
    if preamble.training_symbol is not None:
        t = preamble.training_symbol
        freq = training_symbol_freq_pattern(t.n_fft)
        time = np.fft.ifft(freq).astype(np.complex64)
        parts.append(np.concatenate([time[-t.cp_len:], time]) if t.cp_len else time)
    return np.concatenate(parts).astype(np.complex64)


def _sliding_sum(x, win: int):
    """Sum of x[t..t+win] for every valid t, via cumsum (O(n))."""
    c = jnp.cumsum(x, axis=-1)
    zero = jnp.zeros(x.shape[:-1] + (1,), dtype=c.dtype)
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., win:] - c[..., :-win]


@cjit
def sc_metric(iq, repeat_len: int, num_repeats: int):
    """Vectorized S&C metric over every candidate offset.

    Returns (p, r): complex correlation P(d) and window energy R(d) arrays,
    each of length len(iq) − num_repeats·repeat_len + 1 … computed as
    sliding-window sums (see module docstring).
    """
    z = jnp.asarray(iq)
    L = repeat_len
    W = (num_repeats - 1) * L
    c = jnp.conj(z[..., :-L]) * z[..., L:]
    e = jnp.abs(z[..., L:]) ** 2
    p = _sliding_sum(c, W)
    r = _sliding_sum(e, W)
    return p, r


def ofdm_sync(iq, fs: float, preamble: OfdmPreamble,
              search_start: int = 0, search_end: Optional[int] = None,
              max_candidates: int = 8):
    """S&C acquisition (ref: ofdm_sync.rs:189-283). Returns sorted candidates.

    Scores are the normalized timing metric |P|²/R² scaled by R/R_peak (the
    plateau tie-break), fractional CFO from the correlation phase. Integer
    CFO from the training symbol runs on the top 5 candidates.
    """
    iq = np.asarray(iq)
    L, R = preamble.repeat_len, preamble.num_repeats
    if L == 0 or R < 2 or fs <= 0.0:
        return []
    preamble_len = preamble.total_len()
    end = min(search_end if search_end is not None else len(iq),
              max(len(iq) - preamble_len, 0))
    if search_start >= end:
        return []

    p, r = sc_metric(iq, L, R)
    p = np.asarray(p)[search_start:end]
    r = np.asarray(r)[search_start:end]
    valid = r > 0.0
    if not valid.any():
        return []
    r_peak = float(r.max())
    score = np.clip(np.abs(p) ** 2 / np.maximum(r * r, 1e-30), 0.0, 1.0)
    score = np.where(valid, score * (r / r_peak), -1.0)
    cfo = np.arctan2(p.imag, p.real) / (2.0 * np.pi * L / fs)

    order = np.argsort(-score)[:max_candidates]
    results = []
    for d in order:
        if score[d] < 0:
            continue
        results.append(OfdmSyncResult(
            start_sample=int(d + search_start),
            cfo_hz=float(cfo[d]),
            integer_cfo_bins=0,
            score=float(score[d]),
        ))

    if preamble.training_symbol is not None:
        t = preamble.training_symbol
        for i, res in enumerate(results[:5]):
            ts = res.start_sample + L * R
            k = estimate_integer_cfo_bins(iq, fs, t, ts, res.cfo_hz)
            results[i] = res._replace(integer_cfo_bins=k)
    return results


def estimate_integer_cfo_bins(iq, fs: float, training: TrainingSymbol,
                              training_start: int, fractional_cfo_hz: float) -> int:
    """Circular bin-shift search on the training symbol
    (ref: ofdm_sync.rs:287-345)."""
    total = training.total_len()
    iq = np.asarray(iq)
    if training_start + total > len(iq):
        return 0
    raw = iq[training_start:training_start + total]
    corrected, _ = rotate_host(raw, np.float32(-fractional_cfo_hz), fs)
    freq = np.asarray(symbol_fft(corrected, training.n_fft, training.cp_len))[0]
    known = training_symbol_freq_pattern(training.n_fft)
    # corr(shift) = Σ_bin conj(known[bin])·freq[(bin+shift) mod n] — a circular
    # cross-correlation: compute via FFT in O(n log n).
    x = np.fft.ifft(np.fft.fft(freq) * np.conj(np.fft.fft(known)))
    corr2 = np.abs(x) ** 2  # corr2[s] for shift s in natural order
    n = training.n_fft
    shifts = np.arange(n)
    signed = np.where(shifts <= n // 2, shifts, shifts - n)
    # the reference searches -n/2..=n/2; prefer the max |corr|²
    best = int(signed[np.argmax(corr2)])
    return best
