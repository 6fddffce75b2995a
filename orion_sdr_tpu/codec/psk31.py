"""QPSK31 rate-1/2 K=5 convolutional code + Viterbi MLSE (spec: codec/psk31.rs).

G0 = 0o25 = 0b10101, G1 = 0o23 = 0b10011. For input x[n] the coded pair is
    g0[n] = x[n] ^ x[n-2] ^ x[n-4]
    g1[n] = x[n] ^ x[n-3] ^ x[n-4]
(no tail termination — PSK31 is a continuous stream). The trellis has 16
states (the 4 most recent inputs, newest at bit 3).

Design: the encoder is a pure shift-XOR (vectorized numpy). The batch
Viterbi decoders are a `lax.scan` over symbols with all 16 states' ACS
vectorized per step (and `jax.vmap`-able over independent candidate streams);
throughput comes from batching candidates, not from parallelizing within the
inherently sequential trellis. `StreamingViterbi` is the fixed-lag host-side
variant used by the live text pipeline.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

NUM_STATES = 16
TRACEBACK_DEPTH = 32  # fldigi-style fixed lag; textbook 5·(K−1)=20 + margin
_PATHMEM = 128

# DQPSK step phasor per dibit = g0·2 + g1; sign convention: after differential
# detection d = sym·conj(prev), Re(d) soft-demodulates g0 and Im(d) g1, with
# positive ⇒ coded bit 0 (matches modulate/psk31.rs QPSK31_PHASE_STEP).
DQPSK_EXP = np.array([1.0 + 0.0j, 0.0 - 1.0j, 0.0 + 1.0j, -1.0 + 0.0j],
                     dtype=np.complex64)


def conv_encode(bits, sr: int = 0) -> np.ndarray:
    """Rate-1/2 K=5 encode; returns interleaved [g0_0, g1_0, g0_1, ...].

    ``sr`` is the 4-bit encoder state (past inputs, newest at bit 3) for
    stream continuation; bit k of sr is the input (4-k) steps ago.
    """
    x = np.asarray(bits, dtype=np.uint8) & 1
    # History from sr: index 0 = oldest (4 ago) ... 3 = newest (1 ago).
    hist = np.array([(sr >> k) & 1 for k in range(4)], dtype=np.uint8)
    xp = np.concatenate([hist, x])
    n = len(x)
    g0 = xp[4:4 + n] ^ xp[2:2 + n] ^ xp[0:n]
    g1 = xp[4:4 + n] ^ xp[1:1 + n] ^ xp[0:n]
    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = g0
    out[1::2] = g1
    return out


def conv_encode_final_sr(bits, sr: int = 0) -> int:
    """Encoder shift register after encoding ``bits`` from state ``sr``."""
    for b in np.asarray(bits, dtype=np.uint8) & 1:
        sr = (sr >> 1) | (int(b) << 3)
    return sr


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@lru_cache(maxsize=1)
def _trellis():
    """Static trellis tables.

    Returns (pred, bit_of_ns, dibit) where for each next-state ns the two
    predecessors are pred[ns] = [2·(ns&7), 2·(ns&7)+1], the input bit that
    reaches ns is (ns>>3)&1, and dibit[p, b] = g0·2+g1 for the transition
    from state p on input b.
    """
    pred = np.stack([2 * (np.arange(NUM_STATES) & 7),
                     2 * (np.arange(NUM_STATES) & 7) + 1], axis=1).astype(np.int32)
    bit_of_ns = ((np.arange(NUM_STATES) >> 3) & 1).astype(np.int32)
    dibit = np.zeros((NUM_STATES, 2), np.int32)
    for s in range(NUM_STATES):
        for b in range(2):
            window = (b << 4) | s
            g0 = _parity(window & 0b10101)
            g1 = _parity(window & 0b10011)
            dibit[s, b] = g0 * 2 + g1
    return pred, bit_of_ns, dibit


_INF = np.float32(3.0e38) / 2


def _acs_tables():
    pred, bit_of_ns, dibit = _trellis()
    # dibit of the transition pred[ns, j] --bit_of_ns[ns]--> ns
    trans_dibit = dibit[pred, bit_of_ns[:, None]]  # (16, 2)
    return (jnp.asarray(pred), jnp.asarray(trans_dibit))


def _viterbi_traceback(prev_tables, final_pm):
    """Shared traceback: follow prev-state chain from the best final state."""
    state0 = jnp.argmin(final_pm).astype(jnp.int32)

    def step(state, tbl):
        bit = (state >> 3) & 1
        return tbl[state], bit.astype(jnp.uint8)

    _, bits_rev = jax.lax.scan(step, state0, prev_tables, reverse=True)
    return bits_rev


@jax.jit
def viterbi_decode(soft_pairs):
    """Non-coherent soft Viterbi over DQPSK differential products.

    ``soft_pairs``: (n_syms, 2) float32 [Re(d), Im(d)] per symbol (the
    reference's interleaved [re, im] layout, reshaped). Returns (n_syms,)
    uint8 decoded bits. Branch metric = |d − DQPSK_EXP[dibit]|².
    """
    pred, trans_dibit = _acs_tables()
    exp = jnp.asarray(DQPSK_EXP)
    d = soft_pairs[..., 0] + 1j * soft_pairs[..., 1]

    pm0 = jnp.full((NUM_STATES,), _INF, jnp.float32).at[0].set(0.0)

    def acs(pm, dk):
        bm4 = jnp.abs(dk - exp) ** 2              # metric per dibit (4,)
        cand = pm[pred] + bm4[trans_dibit]        # (16, 2)
        j = jnp.argmin(cand, axis=1)
        new_pm = jnp.min(cand, axis=1)
        choice = jnp.take_along_axis(pred, j[:, None], axis=1)[:, 0]
        # renormalize so long streams don't overflow f32
        new_pm = new_pm - jnp.min(new_pm)
        return new_pm, choice.astype(jnp.int32)

    pm, tables = jax.lax.scan(acs, pm0, d)
    return _viterbi_traceback(tables, pm)


@jax.jit
def viterbi_decode_coherent(soft_pairs):
    """Coherent MLSE: each state carries a hypothesised absolute phasor
    (initial (1,0), matching Qpsk31Mod); branch metric |sym_c − hyp·step|².
    Eliminates the ~3 dB differential noise-product penalty.
    """
    pred, trans_dibit = _acs_tables()
    steps = jnp.asarray(DQPSK_EXP)
    s = soft_pairs[..., 0] + 1j * soft_pairs[..., 1]

    pm0 = jnp.full((NUM_STATES,), _INF, jnp.float32).at[0].set(0.0)
    hyp0 = jnp.ones((NUM_STATES,), jnp.complex64)

    def acs(carry, sk):
        pm, hyp = carry
        nh = hyp[pred] * steps[trans_dibit]        # (16, 2)
        bm = jnp.abs(sk - nh) ** 2
        cand = pm[pred] + bm
        j = jnp.argmin(cand, axis=1)
        new_pm = jnp.take_along_axis(cand, j[:, None], axis=1)[:, 0]
        new_hyp = jnp.take_along_axis(nh, j[:, None], axis=1)[:, 0]
        choice = jnp.take_along_axis(pred, j[:, None], axis=1)[:, 0]
        new_pm = new_pm - jnp.min(new_pm)
        return (new_pm, new_hyp), choice.astype(jnp.int32)

    (pm, _), tables = jax.lax.scan(acs, (pm0, hyp0), s)
    return _viterbi_traceback(tables, pm)


def viterbi_decode_hard(bits) -> np.ndarray:
    """Hard-input decode: map (c0, c1) pairs to DQPSK phasors, then soft."""
    b = np.asarray(bits, dtype=np.uint8).reshape(-1, 2)
    d = DQPSK_EXP[b[:, 0] * 2 + b[:, 1]]
    pairs = np.stack([d.real, d.imag], axis=-1).astype(np.float32)
    return np.asarray(viterbi_decode(jnp.asarray(pairs)))


class StreamingViterbi:
    """Fixed-lag (32-symbol) sliding-window Viterbi for live QPSK31 text.

    Host-side numpy: at 31.25 baud the trellis is microscopic next to the
    device demod; keeping it on the host keeps the feed/flush driver thin
    (SURVEY §7 "streaming on an accelerator").
    """

    def __init__(self, phase_steps=DQPSK_EXP) -> None:
        pred, bit_of_ns, dibit = _trellis()
        self._pred = pred
        self._trans_dibit = dibit[pred, bit_of_ns[:, None]]
        self._exp = np.asarray(phase_steps, dtype=np.complex64)
        self.pm = np.full(NUM_STATES, _INF, np.float32)
        self.pm[0] = 0.0
        self.history = np.zeros((_PATHMEM, NUM_STATES), np.int32)
        self.ptr = 0
        self.count = 0

    def feed_symbol(self, s_re: float, s_im: float):
        d = np.complex64(s_re + 1j * s_im)
        bm4 = np.abs(d - self._exp) ** 2
        cand = self.pm[self._pred] + bm4[self._trans_dibit]
        j = np.argmin(cand, axis=1)
        self.pm = cand[np.arange(NUM_STATES), j]
        self.history[self.ptr] = self._pred[np.arange(NUM_STATES), j]
        self.ptr = (self.ptr + 1) % _PATHMEM
        self.count += 1
        if self.count % 256 == 255:
            self.pm -= self.pm.min()
        if self.count <= TRACEBACK_DEPTH:
            return None
        state = int(np.argmin(self.pm))
        p = (self.ptr + _PATHMEM - 1) % _PATHMEM
        for _ in range(TRACEBACK_DEPTH):
            state = int(self.history[p][state])
            p = (p + _PATHMEM - 1) % _PATHMEM
        return (state >> 3) & 1

    def flush(self):
        out = []
        for _ in range(TRACEBACK_DEPTH):
            b = self.feed_symbol(0.0, 0.0)
            if b is not None:
                out.append(b)
        return out
