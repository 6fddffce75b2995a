"""Punctured convolutional codes + soft Viterbi (ref: /root/reference/src/fec/conv.rs).

Mother codes: K5 (G0=0o25, G1=0o23 — also PSK31's code, codec/psk31.rs:45) and
DvbK7 (G0=0o171, G1=0o133, ETSI EN 300 744 §4.3.3). Zero-tail termination,
standard DVB/802.11 puncture matrices for rates 2/3, 3/4, 5/6, 7/8.

Design:
* encode — a rate-1/2 convolutional encoder is two binary FIR convolutions
  (XOR-dot of the generator taps over the bit stream): one batched int conv,
  no sequential register.
* puncture/depuncture — precomputed boolean masks (trace-time numpy),
  applied as gathers/scatters.
* Viterbi — ``viterbi_trellis`` decodes batches of trellis lanes: on a GPU
  with the warp-per-lane kernel in ops/viterbi_cuda.cu, elsewhere with the
  plain form, an ACS lax.scan over trellis steps (all 2^(K−1) states as one
  vectorized max, decisions recorded per step) and a reverse-scan
  traceback. Both give the same bits.
Branch metric = LLR correlation Σ(1−2c)·llr, maximized (positive ⇒ bit 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.device import cjit

CONV_CODES = {
    "k5": {"K": 5, "g0": 0b10101, "g1": 0b10011},
    "dvb_k7": {"K": 7, "g0": 0b1111001, "g1": 0b1011011},
}

PUNCTURE = {
    "1/2": ([1], [1]),
    "2/3": ([1, 1], [1, 0]),
    "3/4": ([1, 1, 0], [1, 0, 1]),
    "5/6": ([1, 1, 0, 1, 0], [1, 0, 1, 0, 1]),
    "7/8": ([1, 1, 1, 1, 0, 1, 0], [1, 0, 0, 0, 1, 0, 1]),
}


def tail_bits(code: str) -> int:
    return CONV_CODES[code]["K"] - 1


@lru_cache(maxsize=None)
def _tables(code: str):
    """Trellis tables: generator taps (time order), predecessor/branch arrays."""
    c = CONV_CODES[code]
    K, g0, g1 = c["K"], c["g0"], c["g1"]
    S = 1 << (K - 1)
    top = K - 2
    # taps[j] multiplies b_{t-j}: window bit (K-1-j)
    taps0 = np.array([(g0 >> (K - 1 - j)) & 1 for j in range(K)], np.int32)
    taps1 = np.array([(g1 >> (K - 1 - j)) & 1 for j in range(K)], np.int32)
    # next_state(s, b) = (s >> 1) | (b << top);  predecessors of ns:
    prev = np.zeros((S, 2), np.int32)
    sign0 = np.zeros((S, 2), np.float32)  # (1-2c0) for branch prev→ns
    sign1 = np.zeros((S, 2), np.float32)
    for ns in range(S):
        b = (ns >> top) & 1
        base = (ns & ((S >> 1) - 1)) << 1 if S > 1 else 0
        for z in range(2):
            p = base | z
            prev[ns, z] = p
            window = (b << (K - 1)) | p
            c0 = bin(window & g0).count("1") & 1
            c1 = bin(window & g1).count("1") & 1
            sign0[ns, z] = 1.0 - 2.0 * c0
            sign1[ns, z] = 1.0 - 2.0 * c1
    return K, S, top, taps0, taps1, prev, sign0, sign1


@cjit
def conv_encode(bits, code: str = "k5"):
    """Rate-1/2 mother encode (no tail): interleaved [g0_0, g1_0, g0_1, …].

    Equivalent of codec::conv_encode (K5) / conv_encode_code (ref).
    Implemented as two binary convolutions over the bit stream.
    """
    K, S, top, taps0, taps1, *_ = _tables(code)
    b = jnp.asarray(bits).astype(jnp.int32) & 1
    lead = b.shape[:-1]
    n = b.shape[-1]
    # prepend K-1 zeros (initial register), correlate with taps
    bp = jnp.concatenate([jnp.zeros(lead + (K - 1,), jnp.int32), b], axis=-1)
    # window for step t: bits b_t..b_{t-K+1}; build via stacked slices
    wins = jnp.stack([bp[..., j:j + n] for j in range(K)], axis=-1)  # b_{t-K+1+j}
    # taps ordering: taps[j] multiplies b_{t-j} → align: wins[..., K-1-j] = b_{t-j}
    t0 = jnp.asarray(taps0[::-1].copy())
    t1 = jnp.asarray(taps1[::-1].copy())
    c0 = jnp.sum(wins * t0, axis=-1) & 1
    c1 = jnp.sum(wins * t1, axis=-1) & 1
    out = jnp.stack([c0, c1], axis=-1).reshape(lead + (2 * n,))
    return out.astype(jnp.uint8)


def _puncture_mask(rate: str, n_steps: int) -> np.ndarray:
    """Boolean keep-mask over the interleaved 2·n_steps mother output."""
    g0, g1 = PUNCTURE[rate]
    period = len(g0)
    cols = np.arange(n_steps) % period
    keep = np.empty(2 * n_steps, dtype=bool)
    keep[0::2] = np.asarray(g0, bool)[cols]
    keep[1::2] = np.asarray(g1, bool)[cols]
    return keep


def punctured_coded_len(info_bits: int, rate: str, code: str = "k5") -> int:
    """Deterministic coded length (ref: conv.rs:229-251)."""
    n_steps = info_bits + tail_bits(code)
    return int(_puncture_mask(rate, n_steps).sum())


@cjit
def conv_encode_punctured(info_bits, rate: str = "1/2", code: str = "k5"):
    """Zero-tail + mother encode + puncture (ref: conv.rs:190-201)."""
    b = jnp.asarray(info_bits)
    lead = b.shape[:-1]
    tb = tail_bits(code)
    padded = jnp.concatenate([b, jnp.zeros(lead + (tb,), b.dtype)], axis=-1)
    coded = conv_encode(padded, code)
    if rate == "1/2":
        return coded
    keep = _puncture_mask(rate, padded.shape[-1])
    return coded[..., np.nonzero(keep)[0]]


def depuncture_llrs(coded_llrs, info_bits: int, rate: str, code: str = "k5"):
    """Reinsert LLR-0 erasures at punctured positions → (..., 2·n_steps)."""
    l = jnp.asarray(coded_llrs, dtype=jnp.float32)
    n_steps = info_bits + tail_bits(code)
    if rate == "1/2":
        out = jnp.zeros(l.shape[:-1] + (2 * n_steps,), jnp.float32)
        n = min(l.shape[-1], 2 * n_steps)
        return out.at[..., :n].set(l[..., :n])
    keep_idx = np.nonzero(_puncture_mask(rate, n_steps))[0]
    out = jnp.zeros(l.shape[:-1] + (2 * n_steps,), jnp.float32)
    n = min(l.shape[-1], len(keep_idx))
    return out.at[..., keep_idx[:n]].set(l[..., :n])


_NEG = -1e30           # "unreachable" path metric


@cjit
def viterbi_decode_soft(coded_llrs, info_bits: int, rate: str = "1/2",
                        code: str = "k5"):
    """Soft Viterbi over a zero-tail-terminated punctured stream
    (ref: conv.rs:262-348). Returns (..., info_bits) uint8.

    Arbitrary leading batch axes; the trellis runs through
    ``viterbi_trellis`` (the Hopper kernel on a GPU, the scan elsewhere).
    Long streams should use viterbi_decode_soft_chunked."""
    return _viterbi_decode_soft_jnp(jnp.asarray(coded_llrs), info_bits,
                                    rate, code)


def _viterbi_decode_soft_jnp(coded_llrs, info_bits: int, rate: str = "1/2",
                             code: str = "k5"):
    S = _tables(code)[1]
    full = depuncture_llrs(coded_llrs, info_bits, rate, code)
    pm0 = jnp.full(full.shape[:-1] + (S,), _NEG).at[..., 0].set(0.0)
    bits = viterbi_trellis(full[..., 0::2], full[..., 1::2], pm0, code,
                           terminated=True)
    return bits[..., :info_bits]


def _trellis_scan(l0, l1, pm0, code: str, terminated: bool):
    """Plain ACS + traceback as two ``lax.scan``s: (..., T) LLR planes and
    (..., S) initial metrics → (..., T) uint8 bits.

    ``terminated``: zero-tail trellis, traceback from state 0, metrics
    left as they grow. Otherwise (a chunk of a long stream) metrics are
    renormalized every step and the traceback starts at the lowest-index
    best final state."""
    _, S, top, _, _, prev, sign0, sign1 = _tables(code)
    prev_j = jnp.asarray(prev)       # (S, 2)
    s0 = jnp.asarray(sign0)
    s1 = jnp.asarray(sign1)

    def acs(pm, ls):
        la, lb = ls
        cand = pm[..., prev_j] + s0 * la[..., None, None] \
            + s1 * lb[..., None, None]
        dec = jnp.argmax(cand, axis=-1)          # (..., S)
        new_pm = jnp.max(cand, axis=-1)
        if not terminated:
            new_pm = new_pm - jnp.max(new_pm, axis=-1, keepdims=True)
        return new_pm, dec.astype(jnp.uint8)

    pm, decs = jax.lax.scan(acs, jnp.asarray(pm0, jnp.float32),
                            (jnp.moveaxis(l0, -1, 0),
                             jnp.moveaxis(l1, -1, 0)))

    def traceback(state, dec_t):
        bit = (state >> top) & 1
        z = jnp.take_along_axis(dec_t, state[..., None],
                                axis=-1)[..., 0].astype(jnp.int32)
        return prev_j[state, z], bit

    if terminated:
        state0 = jnp.zeros(pm.shape[:-1], jnp.int32)
    else:
        state0 = jnp.argmax(pm, axis=-1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(traceback, state0, decs[::-1])
    return jnp.moveaxis(bits_rev[::-1], 0, -1).astype(jnp.uint8)


def viterbi_trellis(l0, l1, pm0, code: str, terminated: bool):
    """Decode trellis lanes: (..., T) LLR planes (g0 and g1 outputs per
    step, positive ⇒ bit 0) and (..., S) initial metrics → (..., T) uint8.
    The implementation is ``ops.viterbi.trellis_impl``'s choice."""
    from ..ops.viterbi import trellis_impl, trellis_cuda
    l0 = jnp.asarray(l0, jnp.float32)
    l1 = jnp.asarray(l1, jnp.float32)
    c = CONV_CODES[code]
    if trellis_impl(l0.shape[-1], c["K"]) == "scan":
        return _trellis_scan(l0, l1, pm0, code, terminated)
    lead, T = l0.shape[:-1], l0.shape[-1]
    S = _tables(code)[1]
    bits = trellis_cuda(l0.reshape(-1, T), l1.reshape(-1, T),
                        jnp.asarray(pm0, jnp.float32).reshape(-1, S),
                        c["K"], c["g0"], c["g1"], terminated)
    return bits.reshape(lead + (T,))


_CHUNK_STEPS = 1024     # trellis steps per parallel chunk
_CHUNK_OVERLAP = 96     # ≥ 5·(K−1) convergence margin each side


def chunk_lanes(l0, l1, n_chunks: int):
    """Cut (B, V + n_chunks·C + V) margin-padded LLR planes into
    (B, n_chunks, C + 2V) overlapping chunk lanes."""
    C, V = _CHUNK_STEPS, _CHUNK_OVERLAP
    idx = (np.arange(n_chunks) * C)[:, None] + np.arange(C + 2 * V)[None, :]
    return l0[..., idx], l1[..., idx]


def chunk_start_metrics(S: int, n_chunks: int, pinned):
    """(n_chunks, S) initial metrics: chunk 0 pinned at state 0 where
    ``pinned`` (a bool, or a traced scalar), every other chunk uniform."""
    pin = jnp.full((S,), _NEG).at[0].set(0.0)
    first = (jnp.arange(n_chunks)[:, None] == 0) & pinned
    return jnp.where(first, pin[None, :], jnp.zeros((1, S)))


@cjit
def viterbi_decode_soft_chunked(coded_llrs, info_bits: int, rate: str = "1/2",
                                code: str = "dvb_k7"):
    """Overlap-chunked soft Viterbi for LONG streams.

    A 90k-step trellis is inherently sequential; chopping it into
    ``_CHUNK_STEPS``-step chunks with ``_CHUNK_OVERLAP`` warm-up/cool-down
    margins turns the decode into ONE batched trellis over ~1.2k steps — the
    standard fixed-lag approximation (margin ≫ 5·K ⇒ outputs match the full
    Viterbi except in pathological near-tie cases; the outer RS/CRC
    adjudicates regardless). First chunk pins state 0; others start uniform.
    """
    S = _tables(code)[1]
    full = depuncture_llrs(coded_llrs, info_bits, rate, code)
    n_steps = info_bits + tail_bits(code)
    l0 = full[..., 0::2]
    l1 = full[..., 1::2]
    assert l0.ndim in (1, 2), "chunked path takes streams, optionally batched"
    batched = l0.ndim == 2
    if not batched:
        l0, l1 = l0[None], l1[None]
    nb = l0.shape[0]

    C, V = _CHUNK_STEPS, _CHUNK_OVERLAP
    nchunk = -(-n_steps // C)
    total = C * nchunk
    # pad tail with zero LLRs (erasures)
    l0p = jnp.pad(l0, ((0, 0), (V, total - n_steps + V)))
    l1p = jnp.pad(l1, ((0, 0), (V, total - n_steps + V)))
    c0, c1 = chunk_lanes(l0p, l1p, nchunk)          # (nb, nchunk, span)
    pm0 = jnp.broadcast_to(chunk_start_metrics(S, nchunk, True),
                           (nb, nchunk, S))
    bits = viterbi_trellis(c0, c1, pm0, code, terminated=False)
    mid = bits[:, :, V:V + C].reshape(nb, -1)            # drop the margins
    out = mid[:, :info_bits]
    return out if batched else out[0]
