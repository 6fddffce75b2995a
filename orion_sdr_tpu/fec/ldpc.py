"""Constructive IRA/staircase LDPC family (ref: /root/reference/src/fec/ldpc_codes.rs).

Wire compatibility: H = [A | T] is rebuilt from the same deterministic greedy
fill (row-load balance + 4-cycle guard, xorshift64 tie-break with the
reference's per-code seeds), so TX here decodes on the reference and vice
versa. Codes: N512R12 (512,256), N576R23 (576,384), N512R34 (512,384),
column weight 3.

Design:
* encode — parity = cumulative-XOR of A·msg row sums: one int matmul
  (batched over codewords) + a parity prefix scan.
* decode — belief propagation over a *dense padded* Tanner graph: the
  check→bit incidence is a (M, max_deg) index array + mask, so the
  check-node update is a leave-one-out product over a fixed tiny axis and
  the variable-node update is one segment-sum — no jagged lists, no Python
  loops, fully batchable with vmap over codewords.
* rules — SumProduct (tanh/atanh rational approximations matching the
  reference's fast_tanh/fast_atanh), MinSum, ScaledMinSum(α).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.device import cjit

LDPC_CODES = {
    "N512R12": (512, 256, 0x4C44_5043_3531_3200),
    "N576R23": (576, 384, 0x4C44_5043_3531_3201),
    "N512R34": (512, 384, 0x4C44_5043_3531_3202),
}

COL_WEIGHT = 3
_MASK64 = (1 << 64) - 1


def _build_msg_col_rows(k: int, m: int, seed: int) -> list:
    """Deterministic A-block fill (ref: ldpc_codes.rs:134-215): per message
    column pick COL_WEIGHT rows, least-loaded first, rotating xorshift offset
    as tie-break, rejecting rows that would form an A-block 4-cycle."""
    state = seed

    def nxt():
        nonlocal state
        state = (state ^ (state << 13)) & _MASK64
        state = (state ^ (state >> 7)) & _MASK64
        state = (state ^ (state << 17)) & _MASK64
        return state

    row_load = [0] * m
    used_pairs = set()
    cols = []
    for _ in range(k):
        rows = []
        while len(rows) < COL_WEIGHT:
            offset = nxt() % m
            best, best_load = None, None
            for step in range(m):
                r = (offset + step) % m
                if r in rows:
                    continue
                if any((min(q, r), max(q, r)) in used_pairs for q in rows):
                    continue
                if best_load is None or row_load[r] < best_load:
                    best_load = row_load[r]
                    best = r
            if best is not None:
                rows.append(best)
            else:
                # relax the girth constraint rather than loop forever
                for step in range(m):
                    r = (offset + step) % m
                    if r not in rows:
                        rows.append(r)
                        break
        for i in range(len(rows)):
            row_load[rows[i]] += 1
            for j in range(i + 1, len(rows)):
                used_pairs.add((min(rows[i], rows[j]), max(rows[i], rows[j])))
        cols.append(sorted(rows))
    return cols


@dataclass(frozen=True)
class LdpcGraph:
    """Trace-time constants describing one code's Tanner graph."""
    name: str
    n: int
    k: int
    m: int
    A: np.ndarray              # (m, k) uint8 — dense A block (for encode matmul)
    check_bits: np.ndarray     # (m, max_deg) int32, padded with n (dummy bit)
    check_mask: np.ndarray     # (m, max_deg) bool
    max_deg: int


@lru_cache(maxsize=None)
def ldpc_graph(name: str) -> LdpcGraph:
    """Construct (and cache — the reference's CodecCache equivalent) a
    code's graph."""
    n, k, seed = LDPC_CODES[name]
    m = n - k
    cols = _build_msg_col_rows(k, m, seed)

    A = np.zeros((m, k), dtype=np.uint8)
    check_bits = [[] for _ in range(m)]
    for col, rows in enumerate(cols):
        for r in rows:
            A[r, col] = 1
            check_bits[r].append(col)
    for i in range(m):
        check_bits[i].append(k + i)
        if i > 0:
            check_bits[i].append(k + i - 1)

    max_deg = max(len(b) for b in check_bits)
    cb = np.full((m, max_deg), n, dtype=np.int32)  # pad with dummy bit index n
    mask = np.zeros((m, max_deg), dtype=bool)
    for i, bits in enumerate(check_bits):
        cb[i, :len(bits)] = bits
        mask[i, :len(bits)] = True
    return LdpcGraph(name=name, n=n, k=k, m=m, A=A,
                     check_bits=cb, check_mask=mask, max_deg=max_deg)


# ── encode ───────────────────────────────────────────────────────────────────


@cjit
def ldpc_encode(name: str, message):
    """Systematic encode (..., K) bits → (..., N) codeword
    (ref: ldpc_codes.rs:304-328): s = A·msg mod 2, p = prefix-XOR(s)."""
    g = ldpc_graph(name)
    msg = jnp.asarray(message).astype(jnp.int32) & 1
    A = jnp.asarray(g.A.astype(np.int32))
    s = jnp.einsum("mk,...k->...m", A, msg) & 1
    # prefix XOR == cumulative sum mod 2
    p = jnp.cumsum(s, axis=-1) & 1
    return jnp.concatenate([msg, p], axis=-1).astype(jnp.uint8)


# ── decode ───────────────────────────────────────────────────────────────────


def _fast_tanh(x):
    """Rational tanh approximation (ref: ldpc_codes.rs:561-573)."""
    x2 = x * x
    a = x * (945.0 + x2 * (105.0 + x2))
    b = 945.0 + x2 * (420.0 + x2 * 15.0)
    return jnp.clip(a / b, -1.0, 1.0)


def _fast_atanh(x):
    x2 = x * x
    a = x * (945.0 + x2 * (-735.0 + x2 * 64.0))
    b = 945.0 + x2 * (-1050.0 + x2 * 225.0)
    return a / b


def _syndrome_weight(g: LdpcGraph, hard_padded):
    """hard_padded: (..., N+1) with dummy 0 at index N."""
    bits = hard_padded[..., g.check_bits]          # (..., m, D)
    x = jnp.sum(jnp.where(g.check_mask, bits, 0), axis=-1) & 1
    return jnp.sum(x, axis=-1)


_FIRST_PASS_ITERS = 12


def ldpc_decode(name: str, llr, max_iter: int = 50, rule: str = "sum_product",
                alpha: float = 0.75):
    """Belief-propagation decode (ref: ldpc_codes.rs:357-536).

    ``llr``: (..., N) float32, positive ⇒ bit 0. Returns
    (message (..., K) uint8, unsat (...,) int32) — 0 unsatisfied checks means
    a valid codeword was reached.

    Two-stage batch early exit: bp_decode's in-device exit only fires when
    EVERY codeword converges, so one straggler pins the whole batch at
    max_iter. Host strategy: a 12-iteration first pass (the typical
    operating point converges in <10), then ONLY the still-unsatisfied rows
    re-decode at full depth — padded to power-of-two row counts so the
    second pass hits a handful of compiled shapes. Single codewords and
    traced callers take the one-shot path.
    """
    import jax.core
    g = ldpc_graph(name)
    if not isinstance(llr, jax.core.Tracer) and np.ndim(llr) >= 2 \
            and np.shape(llr)[0] == 0:
        lead = np.shape(llr)[:-1]
        return (np.zeros(lead + (g.k,), np.uint8),
                np.zeros(lead, np.int32))
    if (isinstance(llr, jax.core.Tracer) or max_iter <= _FIRST_PASS_ITERS
            or np.ndim(llr) < 2):
        return bp_decode(g, llr, max_iter, rule, alpha)
    llr = np.asarray(llr, np.float32)
    bits, unsat = bp_decode(g, llr, _FIRST_PASS_ITERS, rule, alpha)
    bits = np.array(bits)       # writable copies (cjit outputs may be views)
    unsat = np.array(unsat)
    bad = np.flatnonzero(unsat.reshape(-1) != 0)
    if len(bad) == 0:
        return bits, unsat
    flat = llr.reshape(-1, llr.shape[-1])
    n_pad = 1 << max(int(np.ceil(np.log2(len(bad)))), 0)
    sel = np.zeros((n_pad, llr.shape[-1]), np.float32)
    sel[:len(bad)] = flat[bad]
    bits2, unsat2 = bp_decode(g, sel, max_iter, rule, alpha)
    bflat = bits.reshape(-1, bits.shape[-1])
    uflat = unsat.reshape(-1)
    bflat[bad] = np.asarray(bits2)[:len(bad)]
    uflat[bad] = np.asarray(unsat2)[:len(bad)]
    return bflat.reshape(bits.shape), uflat.reshape(unsat.shape)


@lru_cache(maxsize=None)
def _bit_edges(graph_key: str) -> np.ndarray:
    """(N, max_col_deg) edge ids of each bit (edge e = check·D + slot),
    padded with E — the index of an always-zero slot appended to the
    flattened edge messages, so a bit's message sum is one gather + sum."""
    g = _GRAPH_BY_KEY[graph_key]
    E = g.m * g.max_deg
    flat_bits = g.check_bits.reshape(-1)
    flat_mask = g.check_mask.reshape(-1)
    per_bit = [[] for _ in range(g.n)]
    for e in range(E):
        if flat_mask[e]:
            per_bit[flat_bits[e]].append(e)
    deg = max(len(es) for es in per_bit)
    table = np.full((g.n, deg), E, np.int32)
    for b, es in enumerate(per_bit):
        table[b, :len(es)] = es
    return table


_GRAPH_BY_KEY: dict = {}


def _graph_key(g: LdpcGraph) -> str:
    key = f"{g.name}:{g.n}:{g.k}"
    _GRAPH_BY_KEY.setdefault(key, g)
    return key


def _loo_prod(t):
    """Leave-one-out product along the last axis via exclusive prefix/suffix
    cumulative products — O(D) instead of the O(D²) stack-of-reductions."""
    ones = jnp.ones_like(t[..., :1])
    left = jnp.concatenate([ones, jnp.cumprod(t[..., :-1], axis=-1)], axis=-1)
    right = jnp.concatenate(
        [jnp.cumprod(t[..., :0:-1], axis=-1)[..., ::-1], ones], axis=-1)
    return left * right


def _check_update(msg, mask, rule: str, alpha: float):
    """Check-node update: (..., m, D) bit→check messages → check→bit
    extrinsics, 0 on padded lanes."""
    if rule == "sum_product":
        t = jnp.where(mask, _fast_tanh(msg / 2.0), 1.0)
        ext = 2.0 * _fast_atanh(jnp.clip(_loo_prod(t), -1.0, 1.0))
    else:
        a = jnp.where(mask, jnp.abs(msg), jnp.inf)
        sign = jnp.where(mask & (msg < 0), -1.0, 1.0)
        sign_par = jnp.prod(sign, axis=-1, keepdims=True)
        min1 = jnp.min(a, axis=-1, keepdims=True)
        argmin = jnp.argmin(a, axis=-1)
        # second smallest: mask out the argmin lane
        onehot = jax.nn.one_hot(argmin, msg.shape[-1], dtype=bool)
        min2 = jnp.min(jnp.where(onehot, jnp.inf, a), axis=-1, keepdims=True)
        mag = jnp.where(onehot, min2, min1)
        s_other = sign_par * sign  # sign product excluding own edge
        scale = alpha if rule == "scaled_min_sum" else 1.0
        ext = scale * s_other * mag
    return jnp.where(mask, ext, 0.0)


@cjit
def bp_decode(g: LdpcGraph, llr, max_iter: int = 50, rule: str = "sum_product",
              alpha: float = 0.75):
    """BP over any padded Tanner graph (shared by the staircase family and
    the FT8 LDPC(174,91) in codec/ft8_ldpc.py). See ldpc_decode.

    Early exit: iteration stops once EVERY codeword in the batch has hit a
    zero-syndrome snapshot (the reference's per-codeword early return,
    ldpc_codes.rs:357-366, lifted to the batch) — typical operating points
    converge in <10 iterations, so this is worth ~5× over a fixed 50.

    Edge messages move by index: bit → edges through ``check_bits``, and
    edges → per-bit sums through ``_bit_edges`` (a gather and a sum, no
    scatter)."""
    llr = jnp.asarray(llr, dtype=jnp.float32)
    mask = jnp.asarray(g.check_mask)               # (m, D)
    D = g.max_deg
    lead = llr.shape[:-1]
    flat_bits = jnp.asarray(g.check_bits.reshape(-1))
    bit_edges = jnp.asarray(_bit_edges(_graph_key(g)))   # (N, col_deg)

    def pad(x):
        return jnp.concatenate([x, jnp.zeros(lead + (1,), x.dtype)], axis=-1)

    def syndrome(hard):
        return _syndrome_weight(g, pad(hard))

    def gather_edges(total_p):
        return total_p[..., flat_bits].reshape(lead + (g.m, D))

    def bit_sums(ext):
        flat = ext.reshape(lead + (-1,))
        return jnp.sum(pad(flat)[..., bit_edges], axis=-1)

    llr_p = pad(llr)
    hard0 = (llr <= 0.0).astype(jnp.int32)
    unsat0 = syndrome(hard0)

    # edge messages live as (..., m, D); padded lanes carry +inf-ish neutral
    msg0 = jnp.where(mask, gather_edges(llr_p), 1e30)

    def body(carry):
        i, msg, best, min_unsat = carry
        ext = _check_update(msg, mask, rule, alpha)
        total = llr + bit_sums(ext)                  # (..., N)
        hard = (total <= 0.0).astype(jnp.int32)
        unsat = syndrome(hard)
        better = unsat < min_unsat
        best = jnp.where(better[..., None], hard, best)
        min_unsat = jnp.where(better, unsat, min_unsat)
        # variable→check: msg = total[bit] − ext (own edge excluded)
        msg_new = jnp.where(mask, gather_edges(pad(total)) - ext, 1e30)
        return i + 1, msg_new, best, min_unsat

    def cond(carry):
        i, _, _, min_unsat = carry
        return (i < max_iter) & jnp.any(min_unsat > 0)

    _, _, best, min_unsat = jax.lax.while_loop(
        cond, body, (jnp.int32(0), msg0, hard0, unsat0))

    return best[..., :g.k].astype(jnp.uint8), min_unsat.astype(jnp.int32)


def ldpc_syndrome_weight(name: str, hard):
    g = ldpc_graph(name)
    h = jnp.asarray(hard).astype(jnp.int32) & 1
    hp = jnp.concatenate([h, jnp.zeros(h.shape[:-1] + (1,), h.dtype)], axis=-1)
    return _syndrome_weight(g, hp)
