"""LDPC belief propagation in its one-hot form: the reference that
``fec.ldpc.bp_decode`` (the gather form the library runs) is checked and
timed against.

The two forms share the check-node update and the early exit; they differ
only in how edge messages move. Here every move is a dense matmul with a
constant one-hot operator at ``Precision.HIGHEST`` (exact in float32: each
output sums at most a bit's column weight of terms); the library uses index
gathers and a gather-sum instead.

    from tools.bp_onehot import bp_decode_onehot   # same call as bp_decode

Used by ``chip_smoke.py`` (parity on the GPU), ``tools/gpu_timings.py`` (op
and end-to-end timings) and ``tests/test_ops.py`` (parity on the CPU).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from orion_sdr_tpu.dsp.device import cjit
from orion_sdr_tpu.fec.ldpc import (LdpcGraph, _GRAPH_BY_KEY, _graph_key,
                                    _check_update)


@lru_cache(maxsize=None)
def _operators(graph_key: str):
    """S (E, N+1): edges → bits (column N absorbs the padded lanes);
    C (N, m): bits → checks, for the syndrome."""
    g = _GRAPH_BY_KEY[graph_key]
    E = g.m * g.max_deg
    flat_bits = g.check_bits.reshape(-1)
    flat_mask = g.check_mask.reshape(-1)
    S = np.zeros((E, g.n + 1), np.float32)
    S[np.arange(E), flat_bits] = 1.0
    C = np.zeros((g.n, g.m), np.float32)
    for e in np.flatnonzero(flat_mask):
        C[flat_bits[e], e // g.max_deg] = 1.0
    return S, C


@cjit
def bp_decode_onehot(g: LdpcGraph, llr, max_iter: int = 50,
                     rule: str = "sum_product", alpha: float = 0.75):
    """``fec.ldpc.bp_decode`` with one-hot matmuls for every message move;
    same arguments, same (message (..., K) uint8, unsat (...,) int32)."""
    llr = jnp.asarray(llr, dtype=jnp.float32)
    mask = jnp.asarray(g.check_mask)
    lead = llr.shape[:-1]
    S_np, C_np = _operators(_graph_key(g))
    S = jnp.asarray(S_np)
    St = jnp.asarray(S_np.T.copy())
    C = jnp.asarray(C_np)
    hi = jax.lax.Precision.HIGHEST

    def syndrome(hard):
        s = jnp.matmul(hard.astype(jnp.float32), C, precision=hi)
        return jnp.sum(jnp.rint(s).astype(jnp.int32) & 1, axis=-1)

    def gather_edges(total_p):
        e = jnp.matmul(total_p, St, precision=hi)
        return e.reshape(lead + (g.m, g.max_deg))

    llr_p = jnp.concatenate([llr, jnp.zeros(lead + (1,), llr.dtype)], -1)
    hard0 = (llr <= 0.0).astype(jnp.int32)
    unsat0 = syndrome(hard0)
    msg0 = jnp.where(mask, gather_edges(llr_p), 1e30)

    def body(carry):
        i, msg, best, min_unsat = carry
        ext = _check_update(msg, mask, rule, alpha)
        sums = jnp.matmul(ext.reshape(lead + (-1,)), S, precision=hi)
        total = llr_p + sums
        hard = (total[..., :g.n] <= 0.0).astype(jnp.int32)
        unsat = syndrome(hard)
        better = unsat < min_unsat
        best = jnp.where(better[..., None], hard, best)
        min_unsat = jnp.where(better, unsat, min_unsat)
        msg_new = jnp.where(mask, gather_edges(total) - ext, 1e30)
        return i + 1, msg_new, best, min_unsat

    def cond(carry):
        i, _, _, min_unsat = carry
        return (i < max_iter) & jnp.any(min_unsat > 0)

    _, _, best, min_unsat = jax.lax.while_loop(
        cond, body, (jnp.int32(0), msg0, hard0, unsat0))
    return best[..., :g.k].astype(jnp.uint8), min_unsat.astype(jnp.int32)
