"""Costas-array sync scoring for FT8/FT4 (behavioral spec: sync/costas.rs).

The reference scores each (time, freq) candidate with a nested loop over
Costas cells. Design: the per-cell difference metric
    C[s, b] = max(0, wf[s,b] − max(neighbors in freq and time))
is computed ONCE for the whole waterfall (4 shifted maxes), and the score
grid over ALL candidate (t, f) pairs is a sum of shifted views of C — a
sparse correlation with the Costas kernel, fully vectorized. Top-N via
jax.lax.top_k instead of the reference's min-heap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import jax.numpy as jnp


@dataclass
class Candidate:
    """(ref sync/costas.rs Candidate)"""
    time_sym: int
    freq_bin: int
    score: float


def costas_kernel(costas, sync_pos: Sequence[int]) -> List[Tuple[int, int]]:
    """(symbol offset, tone offset) pairs of every Costas cell in a frame.

    ``costas``: one tone sequence shared by all blocks (FT8) or a (blocks,
    len) array with one sequence per block (FT4).
    """
    costas = np.asarray(costas, np.int64)
    if costas.ndim == 1:
        costas = np.broadcast_to(costas, (len(sync_pos), costas.shape[0]))
    out = []
    for blk, start in enumerate(sync_pos):
        for ci, tone in enumerate(costas[blk]):
            out.append((start + ci, int(tone)))
    return out


def costas_score(wf, costas, sync_pos: Sequence[int], time_sym: int,
                 freq_bin: int) -> float:
    """Score one candidate location (ref costas_score) — convenience/testing
    path; the batch search uses the vectorized grid below."""
    w = np.asarray(wf)
    S, B = w.shape
    total = 0.0
    for ds, tone in costas_kernel(costas, list(sync_pos)):
        sym = time_sym + ds
        bin_ = freq_bin + tone
        if not (0 <= sym < S and 0 <= bin_ < B):
            continue
        e_sig = w[sym, bin_]
        nb = [w[sym, bin_ - 1] if bin_ > 0 else -np.inf,
              w[sym, bin_ + 1] if bin_ + 1 < B else -np.inf,
              w[sym - 1, bin_] if sym > 0 else -np.inf,
              w[sym + 1, bin_] if sym + 1 < S else -np.inf]
        total += max(e_sig - max(nb), 0.0)
    return float(total)


def _shift_sum(cell, kernel, t_count, f_count, pad_top: int = 0):
    """score[..., t, f] = Σ_kernel cell[..., t + ds, f + db]; out-of-grid
    cells are 0 (kernel offsets are pre-shifted so ds + pad_top ≥ 0).
    Offsets are static, so the shifted views are plain slices."""
    max_ds = max(ds for ds, _ in kernel) + pad_top
    max_db = max(db for db, _ in kernel)
    S, B = cell.shape[-2:]
    pad_s = max(t_count + max_ds - (S + pad_top), 0)
    pad_b = max(f_count + max_db - B, 0)
    lead = [(0, 0)] * (cell.ndim - 2)
    cp = jnp.pad(cell, lead + [(pad_top, pad_s), (0, pad_b)])
    score = jnp.zeros(cell.shape[:-2] + (t_count, f_count), jnp.float32)
    for ds, db in kernel:
        s0 = ds + pad_top
        score = score + cp[..., s0:s0 + t_count, db:db + f_count]
    return score


def candidate_score_grid(wf, costas, sync_pos: Sequence[int], num_tones: int,
                         t_min: int, t_max: int):
    """Traceable Costas score grid over every (t, f) start: (..., S, B)
    waterfall → (..., t_count, f_count). Leading axes batch (the many-window
    receive path scores all windows in one device program)."""
    wf = jnp.asarray(wf)
    S, B = wf.shape[-2:]
    f_count = B - num_tones + 1
    t_count = t_max - t_min + 1
    kernel = costas_kernel(costas, [p + t_min for p in sync_pos])

    lead = wf.shape[:-2]
    neg_row = jnp.full(lead + (1, B), -jnp.inf, wf.dtype)
    neg_col = jnp.full(lead + (S, 1), -jnp.inf, wf.dtype)
    up = jnp.concatenate([neg_row, wf[..., :-1, :]], axis=-2)
    down = jnp.concatenate([wf[..., 1:, :], neg_row], axis=-2)
    left = jnp.concatenate([neg_col, wf[..., :, :-1]], axis=-1)
    right = jnp.concatenate([wf[..., :, 1:], neg_col], axis=-1)
    neigh = jnp.maximum(jnp.maximum(up, down), jnp.maximum(left, right))
    cell = jnp.maximum(wf - neigh, 0.0)

    pad_top = max(0, -min(ds for ds, _ in kernel))
    return _shift_sum(cell, kernel, t_count, f_count, pad_top)


def find_candidates(wf, costas, sync_pos: Sequence[int], num_tones: int,
                    t_min: int, t_max: int, max_candidates: int
                    ) -> List[Candidate]:
    """Top-N Costas-scored frame starts (ref find_candidates).

    ``t_min``/``t_max`` are inclusive symbol offsets into the waterfall.
    """
    wf = jnp.asarray(wf)
    S, B = wf.shape
    if B <= num_tones:
        return []
    f_count = B - num_tones + 1
    t_count = t_max - t_min + 1
    if t_count <= 0:
        return []
    score = candidate_score_grid(wf, costas, sync_pos, num_tones,
                                 t_min, t_max)
    k = min(max_candidates, t_count * f_count)
    import jax
    vals, idx = jax.lax.top_k(score.reshape(-1), k)
    vals = np.asarray(vals)
    idx = np.asarray(idx)
    return [Candidate(time_sym=int(i // f_count) + t_min,
                      freq_bin=int(i % f_count), score=float(v))
            for v, i in zip(vals, idx)]
