"""Block + Forney convolutional interleavers (ref: /root/reference/src/fec/interleaver.rs).

Design:
* Block interleaver — a reshape/transpose, generic over dtype (the inner
  deinterleaver permutes f32 LLRs, the outer permutes u8 bytes).
* Forney interleaver — the reference streams bytes through per-branch FIFOs;
  here the identity "a byte entering branch j = t mod I at position t exits
  at t + j·M·I" turns the whole device into ONE gather with a carried
  history window (length (I−1)·M·I) — fully vectorized, chunk-invariant.
* Byte-domain control path ⇒ host numpy; the permutations are identical
  either way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


# ── Block interleaver ────────────────────────────────────────────────────────


def block_interleave(x, rows: int, cols: int):
    """Row-in / column-out over exactly rows·cols elements (interleaver.rs:56-99)."""
    x = np.asarray(x)
    n = rows * cols
    assert x.shape[-1] == n, "interleave input must be one full block"
    m = x.reshape(x.shape[:-1] + (rows, cols))
    return np.swapaxes(m, -1, -2).reshape(x.shape[:-1] + (n,))


def block_deinterleave(x, rows: int, cols: int):
    x = np.asarray(x)
    n = rows * cols
    assert x.shape[-1] == n, "deinterleave input must be one full block"
    m = x.reshape(x.shape[:-1] + (cols, rows))
    return np.swapaxes(m, -1, -2).reshape(x.shape[:-1] + (n,))


# ── Forney convolutional interleaver ─────────────────────────────────────────


def conv_roundtrip_delay(branches: int, depth: int) -> int:
    return branches * (branches - 1) * depth


class ForneyState(NamedTuple):
    history: np.ndarray  # last (I−1)·M·I inputs (zeros initially)
    pos: int              # commutator offset of the next input byte


def _forney_apply(x, branches: int, depth: int, state: Optional[ForneyState],
                  deinterleave: bool):
    x = np.asarray(x)
    I, M = branches, depth
    D = (I - 1) * M * I  # max per-byte delay in stream positions
    if state is None:
        state = ForneyState(
            history=np.zeros(x.shape[:-1] + (D,), dtype=x.dtype), pos=0)
    n = x.shape[-1]
    # Per-byte delay depends only on the commutator phase (t+pos) mod I, so
    # each phase class is one arithmetic progression: I strided slice copies
    # run at memcpy speed (~2.4× the fancy-index gather they replace). Only
    # the first min(n, D) outputs can reach back into the history window, so
    # the history concat is bounded at D bytes and the bulk strides straight
    # off ``x``.
    pos = int(state.pos)
    out = np.empty_like(x)
    n_head = min(n, D)
    xp = np.concatenate([state.history, x[..., :n_head]], axis=-1)
    for c in range(I):
        t0 = (c - pos) % I
        j = (I - 1 - c) if deinterleave else c
        d_c = j * M * I
        if t0 < n_head:                       # head: may read history
            m = (n_head - t0 + I - 1) // I
            s0 = D + t0 - d_c
            out[..., t0:t0 + I * m:I] = xp[..., s0:s0 + I * m:I]
        tb = t0 + ((n_head - t0 + I - 1) // I) * I
        if tb < n:                            # bulk: t ≥ D ⇒ t − d_c ≥ 0
            m = (n - tb + I - 1) // I
            s0 = tb - d_c
            out[..., tb:tb + I * m:I] = x[..., s0:s0 + I * m:I]
    if n >= D:
        hist = np.ascontiguousarray(x[..., n - D:])
    else:
        hist = np.concatenate([state.history[..., n:], x], axis=-1)
    new_state = ForneyState(history=hist, pos=int((pos + n) % I))
    return out, new_state


def forney_interleave(x, branches: int = 12, depth: int = 17,
                      state: Optional[ForneyState] = None):
    """Streaming Forney interleave; 1:1 length, state carried
    (ref: interleaver.rs:137-230). DVB-T outer: I=12, M=17."""
    return _forney_apply(x, branches, depth, state, deinterleave=False)


def forney_deinterleave(x, branches: int = 12, depth: int = 17,
                        state: Optional[ForneyState] = None):
    """Matched deinterleaver: branch j delay (I−1−j)·M (interleaver.rs:232-305)."""
    return _forney_apply(x, branches, depth, state, deinterleave=True)


def forney_flush(branches: int, depth: int, state: ForneyState, deinterleave=False):
    """Drain: feed roundtrip_delay zeros (frame-orchestrator shape)."""
    d = conv_roundtrip_delay(branches, depth)
    zeros = np.zeros(state.history.shape[:-1] + (d,), dtype=state.history.dtype)
    return _forney_apply(zeros, branches, depth, state, deinterleave)
