"""Parallel linear recurrences — the batched substrate for IIR state.

The reference library (orion-sdr) runs every IIR filter, DC blocker, and
one-pole envelope as a per-sample Rust loop (e.g. /root/reference/src/dsp/iir.rs,
dsp/dc.rs). On an accelerator a sequential per-sample loop is the one thing
we must not do: instead, every *linear* recurrence is evaluated as a
parallel prefix via ``jax.lax.associative_scan`` (O(log n) depth, fully
vectorized).

Conventions
-----------
* Signals are ``float32`` / ``complex64`` with the time axis last.
* Streaming state is explicit: every function takes an optional carry-in and
  returns a carry-out, so long captures can be processed block-by-block and
  the carries exchanged across devices (see orion_sdr_tpu.parallel).
"""

from __future__ import annotations

import numbers

import numpy as np
import jax
import jax.numpy as jnp


def _first_order_assoc(a, b, y0=None):
    """Associative-scan core of first_order (one shot, O(n) temp memory)."""
    b = jnp.asarray(b)
    a = jnp.broadcast_to(jnp.asarray(a, dtype=b.dtype), b.shape)
    if y0 is not None:
        # Fold the carry into the first element: y[0] = a[0]*y0 + b[0].
        b = b.at[..., 0].add(a[..., 0] * jnp.asarray(y0, dtype=b.dtype))

    def combine(l, r):
        a1, b1 = l
        a2, b2 = r
        return a1 * a2, a2 * b1 + b2

    _, y = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return y, y[..., -1]


_CHUNK = 8192  # cap associative-scan working set; scan chunks sequentially

_GEOM_CHUNK = 128   # chunk length of the triangular-matmul fast path


def _first_order_const(a, b, y0):
    """Constant-coefficient fast path: y[k] = a·y[k−1] + b[k].

    A stable-pole recurrence is a geometric convolution, and within a chunk
    of C samples the zero-state response is ONE triangular matmul:
        zs[k] = Σ_{j≤k} a^(k−j)·b[j]  =  (b @ L)[k],  L[j,k] = a^(k−j)
    — pure matmul work with all entries ≤ 1 (no rescale, no range hazard).
    Chunk boundaries chain through a tiny associative scan with coefficient
    a^C over n/C terms. Two passes over the data instead of the full
    associative scan's ~6 — the IIR cascades are memory-traffic-limited.
    """
    b = jnp.asarray(b)
    n = b.shape[-1]
    mag = abs(a)
    C = _GEOM_CHUNK
    if mag >= 1.0 or n < 2 * C:
        return _first_order_assoc(a, b, y0)
    nchunk = -(-n // C)
    pad = nchunk * C - n
    lead = b.shape[:-1]
    bp = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)]) if pad else b
    bc = bp.reshape(lead + (nchunk, C))

    k = np.arange(C)
    a_c = np.complex128(a) if isinstance(a, complex) else np.float64(a)
    expo = k[None, :] - k[:, None]
    L = np.where(expo >= 0, a_c ** np.maximum(expo, 0), 0).astype(
        np.complex64 if isinstance(a, complex) else np.float32)
    if jnp.iscomplexobj(bc) and L.dtype != np.complex64:
        L = L.astype(np.complex64)
    a_k1 = (a_c ** (k + 1)).astype(bc.dtype)
    aC = a_c ** C

    zero_state = jnp.matmul(bc, jnp.asarray(L, bc.dtype),
                            precision=jax.lax.Precision.HIGHEST)
    z = zero_state[..., -1]                                 # (..., nchunk)
    # boundary chain: y_in[i] = aC·y_in[i−1] + z[i−1], y_in[0] = y0
    if y0 is None:
        y0 = jnp.zeros(lead, dtype=b.dtype)
    else:
        y0 = jnp.broadcast_to(jnp.asarray(y0, dtype=b.dtype), lead)
    chain, _ = _first_order_assoc(jnp.asarray(aC, bc.dtype), z, y0)
    y_in = jnp.concatenate([y0[..., None], chain[..., :-1]], axis=-1)
    y = zero_state + y_in[..., None] * a_k1
    y = y.reshape(lead + (nchunk * C,))[..., :n]
    return y, y[..., -1]


def first_order(a, b, y0=None):
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` along the last axis.

    ``a`` may be a scalar (constant-coefficient one-pole) or an array
    broadcastable to ``b``. ``y0`` is the carry-in (defaults to 0).

    Returns ``(y, y_last)`` where ``y_last`` is the carry-out (``y[..., -1]``).

    O(log n)-depth associative scan over affine maps; for long captures the
    time axis is processed in fixed chunks under a ``lax.scan`` so peak
    memory stays bounded (the scan carry is the one-pole state — the same
    carry a streaming caller would thread).
    """
    b = jnp.asarray(b)
    n = b.shape[-1]
    if n == 0:
        lead = b.shape[:-1]
        y_last = (jnp.zeros(lead, dtype=b.dtype) if y0 is None else
                  jnp.broadcast_to(jnp.asarray(y0, dtype=b.dtype), lead))
        return b, y_last
    if isinstance(a, numbers.Number) or (
            isinstance(a, np.generic) and np.ndim(a) == 0):
        return _first_order_const(complex(a) if np.iscomplexobj(np.asarray(a))
                                  else float(a), b, y0)
    if n <= _CHUNK or n % _CHUNK != 0:
        return _first_order_assoc(a, b, y0)
    a_arr = jnp.broadcast_to(jnp.asarray(a, dtype=b.dtype), b.shape)
    lead = b.shape[:-1]
    nchunks = n // _CHUNK
    bc = jnp.moveaxis(b.reshape(lead + (nchunks, _CHUNK)), -2, 0)
    ac = jnp.moveaxis(a_arr.reshape(lead + (nchunks, _CHUNK)), -2, 0)
    if y0 is None:
        y0 = jnp.zeros(lead, dtype=b.dtype)
    else:
        y0 = jnp.broadcast_to(jnp.asarray(y0, dtype=b.dtype), lead)

    def step(carry, ab):
        ai, bi = ab
        y, y_last = _first_order_assoc(ai, bi, carry)
        return y_last, y

    y_last, yc = jax.lax.scan(step, y0, (ac, bc))
    y = jnp.moveaxis(yc, 0, -2).reshape(lead + (n,))
    return y, y_last


def affine2(A, B, x, s0=None):
    """Solve the 2-state recurrence ``s[n] = A @ s[n-1] + B * x[n]``.

    ``A``: (2, 2) constant matrix. ``B``: (2,) input vector. ``x``: (..., n).
    ``s0``: optional (..., 2) initial state.

    Returns ``(s, s_last)`` where ``s`` has shape (..., n, 2) and ``s[..., k, :]``
    is the state *after* absorbing ``x[..., k]``.

    Used for biquads (2nd-order IIR sections): the TDF-II state (z1, z2)
    evolves as exactly this recurrence — see orion_sdr_tpu.dsp.iir.
    """
    x = jnp.asarray(x)
    A = jnp.asarray(A, dtype=x.dtype)
    B = jnp.asarray(B, dtype=x.dtype)
    n = x.shape[-1]
    # Element n carries (A_n, b_n) with composition
    # (A2, b2) ∘ (A1, b1) = (A2 @ A1, A2 @ b1 + b2).
    As = jnp.broadcast_to(A, x.shape + (2, 2))
    bs = x[..., None] * B  # (..., n, 2)
    if s0 is not None:
        b0 = bs[..., 0, :] + jnp.einsum("ij,...j->...i", A, jnp.asarray(s0, dtype=x.dtype))
        bs = bs.at[..., 0, :].set(b0)

    def combine(l, r):
        A1, b1 = l
        A2, b2 = r
        return jnp.matmul(A2, A1), jnp.einsum("...ij,...j->...i", A2, b1) + b2

    _, s = jax.lax.associative_scan(combine, (As, bs), axis=-3)
    return s, s[..., -1, :]
