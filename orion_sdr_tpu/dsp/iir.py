"""IIR sections as parallel linear recurrences.

The reference implements biquads/cascades as per-sample TDF-II loops
(/root/reference/src/dsp/iir.rs). Here each second-order section is
decomposed by partial fractions into a complex one-pole: for the
complex-conjugate pole pair (p, p̄) of 1 + a1·z⁻¹ + a2·z⁻²,

    y = 2·Re( A · s ),   s[n] = p·s[n−1] + v[n],   A = p/(p − p̄),

where v is the 3-tap numerator FIR of x. The one-pole solves as an O(log n)
parallel prefix (dsp.recurrence.first_order) with bounded memory — identical
difference equation, whole-capture vectorized.

State pytrees: BiquadState(sp complex carry, x_tail last-2 inputs);
a cascade carries a tuple of them; the DC blocker a (..., 2) array (x1, y1).
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .recurrence import first_order


class BiquadCoefs(NamedTuple):
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def design_butter_lp(fs: float, fc: float) -> BiquadCoefs:
    """RBJ cookbook Butterworth lowpass biquad, Q = 1/√2 (ref: dsp/iir.rs:49-76)."""
    w0 = 2.0 * np.pi * fc / fs
    sin, cos = np.sin(w0), np.cos(w0)
    alpha = sin / (2.0 * np.sqrt(0.5))
    b0 = (1.0 - cos) * 0.5
    b1 = 1.0 - cos
    b2 = (1.0 - cos) * 0.5
    a0 = 1.0 + alpha
    return BiquadCoefs(b0 / a0, b1 / a0, b2 / a0, -2.0 * cos / a0, (1.0 - alpha) / a0)


def dc_pole(fs: float, cut_hz: float) -> float:
    """DC-blocker pole r (ref: dsp/dc.rs:15-22)."""
    return float(np.clip(1.0 - 2.0 * np.pi * (max(cut_hz, 0.1) / fs), 0.0, 0.9999))


class BiquadState(NamedTuple):
    sp: jnp.ndarray      # (...,) complex64 one-pole carry
    x_tail: jnp.ndarray  # (..., 2) last two inputs [x[n−2], x[n−1]]


def _pole(c: BiquadCoefs) -> complex:
    disc = c.a1 * c.a1 - 4.0 * c.a2
    if disc >= 0:
        raise ValueError("biquad fast path requires a complex-conjugate pole pair")
    return complex(-c.a1 / 2.0, np.sqrt(-disc) / 2.0)


def biquad_init(lead_shape, dtype=jnp.float32) -> BiquadState:
    return BiquadState(sp=jnp.zeros(lead_shape, jnp.complex64),
                       x_tail=jnp.zeros(lead_shape + (2,), dtype))


_BQ_CHUNK = 128   # chunk length of the real-Toeplitz fast path


@_lru_cache(maxsize=64)
def _biquad_tables(p: complex, A: complex, C: int, ko: int):
    """Trace-time constants for the real-drive chunked biquad (float64 math,
    rounded once): the combined impulse response g[d] = 2·Re(A·p^d), its
    lower-triangular Toeplitz operator, the carry picks p^(C−1−j), the
    boundary output rows ±2·(Re, Im)(A·p^(k+1)), and the last-sample state
    pick p^(ko−j) (ko = offset of the final true sample in its chunk)."""
    d = np.arange(C)
    pk = p ** d                                    # p^0 .. p^(C−1)
    g = 2.0 * np.real(A * pk)
    expo = d[None, :] - d[:, None]
    L = np.where(expo >= 0, g[np.maximum(expo, 0)], 0.0).astype(np.float32)
    tail = p ** (C - 1 - d)                        # p^(C−1−j)
    apk = A * p ** (d + 1)
    u = (2.0 * np.real(apk)).astype(np.float32)
    w = (-2.0 * np.imag(apk)).astype(np.float32)
    last = np.where(d <= ko, p ** np.maximum(ko - d, 0), 0.0)
    return (L, tail.real.astype(np.float32), tail.imag.astype(np.float32),
            u, w, complex(p ** C),
            last.real.astype(np.float32), last.imag.astype(np.float32),
            complex(p ** (ko + 1)))


def _biquad_chunked_real(v, p: complex, A: complex, s0):
    """Chunked evaluation of s[n] = p·s[n−1] + v[n], y = 2·Re(A·s) for REAL
    v: the zero-state output is one real triangular Toeplitz matmul per
    chunk (the complex one-pole form costs 4 real matmuls — v's imaginary
    part is identically zero, so the extra passes compute nothing).
    Chunk carries chain through a small complex prefix scan."""
    from .recurrence import _first_order_assoc
    C = _BQ_CHUNK
    n = v.shape[-1]
    lead = v.shape[:-1]
    nchunk = -(-n // C)
    pad = nchunk * C - n
    vp = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, pad)]) if pad else v
    vc = vp.reshape(lead + (nchunk, C))
    ko = (n - 1) % C
    L, tr, ti, u, w, pC, lr, li, pko1 = _biquad_tables(p, A, C, ko)
    hi = jax.lax.Precision.HIGHEST

    zs = jnp.matmul(vc, jnp.asarray(L), precision=hi)        # (..., nchunk, C)
    er = jnp.matmul(vc, jnp.asarray(tr), precision=hi)       # (..., nchunk)
    ei = jnp.matmul(vc, jnp.asarray(ti), precision=hi)
    z = er + 1j * ei                                         # per-chunk Σ p^(C−1−j)·v[j]
    chain, _ = _first_order_assoc(jnp.complex64(pC), z.astype(jnp.complex64),
                                  jnp.asarray(s0, jnp.complex64))
    s_in = jnp.concatenate([jnp.broadcast_to(
        jnp.asarray(s0, jnp.complex64), lead)[..., None],
        chain[..., :-1]], axis=-1)                           # carry INTO chunk
    y = (zs + s_in.real[..., None] * jnp.asarray(u)
         + s_in.imag[..., None] * jnp.asarray(w))
    y = y.reshape(lead + (nchunk * C,))[..., :n]
    # carry-out = state at the LAST TRUE sample (the padded tail would
    # otherwise keep advancing the pole with zero drive)
    v_last = vc[..., -1, :]
    s_zs = (jnp.matmul(v_last, jnp.asarray(lr), precision=hi)
            + 1j * jnp.matmul(v_last, jnp.asarray(li), precision=hi))
    s_last = s_in[..., -1] * jnp.complex64(pko1) + s_zs.astype(jnp.complex64)
    return y.astype(jnp.float32), s_last


def biquad(x, c: BiquadCoefs, state: BiquadState | None = None):
    """One second-order section over the last axis. Returns (y, state).

    Same difference equation as the reference's TDF-II loop; evaluated via
    the partial-fraction one-pole (see module docstring). Real inputs take
    the single-real-Toeplitz chunk path; complex inputs use the complex
    one-pole scan.
    """
    x = jnp.asarray(x)
    if state is None:
        state = biquad_init(x.shape[:-1], x.dtype)
    p = _pole(c)
    A = p / (p - np.conj(p))
    xp = jnp.concatenate([state.x_tail, x], axis=-1)
    v = c.b0 * xp[..., 2:] + c.b1 * xp[..., 1:-1] + c.b2 * xp[..., :-2]
    if (not jnp.iscomplexobj(x)) and abs(p) < 1.0 \
            and x.shape[-1] >= 2 * _BQ_CHUNK:
        y, s_last = _biquad_chunked_real(v.astype(jnp.float32), complex(p),
                                         complex(A), state.sp)
    else:
        s, s_last = first_order(complex(p), v.astype(jnp.complex64),
                                y0=state.sp)
        y = 2.0 * (jnp.complex64(A) * s).real
    return y.astype(x.dtype), BiquadState(sp=s_last, x_tail=xp[..., -2:])


def lp_cascade(x, c: BiquadCoefs, state=None):
    """Two cascaded identical biquads = 4th-order LR lowpass (ref: dsp/iir.rs:44-87).

    ``state``: (BiquadState, BiquadState) or None."""
    x = jnp.asarray(x)
    if state is None:
        state = (biquad_init(x.shape[:-1], x.dtype), biquad_init(x.shape[:-1], x.dtype))
    y0, s0 = biquad(x, c, state[0])
    y1, s1 = biquad(y0, c, state[1])
    return y1, (s0, s1)


def dc_blocker(x, r: float, state=None):
    """y[n] = x[n] − x[n−1] + r·y[n−1] (ref: dsp/dc.rs). Returns (y, state).

    state = (x1, y1) packed in a (..., 2) array.
    """
    x = jnp.asarray(x)
    if state is None:
        state = jnp.zeros(x.shape[:-1] + (2,), dtype=x.dtype)
    if x.shape[-1] == 0:
        return x, state
    x1, y1 = state[..., 0], state[..., 1]
    xprev = jnp.concatenate([x1[..., None], x[..., :-1]], axis=-1)
    v = x - xprev
    y, y_last = first_order(float(r), v, y0=y1)
    return y, jnp.stack([x[..., -1], y_last], axis=-1)


class LpDcState(NamedTuple):
    bq: tuple            # (BiquadState, BiquadState)
    dc: jnp.ndarray      # (..., 2) dc blocker state


def lp_dc_init(lead_shape, dtype=jnp.float32) -> LpDcState:
    return LpDcState(bq=(biquad_init(lead_shape, dtype), biquad_init(lead_shape, dtype)),
                     dc=jnp.zeros(lead_shape + (2,), dtype))


def lp_dc_cascade(x, c: BiquadCoefs, r: float, state: LpDcState | None = None, map_fn=None):
    """Fused LP4 + optional elementwise map + DC blocker (ref: dsp/iir.rs:90-187).

    ``map_fn`` (e.g. sqrt for AM-PowerSqrt) sits between the LP and the DC
    blocker — all three stages stay whole-capture vectorized because the
    nonlinearity sits *between* two linear recurrences.
    """
    x = jnp.asarray(x)
    if state is None:
        state = lp_dc_init(x.shape[:-1], x.dtype)
    y, bq_state = lp_cascade(x, c, state.bq)
    if map_fn is not None:
        y = map_fn(y)
    y, dc_state = dc_blocker(y, r, state.dc)
    return y, LpDcState(bq=bq_state, dc=dc_state)
