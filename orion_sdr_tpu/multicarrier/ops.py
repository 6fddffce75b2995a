"""Whole-frame multicarrier ops: grid map/extract, IFFT/CP, symbol window/FFT.

The reference processes one symbol per call through Block objects
(/root/reference/src/multicarrier/{grid,fft,cyclic_prefix,symbol_window,
symbol_fft}.rs). Here a frame of N symbols is a single batched tensor op:
scatter → ifft → CP concat → taper is one fused XLA graph over
``(..., n_symbols, n_fft)`` — the batched formulation.

FFT conventions match the reference (docs/ofdm.md:22-35): unity forward,
1/N-folded inverse (numpy's default), natural bin order internally.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit

from .plan import CarrierGrid


@cjit
def grid_map(grid: CarrierGrid, data_symbols, pilot_bins=None, pilot_values=None):
    """Scatter dense data symbols into sparse FFT bins (ref: grid.rs:103-155).

    ``data_symbols``: (..., n_sym, n_data) complex64 →
    returns (..., n_sym, n_fft) with nulls zeroed and pilots inserted.
    ``pilot_bins/values`` override the grid's static pilots (used by
    scattered-pilot waveforms where pilots rotate per symbol — pass arrays
    shaped (n_sym, n_pilots) or (n_pilots,)).
    """
    d = jnp.asarray(data_symbols).astype(jnp.complex64)
    pb = grid.pilot_bins if pilot_bins is None else pilot_bins
    pv = grid.pilot_values if pilot_values is None else pilot_values
    n_data = d.shape[-1]

    if isinstance(pb, np.ndarray) or pb is None or isinstance(pb, (list, tuple)):
        # Static pilot layout → ONE static gather instead of an at[].set
        # scatter chain. Each FFT
        # bin reads from concat([data, pilots, 0]): nulls read the trailing
        # zero slot, so the whole map is a take with a compile-time index.
        pb = np.asarray(pb, dtype=np.int64) if pb is not None and np.size(pb) \
            else np.zeros((0,), np.int64)
        n_pil = pb.shape[-1] if pb.size else 0
        pvj = jnp.broadcast_to(jnp.asarray(pv, jnp.complex64),
                               d.shape[:-1] + (n_pil,)) if n_pil else \
            jnp.zeros(d.shape[:-1] + (0,), jnp.complex64)
        src = jnp.concatenate(
            [d, pvj, jnp.zeros(d.shape[:-1] + (1,), jnp.complex64)], axis=-1)
        zero_slot = n_data + n_pil
        if pb.ndim <= 1:
            idx = np.full(grid.n_fft, zero_slot, np.int32)
            idx[grid.data_bins] = np.arange(n_data, dtype=np.int32)
            if n_pil:
                idx[pb] = n_data + np.arange(n_pil, dtype=np.int32)
            return src[..., idx]
        # per-symbol pilot layout (scattered pilots): pb (n_sym, n_pilots)
        n_sym = pb.shape[0]
        idx = np.full((n_sym, grid.n_fft), zero_slot, np.int32)
        idx[:, grid.data_bins] = np.arange(n_data, dtype=np.int32)
        np.put_along_axis(idx, pb.astype(np.int64),
                          n_data + np.arange(n_pil, dtype=np.int32), axis=-1)
        idxj = jnp.broadcast_to(jnp.asarray(idx),
                                d.shape[:-2] + (n_sym, grid.n_fft))
        return jnp.take_along_axis(src, idxj, axis=-1)

    # Runtime-traced pilot bins: scatter fallback (rare path).
    out = jnp.zeros(d.shape[:-1] + (grid.n_fft,), dtype=jnp.complex64)
    out = out.at[..., grid.data_bins].set(d)
    if np.size(pb):
        pb = jnp.asarray(pb)
        pv = jnp.asarray(pv, dtype=jnp.complex64)
        if pb.ndim == 1:
            out = out.at[..., pb].set(pv)
        else:
            # per-symbol pilot layout (scattered pilots): pb (n_sym, n_pilots)
            sym_idx = jnp.arange(out.shape[-2])[:, None]
            out = out.at[..., sym_idx, pb].set(jnp.broadcast_to(pv, pb.shape))
    return out


@cjit
def map_bits_grid(grid: CarrierGrid, bits, order: str):
    """Fused constellation map + grid placement: bits → (..., n_sym, n_fft).

    Equivalent to ``grid_map(grid, map_bits(bits, order).reshape(...))`` for
    the grid's own static pilot layout, but with no pair-deinterleave:
    ``map_bits``'s reshape to a minor axis of ``bits_per_symbol`` is a
    layout change of the whole bit stream (its cost on the H100 is not
    measured). Here the Gray amplitude is computed
    IN PLACE on the interleaved bit stream (Gray PAM amplitude =
    ±s·Σᵢ 2^(k−1−i)·Pᵢ with Pᵢ = 1−2·prefix-XOR of the axis bits — the
    prefix XORs are masked lane shifts), the per-point axis sums are k−1
    more lane shifts, and the I/Q split happens inside the SAME static
    gather that places data bins into the FFT grid (group starts at flat
    positions j·2k and j·2k+k). Pilots land as one constant-plane add.

    ``bits``: (..., n_sym·bits_per_symbol(order)·n_data) integer bits.
    Behavioral spec: ref modulate/{bpsk,qpsk,qam}.rs + grid.rs:103-155.
    """
    from ..constellation import BITS_PER_SYMBOL, axis_scale

    bits = jnp.asarray(bits)
    nd = grid.num_data_carriers
    bps = BITS_PER_SYMBOL[order]
    spb = bps * nd
    n_sym = bits.shape[-1] // spb
    if n_sym * spb != bits.shape[-1]:
        raise ValueError("bits length must be a whole number of OFDM symbols")
    L = n_sym * spb
    b = (bits & 1).astype(jnp.float32)

    pos = np.arange(L)
    if order == "bpsk":
        S = 1.0 - 2.0 * b                       # ±1, one bit per point
        k = 0
    elif order == "qpsk":
        # qpsk keeps the reference's own sign convention (bit 0 → +s)
        S = np.float32(1.0 / np.sqrt(2.0)) * (1.0 - 2.0 * b)
        k = 1
    else:
        k = bps // 2
        t = b
        for d in range(1, k):
            mask = ((pos % k) >= d).astype(np.float32)
            # prefix XOR on ±-free floats: a ⊕ c = a + c − 2ac
            sh = jnp.roll(b, d, axis=-1) * mask
            t = t + sh - 2.0 * t * sh
        w = (-axis_scale(bps) * 2.0 ** (k - 1 - (pos % k))).astype(np.float32)
        contrib = w * (1.0 - 2.0 * t)
        S = contrib
        for d in range(1, k):
            S = S + jnp.roll(contrib, -d, axis=-1)

    v = S.reshape(S.shape[:-1] + (n_sym, spb))
    v = jnp.concatenate([v, jnp.zeros(v.shape[:-1] + (1,), jnp.float32)], -1)
    group = max(k, 1) * 2 if order != "bpsk" else 1
    idx_re = np.full(grid.n_fft, spb, np.int32)
    idx_im = np.full(grid.n_fft, spb, np.int32)
    j = np.arange(nd, dtype=np.int32)
    idx_re[grid.data_bins] = group * j
    if order != "bpsk":
        idx_im[grid.data_bins] = group * j + max(k, 1)
    freq = (v[..., idx_re] + 1j * v[..., idx_im]).astype(jnp.complex64)
    if np.size(grid.pilot_bins):
        plane = np.zeros(grid.n_fft, np.complex64)
        plane[grid.pilot_bins] = grid.pilot_values
        freq = freq + jnp.asarray(plane)
    return freq


# XOR of three prefix terms above is associative and mask-safe: a roll that
# wraps across the symbol/point boundary only lands where (pos % k) < d, so
# the mask zeroes exactly the wrapped lanes.


@cjit
def grid_extract(grid: CarrierGrid, freq_symbols):
    """Gather data bins back to a dense stream (ref: grid.rs:157-192).

    (..., n_sym, n_fft) → (..., n_sym, n_data)."""
    return jnp.asarray(freq_symbols)[..., grid.data_bins]


@cjit
def ofdm_assemble(freq_grid, cp_len: int, taper=None):
    """IFFT + cyclic-prefix insert + optional per-symbol edge taper.

    ``freq_grid``: (..., n_sym, n_fft) → time (..., n_sym*(n_fft+cp_len)).
    Equivalent of IfftBlock + CyclicPrefixInsert + SymbolWindow
    (ref: multicarrier/fft.rs:62, cyclic_prefix.rs:16, symbol_window.rs:40-130).
    """
    x = jnp.fft.ifft(jnp.asarray(freq_grid), axis=-1).astype(jnp.complex64)
    if cp_len > 0:
        x = jnp.concatenate([x[..., -cp_len:], x], axis=-1)
    if taper is not None:
        x = x * taper
    return x.reshape(x.shape[:-2] + (-1,))


def symbol_taper(symbol_len: int, roll_off: int) -> np.ndarray | None:
    """Raised-cosine (Tukey) edge taper table (ref: symbol_window.rs:63-84).

    ramp[i] = 0.5·(1 − cos(π(i+0.5)/L)); applied to the first and last
    ``roll_off`` samples of each symbol. Returns None when roll_off == 0.
    """
    roll_off = min(roll_off, symbol_len // 2)
    if roll_off == 0:
        return None
    w = np.ones(symbol_len, dtype=np.float32)
    i = np.arange(roll_off)
    ramp = 0.5 * (1.0 - np.cos(np.pi * (i + 0.5) / roll_off))
    w[:roll_off] = ramp
    w[symbol_len - 1 - i] = ramp
    return w


@cjit
def symbol_fft(time_stream, n_fft: int, cp_len: int, backoff: int = 0, n_symbols=None):
    """RX window-select + FFT over whole frames (ref: symbol_fft.rs:38-160).

    ``time_stream``: (..., ≥ n_sym·(n_fft+cp_len)). The FFT window within each
    symbol starts at ``cp_len − backoff`` (backoff clamped to cp_len) — the one
    place the window position is chosen. Returns (..., n_sym, n_fft).
    """
    x = jnp.asarray(time_stream)
    sym_len = n_fft + cp_len
    backoff = min(backoff, cp_len)
    if n_symbols is None:
        n_symbols = x.shape[-1] // sym_len
    x = x[..., : n_symbols * sym_len].reshape(x.shape[:-1] + (n_symbols, sym_len))
    start = cp_len - backoff
    win = x[..., start:start + n_fft]
    return jnp.fft.fft(win, axis=-1).astype(jnp.complex64)


def max_pilot_safe_backoff(n_fft: int, pilot_spacing: int) -> int:
    """b < n_fft/(2·spacing): beyond it pilot interpolation aliases
    (ref: symbol_fft.rs:120-141)."""
    return n_fft // (2 * max(pilot_spacing, 1))
