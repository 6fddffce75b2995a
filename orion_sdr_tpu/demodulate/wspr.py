"""WSPR beacon receiver (wire-compatible — codec/wspr.py): joint coarse
time/frequency search on the published sync chips, then per-symbol 4-tone
energies → sequential decode.

Design: the WHOLE search grid's tone energies come from one batched
program — mix the capture by each frequency candidate, slice each time
candidate's 162-symbol window, and correlate every symbol against the 4
tone phasors as one einsum."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.device import cjit
from ..dsp.osc import TAU
from ..codec.wspr import (WSPR_SYMBOLS, WSPR_SPS, WSPR_FS, WSPR_SYNC,
                          wspr_decode_symbols, WsprMessage)


@cjit
def _energy_grid(re, im, dts, dfs, fs: float, base_hz: float):
    """(n,) capture → (F, D, 162, 4) tone energies for every (df, dt).

    Gather-free (round 4: the old per-(df, dt) fancy-index gathered
    162×8192 elements 63 times — ~129 ms on chip): ``dts`` are STATIC
    eighth-symbol-aligned offsets (a tuple — cjit treats non-arrays as
    static). The capture decomposes into eighth-symbol blocks, per-block
    tone correlations come from one einsum per df, window correlations
    are 8 static shifted adds, and every (dt, symbol) energy is a static
    strided slice. Samples outside the capture read as zeros (the old
    path clamped to the edge sample — both are edge garbage in a sync
    metric)."""
    z = re + 1j * im
    n = z.shape[-1]
    nb = WSPR_SPS // 8
    dts = tuple(int(d) for d in dts)
    if any(d % nb for d in dts):
        raise ValueError("dt offsets must be eighth-symbol aligned")
    need = WSPR_SYMBOLS * WSPR_SPS
    pad_front = max(0, -min(dts))
    total = max(dts) + pad_front + need
    total = max(total, n + pad_front)
    total = -(-total // nb) * nb
    zp = jnp.pad(z, (pad_front, total - n - pad_front))
    nq = total // nb
    q = zp.reshape(nq, nb)
    k = jnp.arange(nb, dtype=jnp.float32)
    df_tone = fs / WSPR_SPS
    f_tone = (jnp.float32(base_hz)
              + jnp.arange(4, dtype=jnp.float32) * df_tone)     # (4,)
    tones = jnp.exp(-1j * jnp.float32(TAU / fs)
                    * f_tone[:, None] * k[None, :])             # (4, nb)
    b_time = (jnp.arange(nq, dtype=jnp.float32) * nb
              - jnp.float32(pad_front))                         # block t0

    def for_df(df):
        w = jnp.exp(-1j * jnp.float32(TAU / fs) * df * k)
        c = jnp.einsum("qk,tk->qt", q, tones * w[None, :])      # (nq, 4)
        # df wipe at block start (constant global phase per df drops in
        # the magnitude)
        return c * jnp.exp(-1j * jnp.float32(TAU / fs)
                           * df * b_time)[:, None]

    C = jax.vmap(for_df)(jnp.asarray(dfs, jnp.float32))         # (F, nq, 4)
    # tone phase advance of block j within its window
    pj = jnp.exp(-1j * jnp.float32(TAU / fs) * f_tone[None, :]
                 * (jnp.arange(8, dtype=jnp.float32)[:, None] * nb))
    M = nq - 7
    corr = sum(C[:, j: j + M, :] * pj[j][None, None, :]
               for j in range(8))                               # (F, M, 4)
    outs = []
    for dt in dts:
        m0 = (dt + pad_front) // nb
        sl = corr[:, m0: m0 + 8 * WSPR_SYMBOLS: 8, :]           # (F, 162, 4)
        outs.append((jnp.abs(sl) ** 2).astype(jnp.float32))
    return jnp.stack(outs, axis=1)                              # (F, D, ...)


def wspr_demod(iq, fs: float = WSPR_FS, base_hz: float = 1500.0,
               dt_max: int = 2 * WSPR_SPS,
               df_max_hz: float = 1.6) -> Optional[WsprMessage]:
    """Capture → message | None. Searches start offsets up to ``dt_max``
    samples and CFO up to ±``df_max_hz`` (quarter-tone steps)."""
    z = np.asarray(iq, np.complex64)
    if len(z) < WSPR_SYMBOLS * WSPR_SPS:
        return None
    df_step = fs / WSPR_SPS / 4.0
    dfs = np.arange(-df_max_hz, df_max_hz + 1e-9, df_step).astype(np.float32)
    dts = np.arange(0, max(dt_max, 1), WSPR_SPS // 4).astype(np.int32)
    dts = dts[dts + WSPR_SYMBOLS * WSPR_SPS <= len(z)]
    if dts.size == 0:
        dts = np.zeros(1, np.int32)
    eg = np.asarray(_energy_grid(
        np.ascontiguousarray(z.real, np.float32),
        np.ascontiguousarray(z.imag, np.float32),
        tuple(int(d) for d in dts), dfs, float(fs), float(base_hz)))
    # sync score: energy in the two sync-consistent tones minus the rest
    s = WSPR_SYNC.astype(np.int64)
    i162 = np.arange(WSPR_SYMBOLS)
    insync = eg[..., i162, s] + eg[..., i162, s + 2]
    total = eg.sum(axis=-1)
    score = (insync - (total - insync)).sum(axis=-1)
    fi, di = np.unravel_index(np.argmax(score), score.shape)
    return wspr_decode_symbols(eg[fi, di])


@cjit
def _spectrogram(re, im, n_hops: int, hop: int):
    """Quarter-symbol-hopped symbol-length FFTs: bin spacing = the tone
    spacing exactly, so every (time, frequency) sync candidate in the
    whole band reads straight out of one program's output.

    Gather-free when the hop divides the symbol (it does at the call
    site): decompose into hop-length blocks and build every window from
    ``sps // hop`` static row slices."""
    z = re + 1j * im
    r = WSPR_SPS // hop
    if r * hop == WSPR_SPS:
        nq = n_hops + r - 1
        zq = z[: nq * hop].reshape(nq, hop)
        segs = jnp.concatenate(
            [zq[j: j + n_hops] for j in range(r)], axis=-1)
    else:                                   # non-divisor hop: old gather
        idx = (jnp.arange(n_hops)[:, None] * hop
               + jnp.arange(WSPR_SPS)[None, :])
        segs = z[idx]
    spec = jnp.fft.fft(segs, axis=-1)
    return (jnp.abs(spec) ** 2).astype(jnp.float32)


def wspr_decode_band(iq, fs: float = WSPR_FS, base_hz: float = 1400.0,
                     width_hz: float = 200.0, max_decodes: int = 8,
                     min_score_sigma: float = 5.0) -> List[WsprMessage]:
    """Decode EVERY beacon in a band (the real WSPR band is 200 Hz wide):
    one spectrogram program covers all (time, frequency) candidates, the
    known sync chips score each, and the top distinct candidates decode
    through the stack decoder. Mirrors the FT8 batched-window design."""
    z = np.asarray(iq, np.complex64)
    hop = WSPR_SPS // 4
    n_hops = (len(z) - WSPR_SPS) // hop + 1
    if n_hops < 4 * WSPR_SYMBOLS:
        return []
    spec = np.asarray(_spectrogram(
        np.ascontiguousarray(z.real, np.float32),
        np.ascontiguousarray(z.imag, np.float32), int(n_hops), hop))
    df = fs / WSPR_SPS
    b0 = int(round(base_hz / df))
    nb = int(round(width_hz / df))
    s = WSPR_SYNC.astype(np.int64)
    i4 = np.arange(WSPR_SYMBOLS) * 4
    n_t0 = n_hops - 4 * WSPR_SYMBOLS + 1
    # the whole (t0, b) sync-score grid in one vectorized gather —
    # in-sync tones are {s, s+2}, the other two {1−s, 3−s}
    trow = np.arange(n_t0)[:, None, None] + i4[None, None, :]  # (n_t0,1,162)
    bcol = b0 + np.arange(nb)[None, :, None]                   # (1,nb,1)
    insync = spec[trow, bcol + s[None, None, :]] \
        + spec[trow, bcol + s[None, None, :] + 2]
    other = spec[trow, bcol + (1 - s)[None, None, :]] \
        + spec[trow, bcol + (3 - s)[None, None, :]]
    scores = (insync - other).sum(axis=-1).astype(np.float32)
    mu = float(np.median(scores))
    sd = float(np.median(np.abs(scores - mu))) * 1.4826 + 1e-12
    out: List[WsprMessage] = []
    work = scores.copy()
    for _ in range(4 * max_decodes):
        t0, b = np.unravel_index(int(np.argmax(work)), work.shape)
        if (work[t0, b] - mu) / sd < min_score_sigma:
            break
        # suppress the whole peak plateau (a strong beacon spans many
        # adjacent time/frequency cells) whether or not it decodes
        work[max(t0 - 8, 0): t0 + 9, max(b - 4, 0): b + 5] = -np.inf
        rows = spec[t0 + i4]
        e = np.stack([rows[np.arange(WSPR_SYMBOLS), b0 + b + k]
                      for k in range(4)], axis=-1)
        m = wspr_decode_symbols(e)
        if m is not None:
            out.append(m)
        if len(out) >= max_decodes:
            break
    return out
