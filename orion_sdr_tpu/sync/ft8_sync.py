"""FT8/FT4 sync + soft LLR extraction (behavioral spec: sync/ft8_sync.rs,
sync/ft4_sync.rs).

Waterfall (one matmul) → Costas candidate search (vectorized shifted-sum
grid + top-k) → per-candidate max-log LLRs from Gray-reordered per-tone
log-energies, normalized by √(24/var). All candidates' LLRs are gathered in
one vectorized indexing pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .waterfall import compute_waterfall
from .costas import Candidate, candidate_score_grid, find_candidates
from ..dsp.device import cjit
from ..modulate.ft8 import (
    FT8_COSTAS, FT8_SYNC_POS, FT8_TONE_SPACING_HZ, FT8_SAMPLES_PER_SYM,
    FT8_TOTAL_SYMS, FT8_TONES, ft8_data_positions,
    FT4_COSTAS, FT4_SYNC_POS, FT4_TONE_SPACING_HZ, FT4_SAMPLES_PER_SYM,
    FT4_TOTAL_SYMS, FT4_TONES, ft4_data_positions,
)
from ..codec.gray import FT8_GRAY, FT4_GRAY

_N = 174


@dataclass
class FtSyncResult:
    """(ref Ft8SyncResult / Ft4SyncResult)"""
    time_sym: int
    freq_bin: int
    score: float
    llr: np.ndarray      # (174,) float32, positive ⇒ bit 0


def _normalise_llr(llr: np.ndarray) -> np.ndarray:
    """scale = √(24/var) — prevents LDPC saturation (ref normalise_llr)."""
    var = float(np.mean(llr * llr, axis=-1))
    if var > 1e-10:
        llr = llr * np.sqrt(24.0 / var)
    return llr.astype(np.float32)


def _extract_llrs(wf: np.ndarray, cands, data_pos: np.ndarray,
                  gray: np.ndarray, bits_per_sym: int) -> List[np.ndarray]:
    """Max-log LLRs for every candidate in one gather.

    s2[j] = log-energy of tone gray[j] (energy indexed by binary value);
    bit b's LLR = max over values with bit b set − max with bit b clear,
    negated into the positive ⇒ bit 0 convention.
    """
    S, B = wf.shape
    n_tones = len(gray)
    out = []
    for c in cands:
        syms = c.time_sym + data_pos                        # (n_data,)
        bins = c.freq_bin + gray.astype(np.int64)           # (n_tones,)
        valid = (syms >= 0) & (syms < S)
        ok = valid[:, None] & (bins < B)[None, :]
        g = wf[np.clip(syms, 0, S - 1)[:, None], np.clip(bins, 0, B - 1)[None, :]]
        s2 = np.where(ok, g, -1.0e30).astype(np.float32)
        llr = np.zeros(len(data_pos) * bits_per_sym, np.float32)
        vals = np.arange(n_tones)
        for b in range(bits_per_sym):
            bit_mask = (vals >> (bits_per_sym - 1 - b)) & 1
            hi = np.max(s2[:, bit_mask == 1], axis=1)
            lo = np.max(s2[:, bit_mask == 0], axis=1)
            # missing symbols → zero LLR (maximum uncertainty)
            llr[b::bits_per_sym] = np.where(valid, -(hi - lo), 0.0)
        out.append(_normalise_llr(llr))
    return out


def _sync(iq, fs, base_hz, max_hz, t_min, t_max, max_cand, *, spacing, sps,
          total_syms, n_tones, costas, sync_pos, data_pos, bits_per_sym
          ) -> List[FtSyncResult]:
    freq_range = max(max_hz - base_hz, 0.0)
    num_bins = int(np.ceil(freq_range / spacing)) + n_tones + 1
    wf_syms = max(t_max + total_syms - t_min, 1)
    wf_sample_start = t_min * sps if t_min >= 0 else 0
    sym_offset_adj = -t_min if t_min < 0 else 0

    wf = np.asarray(compute_waterfall(iq, fs, base_hz, spacing, sps,
                                      wf_syms, num_bins, wf_sample_start))
    wf_t_max = max(wf_syms - total_syms, 0)
    cands = find_candidates(wf, costas, list(sync_pos), n_tones,
                            0, wf_t_max, max_cand)
    llrs = _extract_llrs(wf, cands, data_pos, gray=np.asarray(
        FT8_GRAY if n_tones == 8 else FT4_GRAY), bits_per_sym=bits_per_sym)
    return [FtSyncResult(time_sym=c.time_sym - sym_offset_adj,
                         freq_bin=c.freq_bin, score=c.score, llr=l)
            for c, l in zip(cands, llrs)]


_MODE = {
    "ft8": dict(spacing=FT8_TONE_SPACING_HZ, sps=FT8_SAMPLES_PER_SYM,
                total_syms=FT8_TOTAL_SYMS, n_tones=FT8_TONES,
                bits_per_sym=3),
    "ft4": dict(spacing=FT4_TONE_SPACING_HZ, sps=FT4_SAMPLES_PER_SYM,
                total_syms=FT4_TOTAL_SYMS, n_tones=FT4_TONES,
                bits_per_sym=2),
}


def _mode_tables(mode: str):
    if mode == "ft8":
        return (FT8_COSTAS, [s for s, _ in FT8_SYNC_POS],
                ft8_data_positions(), np.asarray(FT8_GRAY))
    return (FT4_COSTAS, [s for s, _ in FT4_SYNC_POS],
            ft4_data_positions(), np.asarray(FT4_GRAY))


@cjit
def _sync_grid_device(iq, fs: float, base_hz: float, mode: str,
                      num_bins: int, wf_syms: int, wf_sample_start: int,
                      wf_t_max: int, k: int):
    """Waterfall + Costas score grid + top-k for (possibly batched) windows
    as ONE fused device program — the many-window receive path pays one
    device call for the whole batch instead of two per window."""
    m = _MODE[mode]
    costas, sync_pos, _, _ = _mode_tables(mode)
    wf = compute_waterfall(iq, fs, base_hz, m["spacing"], m["sps"],
                           wf_syms, num_bins, wf_sample_start)
    score = candidate_score_grid(wf, costas, sync_pos, m["n_tones"],
                                 0, wf_t_max)
    flat = score.reshape(score.shape[:-2] + (-1,))
    import jax
    vals, idx = jax.lax.top_k(flat, k)
    return wf, vals, idx


def _sync_batch(iq_batch, fs, base_hz, max_hz, max_cand, mode: str
                ) -> List[List[FtSyncResult]]:
    """Batched _sync over (B, n) windows (t_min = t_max = 0)."""
    m = _MODE[mode]
    _, _, data_pos, gray = _mode_tables(mode)
    iq_batch = np.asarray(iq_batch)
    assert iq_batch.ndim == 2
    if iq_batch.shape[0] == 0:
        return []
    freq_range = max(max_hz - base_hz, 0.0)
    num_bins = int(np.ceil(freq_range / m["spacing"])) + m["n_tones"] + 1
    wf_syms = m["total_syms"]
    wf_t_max = 0
    f_count = num_bins - m["n_tones"] + 1
    if f_count <= 0:
        return [[] for _ in range(len(iq_batch))]
    k = min(max(int(max_cand), 1), f_count)

    wf, vals, idx = _sync_grid_device(iq_batch, float(fs), float(base_hz),
                                      mode, num_bins, wf_syms, 0,
                                      wf_t_max, k)
    wf, vals, idx = np.asarray(wf), np.asarray(vals), np.asarray(idx)
    out: List[List[FtSyncResult]] = []
    for b in range(len(iq_batch)):
        cands = [Candidate(time_sym=int(i // f_count), freq_bin=int(i % f_count),
                           score=float(v))
                 for v, i in zip(vals[b], idx[b])]
        llrs = _extract_llrs(wf[b], cands, data_pos, gray=gray,
                             bits_per_sym=m["bits_per_sym"])
        out.append([FtSyncResult(time_sym=c.time_sym, freq_bin=c.freq_bin,
                                 score=c.score, llr=l)
                    for c, l in zip(cands, llrs)])
    return out


def ft8_sync_batch(windows, fs: float, base_hz: float, max_hz: float,
                   max_cand: int = 4) -> List[List[FtSyncResult]]:
    """ft8_sync over (B, n) receive windows in one device program."""
    return _sync_batch(windows, fs, base_hz, max_hz, max_cand, "ft8")


def ft4_sync_batch(windows, fs: float, base_hz: float, max_hz: float,
                   max_cand: int = 4) -> List[List[FtSyncResult]]:
    """ft4_sync over (B, n) receive windows in one device program."""
    return _sync_batch(windows, fs, base_hz, max_hz, max_cand, "ft4")


def ft8_sync(iq, fs: float, base_hz: float, max_hz: float,
             t_min: int = 0, t_max: int = 0, max_cand: int = 4
             ) -> List[FtSyncResult]:
    """Search an IQ buffer for FT8 frames; top candidates with 174 LLRs."""
    sync_pos = [s for s, _ in FT8_SYNC_POS]
    return _sync(iq, fs, base_hz, max_hz, t_min, t_max, max_cand,
                 spacing=FT8_TONE_SPACING_HZ, sps=FT8_SAMPLES_PER_SYM,
                 total_syms=FT8_TOTAL_SYMS, n_tones=FT8_TONES,
                 costas=FT8_COSTAS, sync_pos=sync_pos,
                 data_pos=ft8_data_positions(), bits_per_sym=3)


def ft4_sync(iq, fs: float, base_hz: float, max_hz: float,
             t_min: int = 0, t_max: int = 0, max_cand: int = 4
             ) -> List[FtSyncResult]:
    """Search an IQ buffer for FT4 frames; top candidates with 174 LLRs."""
    sync_pos = [s for s, _ in FT4_SYNC_POS]
    return _sync(iq, fs, base_hz, max_hz, t_min, t_max, max_cand,
                 spacing=FT4_TONE_SPACING_HZ, sps=FT4_SAMPLES_PER_SYM,
                 total_syms=FT4_TOTAL_SYMS, n_tones=FT4_TONES,
                 costas=FT4_COSTAS, sync_pos=sync_pos,
                 data_pos=ft4_data_positions(), bits_per_sym=2)


@cjit
def _multi_sync_grid_device(frames, fs: float, base_hz: float, mode: str,
                            num_bins: int, k: int):
    """Waterfalls for N repeated transmissions + the SUMMED Costas score
    grid's top-k, one fused device program. Summing the per-frame score
    grids before candidate selection buys ~√N of sync sensitivity — the
    multi-frame averaging front half (WSJT-X's a-priori averaging idea,
    beyond the single-frame reference)."""
    import jax
    import jax.numpy as jnp
    m = _MODE[mode]
    costas, sync_pos, _, _ = _mode_tables(mode)
    wf = compute_waterfall(frames, fs, base_hz, m["spacing"], m["sps"],
                           m["total_syms"], num_bins, 0)        # (N, S, B)
    score = candidate_score_grid(wf, costas, sync_pos, m["n_tones"], 0, 0)
    ssum = jnp.sum(score, axis=0)
    vals, idx = jax.lax.top_k(ssum.reshape(-1), k)
    return wf, vals, idx


def ft_sync_multi(frames, fs: float, base_hz: float, max_hz: float,
                  max_cand: int, mode: str
                  ) -> List[FtSyncResult]:
    """Multi-frame sync: N frame-aligned captures of the SAME repeated
    transmission → candidates from the summed score grid, each carrying
    the SUM of the per-frame LLRs (joint log-likelihood of N independent
    observations, ~10·log10(N) dB of combining gain before the LDPC).
    """
    m = _MODE[mode]
    _, _, data_pos, gray = _mode_tables(mode)
    frames = np.asarray(frames)
    assert frames.ndim == 2, "frames: (n_frames, frame_len)"
    freq_range = max(max_hz - base_hz, 0.0)
    num_bins = int(np.ceil(freq_range / m["spacing"])) + m["n_tones"] + 1
    f_count = num_bins - m["n_tones"] + 1
    if f_count <= 0 or len(frames) == 0:
        return []
    k = min(max(int(max_cand), 1), f_count)
    wf, vals, idx = _multi_sync_grid_device(frames, float(fs),
                                            float(base_hz), mode,
                                            num_bins, k)
    wf, vals, idx = np.asarray(wf), np.asarray(vals), np.asarray(idx)
    cands = [Candidate(time_sym=int(i // f_count), freq_bin=int(i % f_count),
                       score=float(v)) for v, i in zip(vals, idx)]
    out = []
    for c in cands:
        llr_sum = None
        for b in range(len(frames)):
            llr = _extract_llrs(wf[b], [c], data_pos, gray=gray,
                                bits_per_sym=m["bits_per_sym"])[0]
            llr_sum = llr if llr_sum is None else llr_sum + llr
        out.append(FtSyncResult(time_sym=c.time_sym, freq_bin=c.freq_bin,
                                score=c.score,
                                llr=_normalise_llr(llr_sum)))
    return out
