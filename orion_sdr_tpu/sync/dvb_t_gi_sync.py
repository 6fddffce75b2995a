"""DVB-T guard-interval acquisition + integer CFO (behavioral spec:
sync/dvb_t_gi_sync.rs — van de Beek ML over the cyclic prefix).

Design: the reference recomputes a (search_len × cp_len × max_syms)
correlation per offset; here the lag-n_fft product and energy are computed
once for the whole buffer and every offset's γ/Φ is a cumulative-sum sliding
window (O(len)), with the multi-symbol coherent accumulation a few shifted
adds. Metric/argmax/unwrap run on device arrays; the origin-unwrap guard is
a two-candidate host decision, exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..waveform.dvb_t import continual_pilot_bins
from ..dsp.device import cjit


@dataclass(frozen=True)
class GiSyncConfig:
    """ρ = SNR/(SNR+1) weight; coherent accumulation bound; unwrap guard
    (ref GiSyncConfig, dvb_t_gi_sync.rs:58-127)."""
    rho: float = 0.95
    max_symbols: int = 4
    origin_score_ratio: float = 0.5


class GiSyncResult(NamedTuple):
    start_sample: int
    cfo_hz: float
    score: float      # |γ|/Φ ∈ [0,1] at the winner (selection used |γ|−ρΦ)


def _sliding(x, win: int):
    c = jnp.cumsum(x, axis=-1)
    zero = jnp.zeros(x.shape[:-1] + (1,), c.dtype)
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., win:] - c[..., :-win]


def _gamma_phi(iq, n_fft: int, cp_len: int):
    """Single-symbol γ(d), Φ(d) for every valid offset d (vectorized)."""
    z = jnp.asarray(iq)
    a = z[..., : z.shape[-1] - n_fft]
    b = z[..., n_fft:]
    c = a * jnp.conj(b)
    e = jnp.abs(a) ** 2 + jnp.abs(b) ** 2
    gamma = _sliding(c, cp_len)
    phi = 0.5 * _sliding(e, cp_len)
    return gamma, phi          # valid for d ≤ len − n_fft − cp_len


@cjit
def _gi_metrics(iq, n_fft: int, cp_len: int, search_len: int,
                rho: float, max_syms: int):
    """Whole acquisition decision on device; only scalars cross back.

    Returns (argmax of the accumulated ML metric, per-offset single-symbol
    score at argmax and at its period origin, γ at both) — everything the
    host-side unwrap rule needs, so the full γ/Φ vectors stay on the
    device.
    """
    g1, p1 = _gamma_phi(iq, n_fft, cp_len)
    n_valid = g1.shape[-1]
    period = n_fft + cp_len
    d = jnp.arange(search_len)
    gamma = jnp.zeros(search_len, jnp.complex64)
    phi = jnp.zeros(search_len, jnp.float32)
    for s in range(max_syms):
        idx = d + s * period
        ok = idx <= n_valid - cp_len
        safe = jnp.clip(idx, 0, n_valid - 1)
        gamma = gamma + jnp.where(ok, g1[safe], 0)
        phi = phi + jnp.where(ok, p1[safe], 0.0)
    metric = jnp.abs(gamma) - rho * phi
    argmax = jnp.argmax(metric).astype(jnp.int32)
    origin = argmax - argmax % period

    def single_score(dd):
        ok = dd <= n_valid - cp_len
        dd = jnp.clip(dd, 0, n_valid - 1)
        p = p1[dd]
        sc = jnp.where(p > 0, jnp.minimum(jnp.abs(g1[dd]) / p, 1.0), 0.0)
        return jnp.where(ok, sc, 0.0)

    return (argmax, single_score(argmax), single_score(origin),
            gamma[argmax], phi[argmax], gamma[origin], phi[origin])


def dvb_t_gi_sync(iq, n_fft: int, cp_len: int, fs: float, search_len: int,
                  cfg: GiSyncConfig = GiSyncConfig()) -> Optional[GiSyncResult]:
    """Best GI-aligned symbol start in offsets 0..search_len (ref :154-283)."""
    iq = np.asarray(iq)
    if cp_len == 0 or n_fft == 0 or search_len == 0:
        return None
    need = search_len - 1 + n_fft + cp_len
    if len(iq) < need:
        return None

    period = n_fft + cp_len
    (argmax, sc_peak, sc_origin, g_peak, p_peak, g_origin, p_origin) = \
        _gi_metrics(iq, n_fft, cp_len, search_len, cfg.rho,
                    max(cfg.max_symbols, 1))
    argmax = int(argmax)
    phase = argmax % period
    origin = argmax - phase
    use_origin = (cfg.origin_score_ratio > 0.0 and phase != 0
                  and period - phase <= -(-cp_len // 2)
                  and float(sc_origin) >= min(max(cfg.origin_score_ratio,
                                                  0.0), 1.0) * float(sc_peak))
    best_d = origin if use_origin else argmax
    bg = complex(g_origin if use_origin else g_peak)
    bp = float(p_origin if use_origin else p_peak)
    score = min(abs(bg) / bp, 1.0) if bp > 0 else 0.0
    if score <= 0.0:
        # zero correlation energy = silence/blanked input: no acquisition
        # (a 0-score "lock" at the origin would send garbage downstream)
        return None
    cfo_hz = -float(np.arctan2(bg.imag, bg.real)) * fs / (2 * np.pi * n_fft)
    return GiSyncResult(start_sample=best_d, cfo_hz=cfo_hz, score=score)


def dvb_t_gi_refine(iq, n_fft: int, cp_len: int, fs: float, coarse: int,
                    radius: int, cfg: GiSyncConfig = GiSyncConfig()
                    ) -> Optional[GiSyncResult]:
    """Local re-lock ±radius around a coarse estimate; the unwrap guard is
    disabled (nothing to unwrap in a sub-period window — ref :313-339)."""
    start = max(coarse - radius, 0)
    span = 2 * radius + 1
    sub = np.asarray(iq)[start:]
    local = GiSyncConfig(rho=cfg.rho, max_symbols=cfg.max_symbols,
                         origin_score_ratio=0.0)
    r = dvb_t_gi_sync(sub, n_fft, cp_len, fs, min(span, len(sub)), local)
    if r is None:
        return None
    return r._replace(start_sample=r.start_sample + start)


class IntegerCfoResult(NamedTuple):
    bins: int
    confidence: float


def dvb_t_integer_cfo(freq, n_fft: int, max_bins: int
                      ) -> Optional[IntegerCfoResult]:
    """Trial-shift continual-pilot energy search over one symbol's (or an
    accumulated) spectrum (ref :380-417). Vectorized over all shifts."""
    f = np.asarray(freq)
    if len(f) < n_fft or n_fft == 0 or max_bins <= 0:
        return None
    pb = continual_pilot_bins()
    ks = np.arange(-max_bins, max_bins + 1)
    idx = (pb[None, :] + ks[:, None]) % n_fft
    energies = np.sum(np.abs(f[idx]) ** 2, axis=1)
    best = int(np.argmax(energies))
    mean = float(np.mean(energies))
    conf = float(energies[best]) / mean if mean > 0 else 0.0
    return IntegerCfoResult(bins=int(ks[best]), confidence=conf)
