"""Chirp spread spectrum (LoRa-style) receiver — beyond the reference.

Dechirp × FFT: multiplying by the conjugate base upchirp turns every
symbol into a pure tone at shift·bw/2^SF, so the whole frame demodulates
as ONE batched FFT over symbol windows. Acquisition:
slide the symbol grid over up to one symbol of offsets, find the run of
consistent preamble tones; the two downchirp sync symbols (which dechirp
to noise against the up reference but to a tone against the down
reference) pin the payload start; the preamble tone index gives the
integer CFO/timing ambiguity which is absorbed as a constant shift."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit
from ..modulate.css import (_chirp_phase, css_samples_per_symbol,
                            CSS_PREAMBLE_UPCHIRPS)
from ..dsp.osc import TAU


class CssFrame(NamedTuple):
    payload: bytes
    crc_ok: bool
    snr_db: float


@cjit
def _dechirp_fft(z, base_re, base_im, n_sym: int, spsym: int, m: int):
    """(n_sym·spsym,) capture → (n_sym, m) |FFT| of dechirped symbols."""
    zz = jnp.asarray(z)[: n_sym * spsym].reshape(n_sym, spsym)
    base = (base_re + 1j * base_im)[None, :]
    d = zz * jnp.conj(base)
    # decimate the dechirped tone to the m-point grid (fs may exceed bw)
    step = spsym // m
    dd = d.reshape(n_sym, m, step).sum(axis=-1)
    return jnp.abs(jnp.fft.fft(dd, axis=-1)).astype(jnp.float32)


def _base(sf: int, bw: float, fs: float, down: bool = False):
    f = _chirp_phase(sf, bw, fs, 0, down=down)
    ph = np.cumsum(TAU * f / fs).astype(np.float32)
    return np.cos(ph), np.sin(ph)


def css_demod(iq, sf: int = 7, bw: float = 125_000.0,
              fs: float | None = None) -> Optional[CssFrame]:
    """Capture → CssFrame | None. Handles unknown start offset (searched
    at 8 sub-symbol lags) and the constant tone-bin offset a fractional
    timing error leaves behind."""
    fs = float(fs if fs is not None else bw)
    z = np.asarray(iq, np.complex64)
    spsym = css_samples_per_symbol(sf, bw, fs)
    m = 1 << sf
    if len(z) < (CSS_PREAMBLE_UPCHIRPS + 3) * spsym:
        return None
    # one symbol of zero tail: an off-grid alignment must not floor away
    # the final payload symbol
    z = np.concatenate([z, np.zeros(spsym, np.complex64)])
    up_re, up_im = _base(sf, bw, fs)
    dn_re, dn_im = _base(sf, bw, fs, down=True)

    def scan(off):
        n_sym = (len(z) - off) // spsym
        if n_sym < CSS_PREAMBLE_UPCHIRPS + 3:
            return None
        mag = np.asarray(_dechirp_fft(z[off:], up_re, up_im, n_sym,
                                      spsym, m))
        peaks = mag.max(axis=-1)
        med = np.median(mag, axis=-1) + 1e-12
        score = peaks / med
        args = mag.argmax(axis=-1)
        # preamble: a run of ≥(N−1) argmax within ±1 bin of their median
        # (noise jitters the peak a bin) at high score
        for s0 in range(0, n_sym - CSS_PREAMBLE_UPCHIRPS - 2):
            run = args[s0: s0 + CSS_PREAMBLE_UPCHIRPS - 1]
            center = int(np.median(run))
            dev = np.minimum((run - center) % m, (center - run) % m)
            if np.all(dev <= 1) and np.all(
                    score[s0: s0 + CSS_PREAMBLE_UPCHIRPS - 1] > 6.0):
                return (float(np.mean(score[s0: s0 + 7])), off, s0,
                        center, mag, args)
        return None

    coarse = max(spsym // 8, 1)
    best = None
    for off in range(0, spsym, coarse):
        cand = scan(off)
        if cand is not None and (best is None or cand[0] > best[0]):
            best = cand
    if best is None:
        return None
    # fine timing: re-scan around the winning coarse offset — a residual
    # sub-symbol error smears the tone across bins and costs ~5 dB
    fine = max(spsym // 64, 1)
    base_off = best[1]                    # snapshot: the grid must stay
    for doff in range(-coarse // 2, coarse // 2 + 1, fine):   # anchored on
        off2 = base_off + doff            # the coarse winner
        if off2 < 0 or doff == 0:
            continue
        cand = scan(off2)
        if cand is not None and cand[0] > best[0]:
            best = cand
    _, off, s0, bin0, mag, args = best

    # verify the two downchirp sync symbols right after the preamble: they
    # must dechirp strongly against the DOWN reference (a tone-like
    # interferer that faked the preamble fails here, and a one-symbol
    # preamble mis-lock shifts them onto data and fails too)
    dsync0 = s0 + CSS_PREAMBLE_UPCHIRPS
    dstart = off + dsync0 * spsym
    if dstart + 2 * spsym > len(z):
        return None
    dmag = np.asarray(_dechirp_fft(z[dstart:], dn_re, dn_im, 2, spsym, m))
    dscore = dmag.max(axis=-1) / (np.median(dmag, axis=-1) + 1e-12)
    if not np.all(dscore > 5.0):
        return None
    pay0 = s0 + CSS_PREAMBLE_UPCHIRPS + 2
    n_sym = mag.shape[0]
    if pay0 >= n_sym:
        return None
    syms = (args[pay0:] - bin0) % m
    # payload symbols end where the tone collapses into noise
    sc = mag[pay0:].max(axis=-1) / (np.median(mag[pay0:], axis=-1) + 1e-12)
    good = sc > 8.0
    if not good.any():
        return None
    n_data = int(np.max(np.flatnonzero(good))) + 1   # trim TRAILING noise
    syms = syms[:n_data]
    bits = ((syms[:, None] >> np.arange(sf - 1, -1, -1)) & 1).astype(
        np.uint8).reshape(-1)
    n_bytes = len(bits) // 8
    if n_bytes < 2:
        return None
    data = np.packbits(bits[: n_bytes * 8])
    from ..fec.crc import crc16
    payload, rx_crc = data[:-2], (int(data[-2]) << 8) | int(data[-1])
    ok = crc16(payload) == rx_crc
    if not ok and n_bytes > 2:
        # SF-bit packing can leave a partial trailing byte of pad bits —
        # retry dropping one byte
        data = data[:-1]
        payload, rx_crc = data[:-2], (int(data[-2]) << 8) | int(data[-1])
        ok = crc16(payload) == rx_crc
    snr = float(20 * np.log10(max(np.mean(sc[:n_data]), 1.0) / np.sqrt(m)))
    return CssFrame(payload=bytes(payload), crc_ok=bool(ok), snr_db=snr)
