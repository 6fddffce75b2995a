"""Generic OFDM waveform: config, mod/demod, equalization, soft demap, EVM.

Behavioral spec: /root/reference/src/modulate/ofdm.rs + demodulate/ofdm.rs.
Design: the reference's one-symbol-per-call Block chain
(mapper→GridMap→IFFT→CP→Rotator) collapses into one batched tensor program
over (..., n_symbols, n_fft) — map, scatter, IFFT, CP-concat, taper, rotate
in a single jitted graph. The equalizer is a pure function over whole frames;
per-symbol pilot interpolation is a vmapped jnp.interp instead of a
binary-search loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .constellation import map_bits, decide, soft_llr, BITS_PER_SYMBOL
from .multicarrier import (
    CarrierPlan, CarrierGrid, grid_map, map_bits_grid, grid_extract,
    ofdm_assemble, symbol_taper, symbol_fft, TxLowpass,
)
from .dsp.osc import rotate
from .dsp.device import cjit

EQUALIZER_FLOOR = 1e-6  # |h|² floor in ZF division (demodulate/ofdm.rs)


@dataclass(frozen=True)
class OfdmConfig:
    """OFDM waveform config incl. the frame-layer surface
    (ref: modulate/ofdm.rs:56-366 — one config carries both the per-symbol
    pipeline and the COFDM frame fields, all defaulted off)."""

    carrier_plan: CarrierPlan
    fs: float
    rf_hz: float = 0.0
    gain: float = 1.0
    constellation: str = "qpsk"
    # channel equalization method on the frame RX path: 'training_symbol'
    # (one estimate per packet, held — ref EqualizerMethod default,
    # demodulate/ofdm.rs:241-266) or 'pilot_interp' (re-estimated every
    # symbol by linear interpolation between the plan's pilot bins).
    equalizer_method: str = "training_symbol"
    # per-symbol common-phase-error tracking on the frame RX path (beyond
    # the reference): 'off' (reference behavior — the training estimate's
    # phase is held for the whole frame) or 'cpe' (V&V blind per-symbol
    # phase estimate + unwrap after equalization; rescues oscillator
    # phase-noise / residual-CFO drift across long frames).
    phase_tracking: str = "off"
    rx_window_backoff: int = 0
    tx_lowpass: Optional[TxLowpass] = None
    # frame-layer fields (orion_sdr_tpu.frame); defaults mirror the reference
    outer_fec: object = None             # frame.types.OuterFec
    inner_fec: object = None             # frame.types.InnerFec
    outer_interleaver: object = None     # frame.types.InterleaverKind
    inner_interleaver: object = None
    header_format: str = "orion_sdr"
    payload_crc: str = "crc32"
    header_crc: str = "crc16"   # ref default (modulate/ofdm.rs:158)
    scrambler: object = None             # frame.types.ScramblerKind
    scrambler_pos: str = "before_outer_fec"
    ldpc_decode_rule: str = "sum_product"
    dvb_t_scattered: bool = False
    # DFT-spread OFDM (SC-FDMA) transform precoding — the first follow-on
    # of the reference's planned multicarrier family
    # (/root/reference/docs/features.md "DFT-s-OFDM/SC-FDMA and OTFS to
    # follow"; unimplemented there). When on, each OFDM symbol's data
    # cells are spread by a unitary M-point DFT before grid mapping, so
    # the occupied band carries a cyclic single-carrier waveform: PAPR
    # drops ~2.5 dB and the RX becomes frequency-domain equalization of a
    # single-carrier stream. Applies to header and payload alike (TX/RX
    # exact mirrors).
    transform_precoding: bool = False

    def __post_init__(self):
        from .frame.types import (InterleaverKind, ScramblerKind, OuterFec,
                                  InnerFec)
        if self.outer_fec is None:
            object.__setattr__(self, "outer_fec", OuterFec.none())
        if self.inner_fec is None:
            object.__setattr__(self, "inner_fec", InnerFec.none())
        if self.outer_interleaver is None:
            object.__setattr__(self, "outer_interleaver", InterleaverKind.none())
        if self.inner_interleaver is None:
            object.__setattr__(self, "inner_interleaver", InterleaverKind.none())
        if self.scrambler is None:
            object.__setattr__(self, "scrambler", ScramblerKind.none())

    # builder-style helpers (ref with_* builders, modulate/ofdm.rs:171-310)
    def with_fs(self, fs: float):
        """Sets the sample rate (ref modulate/ofdm.rs:171) — e.g. a DVB-T
        caller selects an NB bandwidth mode with
        ``cfg.with_fs(NbBandwidth.BW_1MHZ.fs())``."""
        return replace(self, fs=fs)

    def with_outer_fec(self, outer_fec):
        """Config-surface outer FEC (ref modulate/ofdm.rs:176-180; carried by
        the config and checked by :meth:`validate` — the frame layer's
        per-frame FEC selection is the Mcs table)."""
        return replace(self, outer_fec=outer_fec)

    def with_inner_fec(self, inner_fec):
        return replace(self, inner_fec=inner_fec)

    def with_outer_interleaver(self, il):
        return replace(self, outer_interleaver=il)

    def with_inner_interleaver(self, il):
        return replace(self, inner_interleaver=il)

    def with_header_format(self, fmt: str):
        return replace(self, header_format=fmt)

    def with_payload_crc(self, crc: str):
        return replace(self, payload_crc=crc)

    def with_header_crc(self, crc: str):
        return replace(self, header_crc=crc)

    def with_scrambler(self, s):
        return replace(self, scrambler=s)

    def with_scrambler_pos(self, pos: str):
        return replace(self, scrambler_pos=pos)

    def with_ldpc_decode_rule(self, rule: str):
        return replace(self, ldpc_decode_rule=rule)

    def with_dvb_t_scattered(self, scattered: bool = True):
        return replace(self, dvb_t_scattered=scattered)

    def with_transform_precoding(self, enable: bool = True):
        """DFT-s-OFDM (SC-FDMA): spread each symbol's data cells with a
        unitary DFT before grid mapping (and invert after equalization on
        RX). Lowers PAPR ~2.5 dB for a localized (contiguous) carrier
        plan; incompatible with the fixed DVB-T wire format."""
        return replace(self, transform_precoding=enable)

    def with_rx_window_backoff(self, backoff: int):
        return replace(self, rx_window_backoff=backoff)

    def with_equalizer_method(self, method: str):
        """'training_symbol' (default) or 'pilot_interp' (per-symbol linear
        interpolation between the plan's pilot bins — the opt-in for
        time-varying channels; ref EqualizerMethod, demodulate/ofdm.rs:241-266
        and python/ofdm.rs:505-532)."""
        return replace(self, equalizer_method=method)

    def with_phase_tracking(self, method: str):
        """'off' (default, reference behavior) or 'cpe': blind per-symbol
        common-phase-error correction after the equalizer (V&V power-law
        estimate, cumulatively unwrapped). Rescues frames under oscillator
        phase noise / residual CFO that the held training estimate cannot
        follow; no reference equivalent."""
        return replace(self, phase_tracking=method)

    def with_tx_lowpass(self, lowpass):
        return replace(self, tx_lowpass=lowpass)

    def with_tx_lowpass_null_band(self, num_taps: int, stopband_db: float):
        """Convenience TX mask centred in the unoccupied band above the plan's
        edge (ref modulate/ofdm.rs:309 → TxLowpass::for_null_band)."""
        lowpass = TxLowpass.for_null_band(
            self.carrier_plan.n_fft,
            self.carrier_plan.occupied_half_carriers(),
            num_taps, stopband_db)
        return self.with_tx_lowpass(lowpass)

    def with_symbol_window(self, roll_off: int):
        """TX symbol windowing: `roll_off`-sample raised-cosine taper per
        symbol edge on the carrier plan; 0 disables (ref
        modulate/ofdm.rs:256-264). RX-transparent only with a compatible
        ``rx_window_backoff`` (roll_off ≤ cp_len/2, backoff = cp_len/2)."""
        return replace(self,
                       carrier_plan=self.carrier_plan.with_window_roll_off(roll_off))

    def with_symbol_window_beta_guard(self, beta: float):
        """Roll-off as a fraction of the guard: round(beta·cp_len), beta
        clamped to [0, 0.5] — 0.5 is the max RX-transparent taper (ref
        modulate/ofdm.rs:266-272)."""
        cp_len = self.carrier_plan.cp_len
        roll_off = int(round(min(max(beta, 0.0), 0.5) * cp_len))
        return self.with_symbol_window(roll_off)

    def with_symbol_window_beta_tu(self, beta: float):
        """Roll-off as a fraction of the useful symbol Tu (n_fft) — the
        DVB-family windowing-table convention (ref modulate/ofdm.rs:275-281).
        Clamped so 2·roll_off does not exceed the symbol length."""
        n_fft = self.carrier_plan.n_fft
        roll_off = int(round(max(beta, 0.0) * n_fft))
        sym = n_fft + self.carrier_plan.cp_len
        roll_off = min(roll_off, sym // 2)
        return self.with_symbol_window(roll_off)

    def bits_per_ofdm_symbol(self) -> int:
        return self.carrier_plan.num_data_carriers() * BITS_PER_SYMBOL[self.constellation]

    def samples_per_ofdm_symbol(self) -> int:
        return self.carrier_plan.n_fft + self.carrier_plan.cp_len

    def grid(self) -> CarrierGrid:
        return CarrierGrid(self.carrier_plan)

    def validate(self) -> None:
        """Raise on an invalid config (ref modulate/ofdm.rs:121-136)."""
        self.carrier_plan.validate()
        if self.fs <= 0.0:
            raise ValueError("fs must be positive")
        if self.constellation not in BITS_PER_SYMBOL:
            raise ValueError(f"unknown constellation {self.constellation!r}")
        if self.equalizer_method not in ("training_symbol", "pilot_interp"):
            raise ValueError(
                f"unknown equalizer {self.equalizer_method!r} "
                "(expected 'training_symbol' or 'pilot_interp')")
        if self.phase_tracking not in ("off", "cpe"):
            raise ValueError(
                f"unknown phase_tracking {self.phase_tracking!r} "
                "(expected 'off' or 'cpe')")
        if not (0 <= self.rx_window_backoff <= self.carrier_plan.cp_len):
            raise ValueError("rx_window_backoff must be within the cyclic prefix")
        if self.transform_precoding and self.dvb_t_scattered:
            raise ValueError(
                "transform_precoding is not a DVB-T mechanism (EN 300 744 "
                "fixes the carrier mapping); disable one of the two")
        if self.transform_precoding and self.carrier_plan.num_data_carriers() < 2:
            raise ValueError("transform_precoding needs ≥2 data carriers")
        if self.tx_lowpass is not None and not self.tx_lowpass.transition_fits(
                self.carrier_plan.n_fft,
                self.carrier_plan.occupied_half_carriers()):
            raise ValueError("tx_lowpass transition does not fit the null band")
        # frame-layer checks (ref modulate/ofdm.rs:332-358)
        from .frame.types import header_has_block
        if (getattr(self.scrambler, "kind", "none") == "additive"
                and getattr(self.scrambler, "seed_mode", "fixed") == "per_frame"
                and not header_has_block(self.header_format)):
            raise ValueError(
                "per-frame-random scrambler seed needs a header block to "
                "carry it to the receiver")
        for il in (self.outer_interleaver, self.inner_interleaver):
            kind = getattr(il, "kind", "none")
            if kind == "block" and (il.rows == 0 or il.cols == 0):
                raise ValueError("interleaver dimensions must be nonzero")
            if kind == "conv" and (il.branches == 0 or il.depth == 0):
                raise ValueError("interleaver dimensions must be nonzero")
        ofec = self.outer_fec
        okind = getattr(ofec, "kind", "none")
        if okind == "bch" and ofec.t == 0:
            raise ValueError("BCH t must be nonzero")
        if okind == "rs":
            n, n_parity = ofec.n, ofec.n_parity
            if (n == 0 or n > 255 or n_parity == 0 or n_parity >= n
                    or n_parity % 2 != 0):
                raise ValueError("invalid Reed-Solomon (n, n_parity) config")


# ── DFT-s-OFDM transform precoding ───────────────────────────────────────────


def dft_precode(syms):
    """Unitary M-point DFT across the data-carrier axis (SC-FDMA TX
    spreading): X[k] = (1/√M)·Σₘ x[m]·e^(−2πi·mk/M). Unit average power
    in == unit average power out, so the grid/LLR gain bookkeeping is
    untouched."""
    z = jnp.asarray(syms)
    m = z.shape[-1]
    return (jnp.fft.fft(z, axis=-1) * jnp.float32(1.0 / np.sqrt(m))
            ).astype(jnp.complex64)


def dft_deprecode(syms):
    """Inverse of :func:`dft_precode` (RX despreading after frequency-domain
    equalization): the equalized data cells of each OFDM symbol return to
    the single-carrier constellation points."""
    z = jnp.asarray(syms)
    m = z.shape[-1]
    return (jnp.fft.ifft(z, axis=-1) * jnp.float32(np.sqrt(m))
            ).astype(jnp.complex64)


# ── TX ───────────────────────────────────────────────────────────────────────


@cjit
def ofdm_mod(cfg: OfdmConfig, bits, phase0=0.0, pilot_bins=None, pilot_values=None):
    """bits → IQ for whole frames (ref OfdmMod, modulate/ofdm.rs:422-544).

    bits length is zero-padded up to a whole number of OFDM symbols (matching
    OfdmMod::modulate). Applies the plan's symbol-window taper and the
    config's TX lowpass when present. Returns (iq, rf_phase_out).
    """
    g = cfg.grid()
    bits = jnp.asarray(bits)
    bps = cfg.bits_per_ofdm_symbol()
    n_sym = -(-bits.shape[-1] // bps)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    if pilot_bins is None and pilot_values is None \
            and not cfg.transform_precoding:
        # fused map+place: no pair-deinterleave layout change (see
        # multicarrier/ops.py::map_bits_grid)
        freq = map_bits_grid(g, bits, cfg.constellation)
    else:
        syms = map_bits(bits, cfg.constellation)
        syms = syms.reshape(syms.shape[:-1] + (n_sym, g.num_data_carriers))
        if cfg.transform_precoding:
            syms = dft_precode(syms)
        freq = grid_map(g, syms, pilot_bins=pilot_bins,
                        pilot_values=pilot_values)
    taper = symbol_taper(cfg.samples_per_ofdm_symbol(), cfg.carrier_plan.window_roll_off)
    t = ofdm_assemble(freq, cfg.carrier_plan.cp_len, taper=taper)
    t = t * cfg.gain
    if cfg.rf_hz != 0.0:
        t, phase0 = rotate(t, cfg.rf_hz, cfg.fs, phase0)
    if cfg.tx_lowpass is not None:
        t = cfg.tx_lowpass.apply(t)
    return t.astype(jnp.complex64), phase0


# ── Channel estimation / equalization ────────────────────────────────────────


def zf_equalize(freq_syms, estimate):
    """Per-bin zero-forcing: x·conj(h)/max(|h|², 1e−6)
    (ref: demodulate/ofdm.rs:427-448)."""
    h = jnp.asarray(estimate)
    x = jnp.asarray(freq_syms)
    mag2 = jnp.maximum(jnp.abs(h) ** 2, EQUALIZER_FLOOR)
    return (x * jnp.conj(h) / mag2).astype(jnp.complex64)


def mmse_equalize(freq_syms, estimate, noise_var: float):
    """Per-bin LMMSE: x·conj(h)/(|h|² + σ²).

    ``noise_var`` is the complex noise variance PER FREQUENCY BIN relative
    to unit-amplitude grid cells — the domain this equalizer runs in. For
    time-domain AWGN of complex variance σ²ₜ entering the unity-gain
    ``symbol_fft``, that is ``n_fft·σ²ₜ`` (the forward FFT has no 1/N).
    Unlike ZF it shrinks deeply faded bins toward zero instead of
    amplifying their noise — the right front end for diversity-combining
    waveforms (DFT-s-OFDM, OTFS) where a later transform averages over
    bins. Beyond the reference (ZF only, demodulate/ofdm.rs:427-448)."""
    h = jnp.asarray(estimate)
    x = jnp.asarray(freq_syms)
    denom = jnp.abs(h) ** 2 + jnp.float32(max(noise_var, EQUALIZER_FLOOR))
    return (x * jnp.conj(h) / denom).astype(jnp.complex64)


def channel_estimate_training(rx_training_freq, known_freq):
    """TrainingSymbolHold: h[bin] = rx[bin]/known[bin]
    (ref: demodulate/ofdm.rs:347-356)."""
    return (jnp.asarray(rx_training_freq) / jnp.asarray(known_freq)).astype(jnp.complex64)


def channel_estimate_denoise(estimate, cp_len: int, backoff: int = 0,
                             timing_slop: int = 4):
    """Delay-domain denoising of a per-bin channel estimate (beyond the
    reference, which holds the raw single-symbol ratio).

    A legal OFDM channel's impulse response fits inside the cyclic prefix,
    so its frequency response is bandlimited: IFFT the (..., n_fft)
    estimate, keep taps [0, cp_len + backoff] (window backoff delays the
    effective response by up to ``backoff``) plus ``timing_slop`` wraparound
    taps for residual fine-timing error, zero the rest, FFT back. Keeps
    ~(cp+backoff)/n_fft of the estimation noise — ≈6 dB cleaner for
    n_fft/cp = 4 — and is exactly transparent for any in-guard channel.

    Host numpy: one n_fft-length vector per acquisition, too small to be
    worth a device call."""
    h = np.fft.ifft(np.asarray(estimate), axis=-1)
    n_fft = h.shape[-1]
    keep_hi = min(int(cp_len) + int(backoff) + 1, n_fft)
    idx = np.arange(n_fft)
    mask = (idx < keep_hi) | (idx >= n_fft - int(timing_slop))
    return np.fft.fft(np.where(mask, h, 0.0), axis=-1).astype(np.complex64)


def cpe_raw_phases(syms, constellation: str):
    """Per-OFDM-symbol common-phase estimates, Viterbi&Viterbi style
    (beyond the reference, which holds the training phase for the frame).

    ``syms``: (..., n_sym, n_data) equalized data cells. BPSK: the squared
    sum removes the ±1 modulation, φ̂ = ∠(Σz²)/2 mod π. QPSK/QAM: the
    4th-power sum removes the 4-fold symmetry and lands on the negative
    real axis (E[p⁴] < 0 for every square constellation), so
    φ̂ = ∠(−Σz⁴)/4 mod π/2. Returns (..., n_sym) wrapped phases; resolve
    the modulus with :func:`cpe_unwrap` before rotating."""
    z = jnp.asarray(syms)
    if constellation == "bpsk":
        return jnp.angle(jnp.sum(z * z, axis=-1)) / 2.0
    z2 = z * z
    return jnp.angle(-jnp.sum(z2 * z2, axis=-1)) / 4.0


def cpe_unwrap(raw, constellation: str):
    """Cumulatively unwrap the modulus-π/2 (π for BPSK) V&V phases along
    the symbol axis: successive common-phase increments are small (one
    OFDM symbol of oscillator walk), so each step takes the branch nearest
    the previous symbol's phase."""
    per = jnp.pi if constellation == "bpsk" else jnp.pi / 2.0
    raw = jnp.asarray(raw)
    d = jnp.diff(raw, axis=-1)
    d = (d + per / 2.0) % per - per / 2.0
    return jnp.concatenate(
        [raw[..., :1], raw[..., :1] + jnp.cumsum(d, axis=-1)], axis=-1)


def cpe_correct(syms, constellation: str):
    """Estimate and remove per-symbol common phase error from equalized
    data cells (the ``phase_tracking='cpe'`` RX stage): V&V raw phases →
    cumulative unwrap → derotate. Returns (corrected, phases)."""
    z = jnp.asarray(syms)
    phases = cpe_unwrap(cpe_raw_phases(z, constellation), constellation)
    rot = jnp.exp(-1j * phases.astype(jnp.float32)).astype(jnp.complex64)
    return z * rot[..., None], phases


@lru_cache(maxsize=64)
def _pilot_interp_matrix(pb_key: tuple, n_fft: int) -> np.ndarray:
    """(n_pilots, n_fft) linear-interpolation weights for SORTED constant
    pilot bins (edge hold) — turns per-bin jnp.interp searchsorted gathers
    into one matmul."""
    pb = np.asarray(pb_key, np.float64)
    W = np.zeros((len(pb), n_fft), np.float32)
    for b in range(n_fft):
        r = int(np.searchsorted(pb, b, side="left"))
        if r == 0:
            W[0, b] = 1.0
        elif r >= len(pb):
            W[-1, b] = 1.0
        elif pb[r] == b:
            W[r, b] = 1.0
        else:
            t = (b - pb[r - 1]) / (pb[r] - pb[r - 1])
            W[r - 1, b] = 1.0 - t
            W[r, b] = t
    return W


def channel_estimate_pilots(freq_syms, pilot_bins, pilot_values, n_fft: int):
    """PerSymbolPilotInterp: linear complex interpolation between bin-sorted
    pilot known-vs-received ratios, edge hold (ref: demodulate/ofdm.rs:357-426).

    ``freq_syms``: (..., n_sym, n_fft). ``pilot_bins``: (n_pilots,) or
    (n_sym, n_pilots); ``pilot_values`` matching. Returns (..., n_sym, n_fft)
    channel estimate. Constant (numpy, 1-D) pilot bins take the
    matmul-interpolation fast path.
    """
    x = jnp.asarray(freq_syms)
    if isinstance(pilot_bins, np.ndarray) and pilot_bins.ndim == 1:
        order = np.argsort(pilot_bins, kind="stable")
        pb_s = pilot_bins[order]
        pv_s = jnp.asarray(np.asarray(pilot_values)[order],
                           dtype=jnp.complex64)
        W = jnp.asarray(_pilot_interp_matrix(tuple(int(b) for b in pb_s),
                                             int(n_fft)))
        ratio = x[..., pb_s] / pv_s
        hi = jax.lax.Precision.HIGHEST
        est = (jnp.matmul(ratio.real, W, precision=hi)
               + 1j * jnp.matmul(ratio.imag, W, precision=hi))
        return est.astype(jnp.complex64)
    pb = jnp.asarray(pilot_bins)
    pv = jnp.asarray(pilot_values, dtype=jnp.complex64)
    if pb.ndim == 1:
        pb = jnp.broadcast_to(pb, x.shape[-2:-1] + pb.shape)
        pv = jnp.broadcast_to(pv, x.shape[-2:-1] + pv.shape)
    # sort pilots by bin per symbol
    order = jnp.argsort(pb, axis=-1)
    pb = jnp.take_along_axis(pb, order, axis=-1)
    pv = jnp.take_along_axis(pv, order, axis=-1)
    rx = jnp.take_along_axis(x, jnp.broadcast_to(pb, x.shape[:-1] + pb.shape[-1:]), axis=-1)
    ratio = rx / pv
    bins = jnp.arange(n_fft, dtype=jnp.float32)

    def interp_sym(pbins, rat):
        re = jnp.interp(bins, pbins.astype(jnp.float32), rat.real)
        im = jnp.interp(bins, pbins.astype(jnp.float32), rat.imag)
        return re + 1j * im

    # vmap over symbol axis (and any leading axes by broadcasting through reshape)
    lead = ratio.shape[:-1]
    flat_pb = jnp.broadcast_to(pb, lead + pb.shape[-1:]).reshape((-1, pb.shape[-1]))
    flat_ratio = ratio.reshape((-1, ratio.shape[-1]))
    est = jax.vmap(interp_sym)(flat_pb, flat_ratio)
    return est.reshape(lead + (n_fft,)).astype(jnp.complex64)


# ── RX ───────────────────────────────────────────────────────────────────────


@cjit
def ofdm_demod(cfg: OfdmConfig, iq, n_symbols=None, estimate=None, gain=1.0, phase0=0.0):
    """IQ → soft data symbols (ref OfdmDemod, demodulate/ofdm.rs:26-95).

    Optional ``estimate`` (n_fft,) or (..., n_sym, n_fft) applies ZF
    equalization between the FFT and grid extraction (the composable
    OfdmEqualizer stage). Returns (soft_symbols (..., n_sym, n_data), phase).
    """
    g = cfg.grid()
    z = jnp.asarray(iq)
    if cfg.rf_hz != 0.0:
        z, phase0 = rotate(z, -cfg.rf_hz, cfg.fs, phase0)
    freq = symbol_fft(z, g.n_fft, g.cp_len, backoff=cfg.rx_window_backoff,
                      n_symbols=n_symbols)
    if estimate is not None:
        freq = zf_equalize(freq, estimate)
    soft = grid_extract(g, freq) * gain
    if cfg.transform_precoding:
        soft = dft_deprecode(soft)
    return soft.astype(jnp.complex64), phase0


def ofdm_decide(cfg: OfdmConfig, soft_symbols):
    """Hard bits from soft symbols (ref OfdmDecider). Output (..., n_sym·bps)."""
    s = jnp.asarray(soft_symbols)
    flat = s.reshape(s.shape[:-2] + (-1,))
    return decide(flat, cfg.constellation)


def ofdm_soft_demod(cfg: OfdmConfig, soft_symbols):
    """Max-log LLRs, positive ⇒ bit 0 (ref OfdmSoftDemod,
    demodulate/ofdm.rs:460-610)."""
    s = jnp.asarray(soft_symbols)
    flat = s.reshape(s.shape[:-2] + (-1,))
    return soft_llr(flat, cfg.constellation)


class OfdmRxFrame(NamedTuple):
    """Per-packet diagnostics (ref: demodulate/ofdm.rs:174-211)."""
    bits: np.ndarray
    num_symbols: int
    evm_db: Optional[float]
    cfo_hz: Optional[float] = None
    timing_offset_samples: Optional[int] = None
    channel_mse: Optional[float] = None


def build_ofdm_rx_frame(cfg: OfdmConfig, soft_symbols, bits) -> OfdmRxFrame:
    """EVM by re-mapping hard bits to ideal points (ref: demodulate/ofdm.rs:213-238)."""
    s = np.asarray(soft_symbols).reshape(-1)
    b = np.asarray(bits)
    n_data = cfg.carrier_plan.num_data_carriers()
    num_symbols = len(s) // max(n_data, 1)
    evm = None
    if num_symbols and len(s):
        ideal = np.asarray(map_bits(b, cfg.constellation))
        if len(ideal) == len(s):
            err = float(np.sum(np.abs(s - ideal) ** 2))
            ref = float(np.sum(np.abs(ideal) ** 2))
            if ref > 0:
                evm = 10.0 * np.log10(err / ref) if err > 0 else -np.inf
    return OfdmRxFrame(bits=b, num_symbols=num_symbols, evm_db=evm)
