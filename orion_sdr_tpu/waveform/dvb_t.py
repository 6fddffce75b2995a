"""DVB-T 2K / NB-DVB-T waveform definitions (behavioral spec:
waveform/dvb_t.rs; parameters from ETSI EN 300 744).

Design: the reference's symbol-at-a-time ScatteredPilotMapper/Extractor
objects become four precomputed per-phase index/value arrays; whole frames
map/extract as ONE batched scatter/gather over (n_symbols, 2048) with the
phase selected by `l mod 4` — no orchestrator state, no per-symbol loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from ..multicarrier import CarrierPlan
from ..dsp.device import cjit

# ── energy dispersal (EN 300 744 §4.3.1) ─────────────────────────────────────

# PRBS 1 + X^14 + X^15, init 100101010000000, MSB-first, output = feedback
# bit. Known answer: the first 8 output bits pack to 0x03.
DVB_T_PRBS_INIT = 0b100101010000000


@lru_cache(maxsize=32)
def dvb_t_prbs_bits(n_bits: int, init: int = DVB_T_PRBS_INIT) -> np.ndarray:
    """First ``n_bits`` of the energy-dispersal PRBS as uint8 bits."""
    reg = init
    out = np.empty(n_bits, np.uint8)
    for i in range(n_bits):
        fb = ((reg >> 1) ^ reg) & 1
        out[i] = fb
        reg = (reg >> 1) | (fb << 14)
    return out


@lru_cache(maxsize=32)
def dvb_t_prbs_bytes(n_bytes: int, init: int = DVB_T_PRBS_INIT) -> np.ndarray:
    return np.packbits(dvb_t_prbs_bits(n_bytes * 8, init))


def energy_disperse(data, skip_first: int = 0) -> np.ndarray:
    """XOR the dispersal PRBS over ``data`` bytes (self-inverse).

    ``skip_first``: clock the PRBS over this many leading bytes without
    applying it (TS sync-byte handling)."""
    d = np.asarray(data, np.uint8)
    pn = dvb_t_prbs_bytes(skip_first + d.shape[-1])
    return d ^ pn[skip_first:]


# ── Figure-9a constellation (EN 300 744 §4.3.5) ──────────────────────────────

# Per-axis level tables, index = axis bits MSB-first (even y-bits → I axis,
# odd y-bits → Q axis).
DVB_T_AXIS = {
    2: np.array([1, -1], np.float32),
    4: np.array([3, 1, -3, -1], np.float32),
    6: np.array([7, 5, 1, 3, -7, -5, -1, -3], np.float32),
}

_DVB_ORDERS = {"qpsk": 2, "qam16": 4, "qam64": 6}

# Hierarchical non-uniform constellations (§4.3.5, Figures 9b/9c): every
# uniform axis magnitude u shifts outward to u + (α−1), pushing the four
# quadrant clusters apart so the two MSBs (the embedded-QPSK HP stream)
# survive lower SNR. α ∈ {1, 2, 4}; α = 1 is the uniform grid reused by
# hierarchical multiplexing. (Beyond the reference — it implements only
# non-hierarchical Figure 9a, waveform/dvb_t.rs:112-268.)
DVB_T_ALPHAS = (1, 2, 4)


def dvb_t_axis(v: int, alpha: int = 1) -> np.ndarray:
    """Non-uniform per-axis level table: sign(u)·(|u| + α − 1)."""
    if alpha not in DVB_T_ALPHAS:
        raise ValueError(f"alpha must be one of {DVB_T_ALPHAS}, got {alpha}")
    if alpha != 1 and v == 2:
        raise ValueError("hierarchical alpha applies to 16-/64-QAM only")
    u = DVB_T_AXIS[v]
    return (np.sign(u) * (np.abs(u) + (alpha - 1))).astype(np.float32)


def axis_scale(v: int, alpha: int = 1) -> float:
    """1/√(2·E[axis²]) — unit mean symbol energy. For α = 1 this is the
    uniform 1/√(2(M²−1)/3); the spec's non-uniform factors (1/√20, 1/√52
    for 16-QAM α=2/4; 1/√60, 1/√108 for 64-QAM) fall out of the same
    expectation over the shifted level set."""
    if alpha == 1:
        m = 1 << (v // 2)
        return 1.0 / np.sqrt(2.0 * (m * m - 1) / 3.0)
    mags = np.abs(dvb_t_axis(v, alpha)).astype(np.float64)
    return float(1.0 / np.sqrt(2.0 * np.mean(mags * mags)))


def is_dvb_t_constellation(order: str) -> bool:
    return order in _DVB_ORDERS


@lru_cache(maxsize=8)
def _point_table(v: int, alpha: int = 1) -> np.ndarray:
    """(2^v,) complex64: constellation point per v-bit label y0..y(v-1)."""
    table = dvb_t_axis(v, alpha)
    scale = axis_scale(v, alpha)
    k = v // 2
    labels = np.arange(1 << v)
    # de-interleave label bits: even positions → I index, odd → Q index
    i_idx = np.zeros(1 << v, np.int64)
    q_idx = np.zeros(1 << v, np.int64)
    for j in range(k):
        y_i = (labels >> (v - 1 - 2 * j)) & 1       # bit y_{2j}
        y_q = (labels >> (v - 2 - 2 * j)) & 1       # bit y_{2j+1}
        i_idx = (i_idx << 1) | y_i
        q_idx = (q_idx << 1) | y_q
    return ((table[i_idx] + 1j * table[q_idx]) * scale).astype(np.complex64)


@cjit
def dvb_t_map_symbols(bits, v: int, alpha: int = 1):
    """(..., n·v) bits → (..., n) Figure-9a/9b/9c constellation points
    (vectorized over whole frames; ref dvb_t_map_symbol — alpha ≠ 1 is the
    hierarchical non-uniform grid, beyond the reference).

    The axis tables factor as sign(MSB) × (M−1 − 2·gray_decode(rest) + α−1),
    so the mapping is pure bit arithmetic, not a per-cell table gather."""
    b = jnp.asarray(bits).astype(jnp.int32) & 1
    g = b.reshape(b.shape[:-1] + (-1, v))
    k = v // 2
    m = 1 << k
    scale = axis_scale(v, alpha)

    def axis_val(ab):
        # ab: (..., n, k) axis bits MSB-first
        shifts = jnp.asarray(np.arange(k - 1, -1, -1, dtype=np.int32))
        idx = jnp.sum(ab << shifts, axis=-1)
        sign = 1 - 2 * (idx >> (k - 1))
        low = idx & ((1 << max(k - 1, 0)) - 1)
        gd = low ^ (low >> 1)
        gd = gd ^ (gd >> 2)
        return (sign * (m - 1 - 2 * gd + (alpha - 1))
                ).astype(jnp.float32) * scale

    re = axis_val(g[..., 0::2])          # even y-bits → I axis
    im = axis_val(g[..., 1::2])          # odd y-bits → Q axis
    return (re + 1j * im).astype(jnp.complex64)


def dvb_t_map_symbol(bits):
    """Single-symbol convenience (ref dvb_t_map_symbol); None if bad order."""
    v = len(bits)
    if v not in DVB_T_AXIS:
        return None
    return complex(np.asarray(dvb_t_map_symbols(np.asarray(bits), v))[0])


@cjit
def dvb_t_demap_symbols(syms, v: int, alpha: int = 1):
    """Hard nearest-point inverse → (..., n·v) bits."""
    table = jnp.asarray(dvb_t_axis(v, alpha) * axis_scale(v, alpha))
    s = jnp.asarray(syms)
    k = v // 2
    i_idx = jnp.argmin(jnp.abs(s.real[..., None] - table), axis=-1)
    q_idx = jnp.argmin(jnp.abs(s.imag[..., None] - table), axis=-1)
    shifts = jnp.arange(k - 1, -1, -1)
    ib = (i_idx[..., None] >> shifts) & 1
    qb = (q_idx[..., None] >> shifts) & 1
    out = jnp.stack([ib, qb], axis=-1).reshape(s.shape[:-1] + (-1,))
    return out.astype(jnp.uint8)


@cjit
def dvb_t_soft_llrs(syms, v: int, alpha: int = 1):
    """Max-log LLRs in y0..y(v−1) order, positive ⇒ bit 0 (ref dvb_t_soft_llr),
    vectorized over whole frames → (..., n·v) float32. ``alpha ≠ 1``
    evaluates distances against the hierarchical non-uniform grid."""
    table = jnp.asarray(dvb_t_axis(v, alpha) * axis_scale(v, alpha))
    s = jnp.asarray(syms)
    k = v // 2
    idx = np.arange(len(DVB_T_AXIS[v]))

    def axis_llrs(coord):
        d2 = (coord[..., None] - table) ** 2          # (..., n, M)
        outs = []
        for b in range(k):
            shift = k - 1 - b
            bit1 = (idx >> shift) & 1
            d0 = jnp.min(jnp.where(jnp.asarray(bit1 == 0), d2, jnp.inf), axis=-1)
            d1 = jnp.min(jnp.where(jnp.asarray(bit1 == 1), d2, jnp.inf), axis=-1)
            outs.append(d1 - d0)
        return outs

    il = axis_llrs(s.real)
    ql = axis_llrs(s.imag)
    inter = []
    for j in range(k):
        inter += [il[j], ql[j]]
    out = jnp.stack(inter, axis=-1)                    # (..., n, v)
    return out.reshape(s.shape[:-1] + (-1,)).astype(jnp.float32)


# ── 2K numerology (EN 300 744 §4.4-4.5) ──────────────────────────────────────

DVB_T_N_FFT = 2048
DVB_T_KMAX = 1704
DVB_T_ACTIVE_CARRIERS = DVB_T_KMAX + 1          # 1705
DVB_T_DATA_CARRIERS = 1512
_CENTER = DVB_T_KMAX // 2                        # 852

# Table 7 (2K column): 45 continual-pilot active-carrier indices.
DVB_T_CONTINUAL_PILOTS_2K = np.array([
    0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450, 483,
    525, 531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918, 939, 942,
    969, 984, 1050, 1101, 1107, 1110, 1137, 1140, 1146, 1206, 1269, 1323,
    1377, 1491, 1683, 1704], np.int64)

# Table 8 (2K column): 17 TPS carrier indices.
DVB_T_TPS_CARRIERS_2K = np.array([
    34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219, 1262, 1286,
    1469, 1594, 1687], np.int64)

DVB_T_SCATTERED_PHASES = 4
DVB_T_SCATTERED_PILOT_SPACING = 12
DVB_T_MAX_RX_WINDOW_BACKOFF = DVB_T_N_FFT // (2 * DVB_T_SCATTERED_PILOT_SPACING)

GUARD_INTERVALS = {"1/32": 64, "1/16": 128, "1/8": 256, "1/4": 512}


def guard_cp_len_2k(guard: str) -> int:
    return GUARD_INTERVALS[guard]


def guard_from_cp_len_2k(cp_len: int):
    for g, c in GUARD_INTERVALS.items():
        if c == cp_len:
            return g
    return None


def active_to_signed(a) -> np.ndarray:
    """DVB active index (0..=1704) → DC-centered signed carrier (a − 852)."""
    return np.asarray(a, np.int64) - _CENTER


def active_to_bin(a) -> np.ndarray:
    """DVB active index → FFT bin: (a − 852) mod 2048."""
    return (active_to_signed(a)) % DVB_T_N_FFT


@lru_cache(maxsize=4)
def wk_prbs(length: int = DVB_T_ACTIVE_CARRIERS) -> np.ndarray:
    """Reference PRBS w_k (§4.5.2): X^11 + X^2 + 1, all-ones init; begins
    11111111111 00... One bit per active carrier."""
    reg = 0x7FF
    out = np.empty(length, np.uint8)
    for i in range(length):
        out[i] = (reg >> 10) & 1
        fb = ((reg >> 10) ^ (reg >> 1)) & 1
        reg = ((reg << 1) | fb) & 0x7FF
    return out


def boosted_pilot_value(wk) -> np.ndarray:
    """±4/3 real pilot: 4/3·2·(1/2 − w_k) (§4.5.3/4.5.4)."""
    return ((4.0 / 3.0) * 2.0 * (0.5 - np.asarray(wk, np.float32))
            ).astype(np.complex64)


def scattered_pilot_indices(phase: int) -> np.ndarray:
    """Active indices with k mod 12 == 3·(phase mod 4) (§4.5.3)."""
    start = 3 * (phase % DVB_T_SCATTERED_PHASES)
    return np.arange(start, DVB_T_KMAX + 1, DVB_T_SCATTERED_PILOT_SPACING,
                     dtype=np.int64)


def tps_carrier_bins() -> np.ndarray:
    return active_to_bin(DVB_T_TPS_CARRIERS_2K)


def continual_pilot_bins() -> np.ndarray:
    return active_to_bin(DVB_T_CONTINUAL_PILOTS_2K)


def dvb_t_2k_plan(guard: str) -> CarrierPlan:
    """Phase-1 plan: 45 continual pilots, all other active carriers data."""
    wk = wk_prbs()
    pilots = [(int(active_to_signed(a)), complex(boosted_pilot_value(wk[a])))
              for a in DVB_T_CONTINUAL_PILOTS_2K]
    pset = set(DVB_T_CONTINUAL_PILOTS_2K.tolist())
    data = [int(active_to_signed(a)) for a in range(DVB_T_KMAX + 1)
            if a not in pset]
    return CarrierPlan(DVB_T_N_FFT, guard_cp_len_2k(guard)) \
        .with_data_carriers(data).with_pilot_carriers(pilots)


@dataclass(frozen=True)
class ScatteredGrid:
    """Per-phase precomputed arrays for the conformant rotating grid.

    data_bins:  (4, 1512)  FFT bin of each data carrier per phase
    pilot_bins: list of 4 (n_p,) arrays (continual + scattered + TPS)
    pilot_vals: matching boosted w_k values
    ref_bins / ref_vals: channel-reference pilots only (TPS excluded — the
    modulator overwrites TPS bins with data-power DBPSK, so using them as
    references would corrupt the interpolation; ref dvb_t.rs docs).
    """
    data_bins: np.ndarray
    pilot_bins: tuple
    pilot_vals: tuple
    ref_bins: tuple
    ref_vals: tuple


@lru_cache(maxsize=2)
def scattered_grid() -> ScatteredGrid:
    wk = wk_prbs()
    tps_set = set(DVB_T_TPS_CARRIERS_2K.tolist())
    data_bins = []
    pilot_bins, pilot_vals, ref_bins, ref_vals = [], [], [], []
    for phase in range(DVB_T_SCATTERED_PHASES):
        reserved = sorted(set(DVB_T_CONTINUAL_PILOTS_2K.tolist())
                          | set(scattered_pilot_indices(phase).tolist())
                          | tps_set)
        reserved = np.array(reserved, np.int64)
        data = np.array([a for a in range(DVB_T_KMAX + 1)
                         if a not in set(reserved.tolist())], np.int64)
        assert len(data) == DVB_T_DATA_CARRIERS, (phase, len(data))
        data_bins.append(active_to_bin(data))
        pilot_bins.append(active_to_bin(reserved))
        pilot_vals.append(boosted_pilot_value(wk[reserved]))
        refs = np.array([a for a in reserved if a not in tps_set], np.int64)
        ref_bins.append(active_to_bin(refs))
        ref_vals.append(boosted_pilot_value(wk[refs]))
    return ScatteredGrid(
        data_bins=np.stack(data_bins),
        pilot_bins=tuple(pilot_bins), pilot_vals=tuple(pilot_vals),
        ref_bins=tuple(ref_bins), ref_vals=tuple(ref_vals))


def dvb_t_2k_plans(guard: str):
    """The four symbol-phase plans (§4.5); each carries exactly 1512 data."""
    wk = wk_prbs()
    g = scattered_grid()
    plans = []
    for phase in range(DVB_T_SCATTERED_PHASES):
        # rebuild signed indices from the bins
        signed_data = ((g.data_bins[phase] + _CENTER) % DVB_T_N_FFT) - _CENTER
        signed_pilot = ((np.asarray(g.pilot_bins[phase]) + _CENTER)
                        % DVB_T_N_FFT) - _CENTER
        plans.append(
            CarrierPlan(DVB_T_N_FFT, guard_cp_len_2k(guard))
            .with_data_carriers(signed_data.tolist())
            .with_pilot_carriers(list(zip(signed_pilot.tolist(),
                                          np.asarray(g.pilot_vals[phase])))))
    return plans


@cjit
def scattered_map_frame(data_syms, first_phase: int = 0):
    """TX: (..., n_sym, 1512) data constellation points → (..., n_sym, 2048)
    frequency grids with the phase-rotating pilots inserted — one vectorized
    scatter replacing the reference's per-symbol ScatteredPilotMapper."""
    g = scattered_grid()
    d = jnp.asarray(data_syms)
    n_sym = d.shape[-2]
    freq = jnp.zeros(d.shape[:-1] + (DVB_T_N_FFT,), jnp.complex64)
    for phase in range(DVB_T_SCATTERED_PHASES):
        syms = np.arange(n_sym)[(np.arange(n_sym) + first_phase)
                                % DVB_T_SCATTERED_PHASES == phase]
        if len(syms) == 0:
            continue
        freq = freq.at[..., syms[:, None], g.data_bins[phase][None, :]].set(
            d[..., syms, :])
        freq = freq.at[..., syms[:, None],
                       np.asarray(g.pilot_bins[phase])[None, :]].set(
            jnp.asarray(g.pilot_vals[phase]))
    return freq


@cjit
def scattered_extract_frame(freq, first_phase: int = 0):
    """RX: (..., n_sym, 2048) equalized grids → (..., n_sym, 1512) data.

    Fast path (whole frames: n_sym % 4 == 0, phase 0): the four rotating
    phases become a strided reshape, so each phase's data-bin gather runs on
    a contiguous slab and the result reassembles with one reshape — no
    full-tensor scatters (measured: the at[].set scatter chain dominated the
    fused receive program)."""
    g = scattered_grid()
    f = jnp.asarray(freq)
    n_sym = f.shape[-2]
    P = DVB_T_SCATTERED_PHASES
    if first_phase == 0 and n_sym % P == 0 and n_sym:
        fb = f.reshape(f.shape[:-2] + (n_sym // P, P, f.shape[-1]))
        cols = [fb[..., p, :][..., jnp.asarray(g.data_bins[p])]
                for p in range(P)]
        out = jnp.stack(cols, axis=-2)       # (..., n_sym/P, P, 1512)
        return out.reshape(f.shape[:-1] + (DVB_T_DATA_CARRIERS,))
    out = jnp.zeros(f.shape[:-1] + (DVB_T_DATA_CARRIERS,), f.dtype)
    for phase in range(P):
        syms = np.arange(n_sym)[(np.arange(n_sym) + first_phase) % P == phase]
        if len(syms) == 0:
            continue
        out = out.at[..., syms, :].set(
            f[..., syms[:, None], g.data_bins[phase][None, :]])
    return out


# ── bandwidth / sample-rate scaling (NB-DVB-T) ───────────────────────────────


def dvb_t_fs_for_bandwidth(occupied_hz: float) -> float:
    """fs = occupied_BW · 2048/1705."""
    return occupied_hz * DVB_T_N_FFT / DVB_T_ACTIVE_CARRIERS


def dvb_t_occupied_bw(fs: float) -> float:
    return fs * DVB_T_ACTIVE_CARRIERS / DVB_T_N_FFT


NB_BANDWIDTHS = {"333k": 333_000.0, "1m": 1_000_000.0, "2m": 2_000_000.0}
DVB_T_FS_333KHZ = dvb_t_fs_for_bandwidth(333_000.0)
DVB_T_FS_1MHZ = dvb_t_fs_for_bandwidth(1_000_000.0)
DVB_T_FS_2MHZ = dvb_t_fs_for_bandwidth(2_000_000.0)


# ── link assembly ────────────────────────────────────────────────────────────


def dvb_t_mcs_table():
    """QPSK r1/2, QPSK r2/3, 16-QAM r3/4 — all RS(204,188) outer."""
    from ..frame.types import Mcs, McsTable, OuterFec, InnerFec
    rs = OuterFec.reed_solomon(204, 16)
    conv = lambda r: InnerFec.convolutional(r, "dvb_k7")
    return McsTable([Mcs("qpsk", conv("1/2"), rs),
                     Mcs("qpsk", conv("2/3"), rs),
                     Mcs("qam16", conv("3/4"), rs)])


def dvb_t_config(guard: str, occupied_hz: float):
    """Continual-pilot DVB-T link config for the COFDM frame layer."""
    return _config_with_plan(dvb_t_2k_plan(guard), occupied_hz)


def dvb_t_scattered_config(guard: str, occupied_hz: float):
    """Conformant scattered-pilot link config (phase-0 representative plan)."""
    return _config_with_plan(dvb_t_2k_plans(guard)[0], occupied_hz) \
        .with_dvb_t_scattered(True)


def _config_with_plan(plan: CarrierPlan, occupied_hz: float):
    from ..ofdm import OfdmConfig
    from ..frame.types import ScramblerKind, InterleaverKind, \
        SCRAMBLER_BEFORE_OUTER
    return OfdmConfig(plan, fs=dvb_t_fs_for_bandwidth(occupied_hz),
                      constellation="qpsk") \
        .with_scrambler(ScramblerKind.dvb_t_energy_dispersal()) \
        .with_scrambler_pos(SCRAMBLER_BEFORE_OUTER) \
        .with_outer_interleaver(InterleaverKind.convolutional(12, 17))


# ── conformant-frame shared parameters ───────────────────────────────────────


def dvb_t_frame_outer():
    from ..frame.types import OuterFec
    return OuterFec.reed_solomon(204, 16)


def dvb_t_frame_outer_il():
    from ..frame.types import InterleaverKind
    return InterleaverKind.convolutional(12, 17)


@dataclass(frozen=True)
class DvbTLinkParams:
    """Guard, constellation, inner code rate — constant across a link."""
    guard: str = "1/32"
    constellation: str = "qpsk"
    code_rate: str = "1/2"


@dataclass(frozen=True)
class DvbTFrameParams:
    """One conformant frame's transmission parameters (ref DvbTFrameParams)."""
    link: DvbTLinkParams
    frame_number: int = 0
    cell_id: int = 0

    def inner(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate, "dvb_k7")

    def tps_word(self):
        from .dvb_t_tps import TpsWord
        return TpsWord(frame_number=self.frame_number,
                       constellation=self.link.constellation,
                       code_rate_hp=self.link.code_rate,
                       guard=self.link.guard, cell_id=self.cell_id)

    def config(self):
        from ..ofdm import OfdmConfig
        plan0 = dvb_t_2k_plans(self.link.guard)[0]
        return OfdmConfig(plan0, fs=dvb_t_fs_for_bandwidth(1_000_000.0),
                          constellation=self.link.constellation) \
            .with_dvb_t_scattered(True)


@dataclass(frozen=True)
class DvbTHierLinkParams:
    """Hierarchical link constants (§4.3.5/§5.1, beyond the reference):
    non-uniform 16-/64-QAM with two independently-coded transport streams —
    HP rides the 2 quadrant MSBs (an embedded QPSK), LP the remaining
    v−2 bits. ``alpha`` ∈ {1, 2, 4} sets quadrant separation (1 = uniform
    grid, hierarchy by multiplexing only)."""
    guard: str = "1/32"
    constellation: str = "qam16"     # qam16 | qam64
    alpha: int = 2
    code_rate_hp: str = "1/2"
    code_rate_lp: str = "3/4"

    def validate(self) -> None:
        if self.constellation not in ("qam16", "qam64"):
            raise ValueError("hierarchical DVB-T requires 16- or 64-QAM")
        if self.alpha not in DVB_T_ALPHAS:
            raise ValueError(f"alpha must be one of {DVB_T_ALPHAS}")


@dataclass(frozen=True)
class DvbTHierFrameParams:
    """One hierarchical frame's transmission parameters."""
    link: DvbTHierLinkParams
    frame_number: int = 0
    cell_id: int = 0

    def inner_hp(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate_hp, "dvb_k7")

    def inner_lp(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate_lp, "dvb_k7")

    def tps_word(self):
        from .dvb_t_tps import TpsWord
        return TpsWord(frame_number=self.frame_number,
                       constellation=self.link.constellation,
                       code_rate_hp=self.link.code_rate_hp,
                       guard=self.link.guard, cell_id=self.cell_id,
                       hierarchy=self.link.alpha,
                       code_rate_lp=self.link.code_rate_lp)


DVB_T_FRAMES_PER_SUPER_FRAME = 4


@dataclass(frozen=True)
class DvbTSuperFrameParams:
    """Link params + the full 16-bit cell id (ref DvbTSuperFrameParams,
    modulate/dvb_t_super_frame.rs:44-84). b15..b8 ride frames 1 & 3,
    b7..b0 frames 2 & 4."""
    link: DvbTLinkParams
    cell_id: int = 0

    def frame(self, frame_number: int) -> DvbTFrameParams:
        cell_byte = (self.cell_id >> 8) & 0xFF if frame_number % 2 == 0 \
            else self.cell_id & 0xFF
        return DvbTFrameParams(link=self.link, frame_number=frame_number,
                               cell_id=cell_byte)
