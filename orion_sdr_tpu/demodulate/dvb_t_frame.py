"""Conformant DVB-T frame demodulator (behavioral spec:
demodulate/dvb_t_frame.rs). GI acquisition (van de Beek) → per-symbol FFT →
TPS from the raw bins → scattered-pilot per-symbol equalization → Figure-9a
soft LLRs → RS + Viterbi decode → un-disperse → depacketize.

Design: all n_symbols FFT/equalize/LLR stages run as one batched tensor
program; the per-symbol pilot interpolation groups symbols by the four
scattered phases (4 vectorized calls instead of n_symbols loop iterations).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..multicarrier import symbol_fft
from ..constellation import BITS_PER_SYMBOL
from ..ofdm import zf_equalize, channel_estimate_pilots
from ..dsp.osc import rotate_host
from ..dsp.device import cjit
from ..frame.chain import block_plan, decode_chain
from ..frame.types import (InterleaverKind, ScramblerKind, RxError,
                           SCRAMBLER_BEFORE_OUTER)
from ..sync.dvb_t_gi_sync import dvb_t_gi_sync, dvb_t_integer_cfo
from ..waveform.dvb_t import (
    DVB_T_N_FFT, DVB_T_DATA_CARRIERS, DVB_T_SCATTERED_PHASES, DvbTFrameParams,
    DvbTHierFrameParams,
    guard_cp_len_2k, scattered_grid, scattered_extract_frame, dvb_t_soft_llrs,
    tps_carrier_bins, dvb_t_frame_outer, dvb_t_frame_outer_il,
)
from ..waveform.dvb_t_tps import (
    tps_decode_frame, TpsWord, TPS_SYMBOLS_PER_FRAME,
)
from ..waveform.dvb_t_ts import (
    TS_PACKET_LEN, TS_PAYLOAD_LEN, ts_energy_disperse, ts_depacketize,
)

INTEGER_CFO_ACCUM_SYMBOLS = 8
INTEGER_CFO_MAX_BINS = 32

# what the payload chain raises on a corrupt frame (RS/BCH failures are
# ValueErrors); anything else, such as a device or kernel-build fault,
# reaches the caller
_CORRUPT_PAYLOAD = (RxError, ValueError)


class DvbTRxError(Exception):
    ACQUISITION = "guard-interval acquisition failed"
    INCOMPLETE = "too few samples for the expected frame"
    TPS_DECODE = "TPS word failed to decode"
    PAYLOAD_DECODE = "payload FEC decode failed"

    def __init__(self, kind: str) -> None:
        super().__init__(kind)
        self.kind = kind


class DvbTRxFrame(NamedTuple):
    payload: np.ndarray
    tps: TpsWord


@cjit
def scattered_equalize_csi(freq, first_phase: int = 0, backoff: int = 0):
    """(..., n_sym, 2048) raw spectra → (ZF-equalized spectra, |ĥ|² CSI);
    symbols grouped by the four scattered phases (vectorized).

    Fast path (n_sym % 4 == 0, phase 0): phases become a strided reshape so
    every phase works on a contiguous slab and the result restacks with one
    reshape — no full-tensor at[].set scatters.

    The CSI plane exists because ZF equalization amplifies noise by 1/|h|
    on faded carriers while the max-log LLRs keep full confidence — on a
    frequency-selective channel the Viterbi then trusts exactly the wrong
    bits. Weighting LLRs by |ĥ|² (max-ratio combining) restores the proper
    per-carrier reliability; on a flat channel the normalized weight is 1
    and nothing changes. (Found by the channel simulator's echo-margin
    sweep: a −6 dB in-guard echo at 6 dB SNR failed UNweighted.)"""
    g = scattered_grid()
    f = jnp.asarray(freq)
    n_sym = f.shape[-2]
    P = DVB_T_SCATTERED_PHASES
    if first_phase == 0 and n_sym % P == 0 and n_sym:
        fb = f.reshape(f.shape[:-2] + (n_sym // P, P, f.shape[-1]))
        cols, mags = [], []
        for phase in range(P):
            sub = fb[..., phase, :]
            est = channel_estimate_pilots(sub, np.asarray(g.ref_bins[phase]),
                                          np.asarray(g.ref_vals[phase]),
                                          DVB_T_N_FFT)
            cols.append(zf_equalize(sub, est))
            mags.append((jnp.abs(est) ** 2).astype(jnp.float32))
        out = jnp.stack(cols, axis=-2).reshape(f.shape)
        csi = jnp.stack(mags, axis=-2).reshape(f.shape)
        return out, csi
    out = f
    csi = jnp.ones(f.shape, jnp.float32)
    for phase in range(P):
        syms = np.arange(n_sym)[(np.arange(n_sym) + first_phase) % P == phase]
        if len(syms) == 0:
            continue
        sub = f[..., syms, :]
        est = channel_estimate_pilots(sub, np.asarray(g.ref_bins[phase]),
                                      np.asarray(g.ref_vals[phase]),
                                      DVB_T_N_FFT)
        out = out.at[..., syms, :].set(zf_equalize(sub, est))
        csi = csi.at[..., syms, :].set((jnp.abs(est) ** 2
                                        ).astype(jnp.float32))
    return out, csi


def scattered_equalize(freq, first_phase: int = 0, backoff: int = 0):
    """Equalized spectra only (back-compat surface over the CSI variant)."""
    return scattered_equalize_csi(freq, first_phase, backoff)[0]


@dataclass
class DvbTFrameDemod:
    """Batch demod of one conformant frame (ref DvbTFrameDemod)."""

    params: DvbTFrameParams
    integer_cfo: bool = False
    rx_window_backoff: int = 0

    def with_integer_cfo_correction(self, on: bool = True) -> "DvbTFrameDemod":
        return DvbTFrameDemod(self.params, on, self.rx_window_backoff)

    def with_rx_window_backoff(self, backoff: int) -> "DvbTFrameDemod":
        return DvbTFrameDemod(self.params, self.integer_cfo, backoff)

    # fs only scales CFO units for baseband frames
    @property
    def fs(self) -> float:
        from ..waveform.dvb_t import dvb_t_fs_for_bandwidth
        return dvb_t_fs_for_bandwidth(1_000_000.0)

    def _integer_cfo_correct(self, iq: np.ndarray, cp_len: int):
        if not self.integer_cfo:
            return None
        sps = DVB_T_N_FFT + cp_len
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            return None
        n_acc = min(INTEGER_CFO_ACCUM_SYMBOLS,
                    (len(iq) - acq.start_sample) // sps)
        if n_acc == 0:
            return None
        seg = iq[acq.start_sample: acq.start_sample + n_acc * sps]
        freq = np.asarray(symbol_fft(seg, DVB_T_N_FFT, cp_len,
                                     n_symbols=n_acc))
        accum = np.sum(np.abs(freq) ** 2, axis=0)
        est = dvb_t_integer_cfo(accum.astype(np.complex64), DVB_T_N_FFT,
                                INTEGER_CFO_MAX_BINS)
        if est is None or est.bins == 0:
            return None
        z, _ = rotate_host(iq, np.float32(-est.bins * self.fs / DVB_T_N_FFT),
                           self.fs)
        return z

    def decode(self, iq, n_symbols: int, payload_len: int) -> DvbTRxFrame:
        params = self.params
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        iq = np.asarray(iq)

        corrected = self._integer_cfo_correct(iq, cp_len)
        if corrected is not None:
            iq = corrected

        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            raise DvbTRxError(DvbTRxError.ACQUISITION)
        start = acq.start_sample
        if len(iq) < start + n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)

        llrs, cells = _receive_frame(iq[start: start + n_symbols * sps],
                                     n_symbols, cp_len,
                                     self.rx_window_backoff, vbits)
        llrs = llrs.reshape(-1)
        tps_word = None
        for blk in range(n_symbols // TPS_SYMBOLS_PER_FRAME):
            bits = tps_decode_frame(
                cells[blk * TPS_SYMBOLS_PER_FRAME:(blk + 1) * TPS_SYMBOLS_PER_FRAME])
            tps_word = TpsWord.unpack(bits)
            if tps_word is not None:
                break
        if tps_word is None:
            raise DvbTRxError(DvbTRxError.TPS_DECODE)

        # Payload FEC decode for the real-payload packets only (shared
        # with decode_batch).
        return self._decode_payload(llrs, payload_len, tps_word)


    def decode_batch(self, iq_batch, n_symbols: int, payload_len: int):
        """Batched receive: (B, n) ALIGNED frame captures → list of
        DvbTRxFrame. The throughput path (BASELINE.json): the fused
        receive runs all frames as one device program; the payload FEC
        (Viterbi, Forney, RS) then runs frame by frame. Callers with
        unknown offsets acquire per-frame (decode) or via the stream
        driver; this path serves channelized/sliced aligned captures."""
        params = self.params
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        iq_batch = np.asarray(iq_batch)
        assert iq_batch.ndim == 2
        if iq_batch.shape[1] < n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)
        llrs, cells = _receive_frame(iq_batch[:, : n_symbols * sps],
                                     n_symbols, cp_len,
                                     self.rx_window_backoff, vbits)
        out = []
        for b in range(iq_batch.shape[0]):
            tps_word = None
            for blk in range(n_symbols // TPS_SYMBOLS_PER_FRAME):
                bits = tps_decode_frame(
                    cells[b, blk * TPS_SYMBOLS_PER_FRAME:
                          (blk + 1) * TPS_SYMBOLS_PER_FRAME])
                tps_word = TpsWord.unpack(bits)
                if tps_word is not None:
                    break
            if tps_word is None:
                raise DvbTRxError(DvbTRxError.TPS_DECODE)
            out.append(self._decode_payload(llrs[b].reshape(-1), payload_len,
                                            tps_word))
        return out

    def _decode_payload(self, llrs, payload_len: int, tps_word) -> DvbTRxFrame:
        params = self.params
        n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
        ts_len = n_ts * TS_PACKET_LEN
        plan = block_plan(ts_len, "none", dvb_t_frame_outer(), params.inner(),
                          dvb_t_frame_outer_il(), InterleaverKind.none())
        try:
            ts, ok = decode_chain(
                llrs, plan, "none", dvb_t_frame_outer(), params.inner(),
                dvb_t_frame_outer_il(), InterleaverKind.none(),
                ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0)
        except _CORRUPT_PAYLOAD as e:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE) from e
        if not ok or len(ts) < ts_len:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
        ts = ts_energy_disperse(ts[:ts_len])
        payload = ts_depacketize(ts)
        if payload is None:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
        return DvbTRxFrame(payload=payload[:payload_len], tps=tps_word)


def _receive_frame_body(seg, n_symbols: int, cp_len: int, backoff: int,
                        vbits: int, alpha: int = 1):
    """Pure-jax body of the fused receive (also embedded directly by the
    on-device benchmark harness and the sharded receive)."""
    freq = symbol_fft(seg, DVB_T_N_FFT, cp_len, backoff=backoff,
                      n_symbols=n_symbols)
    cells = freq[..., jnp.asarray(tps_carrier_bins())]
    eq, csi_full = scattered_equalize_csi(freq, backoff=backoff)
    data = scattered_extract_frame(eq)
    llrs = dvb_t_soft_llrs(data, vbits, alpha)
    # CSI-weight the LLRs (max-ratio): ZF boosts noise 1/|h| on faded
    # carriers while max-log distances keep full confidence; scaling each
    # carrier's vbits LLRs by |h|²/mean(|h|²) restores per-bit reliability.
    # Flat channel ⇒ weight ≡ 1 (AWGN behavior unchanged). Normalized per
    # SYMBOL (axis −1), not per frame, so the time-sharded receive — which
    # runs this body on symbol sub-ranges — produces identical weights.
    csi = scattered_extract_frame(csi_full)
    w = csi / jnp.maximum(jnp.mean(csi, axis=-1, keepdims=True), 1e-9)
    shaped = llrs.reshape(csi.shape + (vbits,)) * w[..., None]
    return shaped.reshape(llrs.shape), cells


@cjit
def _receive_frame(seg, n_symbols: int, cp_len: int, backoff: int, vbits: int,
                   alpha: int = 1):
    """The whole per-frame device program: symbol FFT → per-phase
    scattered-pilot equalization → data extraction → Figure-9a LLRs, plus the
    raw TPS cells — ONE jit, two host fetches."""
    return _receive_frame_body(seg, n_symbols, cp_len, backoff, vbits, alpha)


@cjit
def _tps_cells_only(seg, n_symbols: int, cp_len: int):
    """Light pre-pass: symbol FFT → raw TPS-carrier cells (for blind TPS
    alignment before the constellation is known)."""
    freq = symbol_fft(seg, DVB_T_N_FFT, cp_len, n_symbols=n_symbols)
    return freq[..., jnp.asarray(tps_carrier_bins())]


class DvbTBlindFrame(NamedTuple):
    """Blind receive result: the transport payload (null stuffing
    stripped; zero padding of the last real packet retained — the TS layer
    carries no finer length), the signalled parameters, and the LP payload
    when the TPS announced hierarchy."""
    payload: np.ndarray
    tps: TpsWord
    guard: str
    n_symbols: int
    lp_payload: Optional[np.ndarray] = None


def _strip_null_packets(ts: np.ndarray) -> np.ndarray:
    rows = ts.reshape(-1, TS_PACKET_LEN)
    real = ~((rows[:, 1] == 0x1F) & (rows[:, 2] == 0xFF))
    keep = rows[real]
    return keep[:, 1:].reshape(-1).copy()


def dvb_t_blind_decode(iq, max_symbols: int = 272) -> DvbTBlindFrame:
    """Fully blind DVB-T 2K receive (beyond the reference, whose receivers
    need guard/constellation/rate/length up front): try all four guard
    intervals on the GI metric, align the TPS block by its sync word,
    configure the FEC chain from the decoded TPS (including hierarchy),
    and recover the transport payload — its extent comes from the TS
    layer itself (null packets stripped)."""
    from ..waveform.dvb_t import (GUARD_INTERVALS, DvbTHierLinkParams,
                                  DvbTHierFrameParams,
                                  dvb_t_fs_for_bandwidth)
    iq = np.asarray(iq)
    fs = dvb_t_fs_for_bandwidth(1_000_000.0)

    best = None
    for guard, cp_len in GUARD_INTERVALS.items():
        sps = DVB_T_N_FFT + cp_len
        if len(iq) < sps * 5:
            continue
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fs, sps)
        if acq is not None and (best is None or acq.score > best[2].score):
            best = (guard, cp_len, acq)
    if best is None:
        raise DvbTRxError(DvbTRxError.ACQUISITION)
    guard, cp_len, acq = best
    sps = DVB_T_N_FFT + cp_len
    start = acq.start_sample
    avail = (len(iq) - start) // sps
    if avail < TPS_SYMBOLS_PER_FRAME:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)

    # TPS alignment: slide a 68-symbol window until the word decodes
    probe = min(avail, 2 * TPS_SYMBOLS_PER_FRAME + 4)
    cells = _tps_cells_only(iq[start: start + probe * sps], probe, cp_len)
    tps_word, frame_off = None, None
    for off in range(0, probe - TPS_SYMBOLS_PER_FRAME + 1):
        bits = tps_decode_frame(cells[off: off + TPS_SYMBOLS_PER_FRAME])
        tps_word = TpsWord.unpack(bits)
        if tps_word is not None:
            frame_off = off
            break
    if tps_word is None:
        raise DvbTRxError(DvbTRxError.TPS_DECODE)

    fstart = start + frame_off * sps
    n_symbols = (len(iq) - fstart) // sps
    n_symbols = max((n_symbols // 4) * 4, TPS_SYMBOLS_PER_FRAME)
    n_symbols = min(n_symbols, max_symbols)
    if (len(iq) - fstart) // sps < n_symbols:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)

    vbits = BITS_PER_SYMBOL[tps_word.constellation]
    seg = iq[fstart: fstart + n_symbols * sps]
    # capacity candidates: the whole capture (one long frame), else the
    # largest 68-multiple, else one 68-symbol frame — the capture may hold
    # several frames whose coded streams each restart, so on a failure the
    # decode retries over a shorter symbol PREFIX of the same LLR stream
    cands = []
    for n in (n_symbols, (n_symbols // TPS_SYMBOLS_PER_FRAME)
              * TPS_SYMBOLS_PER_FRAME, TPS_SYMBOLS_PER_FRAME):
        if n >= TPS_SYMBOLS_PER_FRAME and n not in cands:
            cands.append(n)

    if tps_word.hierarchy:
        link = DvbTHierLinkParams(
            guard=guard, constellation=tps_word.constellation,
            alpha=tps_word.hierarchy, code_rate_hp=tps_word.code_rate_hp,
            code_rate_lp=tps_word.code_rate_lp or tps_word.code_rate_hp)
        params = DvbTHierFrameParams(link=link)
        llrs, _ = _receive_frame(seg, n_symbols, cp_len, 0, vbits,
                                 link.alpha)
        per_cell = llrs.reshape(n_symbols, -1, vbits)
        for n in cands:
            hp = _blind_stream(
                np.ascontiguousarray(per_cell[:n, :, :2]).reshape(-1),
                params.inner_hp(), n * DVB_T_DATA_CARRIERS * 2)
            if hp is None:
                continue
            lp = _blind_stream(
                np.ascontiguousarray(per_cell[:n, :, 2:]).reshape(-1),
                params.inner_lp(), n * DVB_T_DATA_CARRIERS * (vbits - 2))
            return DvbTBlindFrame(payload=hp, tps=tps_word, guard=guard,
                                  n_symbols=n, lp_payload=lp)
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)

    from ..frame.types import InnerFec
    inner = InnerFec.convolutional(tps_word.code_rate_hp, "dvb_k7")
    llrs = np.asarray(_receive_frame(seg, n_symbols, cp_len, 0, vbits)[0]
                      ).reshape(n_symbols, -1)
    for n in cands:
        payload = _blind_stream(
            np.ascontiguousarray(llrs[:n]).reshape(-1), inner,
            n * DVB_T_DATA_CARRIERS * vbits)
        if payload is not None:
            return DvbTBlindFrame(payload=payload, tps=tps_word,
                                  guard=guard, n_symbols=n)
    raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)


def _blind_coded_bits(n_ts: int, inner) -> int:
    return block_plan(n_ts * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      inner, dvb_t_frame_outer_il(),
                      InterleaverKind.none()).coded_bits


def _blind_stream(llrs: np.ndarray, inner, capacity: int):
    """Decode the largest whole-packet TS prefix that fits the capacity,
    un-disperse, validate syncs, strip null packets."""
    n_ts = 1
    while _blind_coded_bits(n_ts + 1, inner) <= capacity:
        n_ts += 1
    if _blind_coded_bits(n_ts, inner) > capacity:
        return None
    plan = block_plan(n_ts * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      inner, dvb_t_frame_outer_il(), InterleaverKind.none())
    try:
        ts, ok = decode_chain(
            llrs[:plan.coded_bits], plan, "none", dvb_t_frame_outer(), inner,
            dvb_t_frame_outer_il(), InterleaverKind.none(),
            ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0)
    except _CORRUPT_PAYLOAD:
        return None
    if not ok or len(ts) < n_ts * TS_PACKET_LEN:
        return None
    ts = ts_energy_disperse(ts[: n_ts * TS_PACKET_LEN])
    rows = np.asarray(ts, np.uint8).reshape(-1, TS_PACKET_LEN)
    if not np.all(rows[:, 0] == 0x47):
        return None
    return _strip_null_packets(np.asarray(ts, np.uint8))


class DvbTHierRxFrame(NamedTuple):
    """Hierarchical receive result: HP always present (decode raises if the
    HP stream fails — the frame is then useless); LP is None when its FEC
    failed but HP survived — the graceful-degradation contract hierarchy
    exists to provide."""
    hp_payload: np.ndarray
    lp_payload: Optional[np.ndarray]
    tps: TpsWord


@dataclass
class DvbTHierFrameDemod:
    """Hierarchical frame demod (EN 300 744 §4.3.5/§5.1 — beyond the
    reference): one fused receive program computes non-uniform-grid LLRs for
    every cell; the HP (quadrant MSBs) and LP (remaining bits) LLR planes
    then decode through their own RS + Forney + K=7 chains."""

    params: "DvbTHierFrameParams"
    rx_window_backoff: int = 0

    def with_rx_window_backoff(self, backoff: int) -> "DvbTHierFrameDemod":
        return DvbTHierFrameDemod(self.params, backoff)

    @property
    def fs(self) -> float:
        from ..waveform.dvb_t import dvb_t_fs_for_bandwidth
        return dvb_t_fs_for_bandwidth(1_000_000.0)

    def decode(self, iq, n_symbols: int, hp_payload_len: int,
               lp_payload_len: int) -> DvbTHierRxFrame:
        params = self.params
        params.link.validate()
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        iq = np.asarray(iq)

        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            raise DvbTRxError(DvbTRxError.ACQUISITION)
        start = acq.start_sample
        if len(iq) < start + n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)

        llrs, cells = _receive_frame(iq[start: start + n_symbols * sps],
                                     n_symbols, cp_len,
                                     self.rx_window_backoff, vbits,
                                     params.link.alpha)
        tps_word = None
        for blk in range(n_symbols // TPS_SYMBOLS_PER_FRAME):
            bits = tps_decode_frame(
                cells[blk * TPS_SYMBOLS_PER_FRAME:
                      (blk + 1) * TPS_SYMBOLS_PER_FRAME])
            tps_word = TpsWord.unpack(bits)
            if tps_word is not None:
                break
        if tps_word is None:
            raise DvbTRxError(DvbTRxError.TPS_DECODE)

        # demultiplex the per-cell LLRs into the two priority planes
        per_cell = llrs.reshape(-1, vbits)
        hp_llrs = np.ascontiguousarray(per_cell[:, :2]).reshape(-1)
        lp_llrs = np.ascontiguousarray(per_cell[:, 2:]).reshape(-1)

        hp = self._decode_stream(hp_llrs, params.inner_hp(), hp_payload_len)
        if hp is None:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
        lp = self._decode_stream(lp_llrs, params.inner_lp(), lp_payload_len)
        return DvbTHierRxFrame(hp_payload=hp, lp_payload=lp, tps=tps_word)

    def _decode_stream(self, llrs, inner, payload_len: int):
        n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
        ts_len = n_ts * TS_PACKET_LEN
        plan = block_plan(ts_len, "none", dvb_t_frame_outer(), inner,
                          dvb_t_frame_outer_il(), InterleaverKind.none())
        try:
            ts, ok = decode_chain(
                llrs, plan, "none", dvb_t_frame_outer(), inner,
                dvb_t_frame_outer_il(), InterleaverKind.none(),
                ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0)
        except _CORRUPT_PAYLOAD:
            return None
        if not ok or len(ts) < ts_len:
            return None
        ts = ts_energy_disperse(ts[:ts_len])
        payload = ts_depacketize(ts)
        if payload is None:
            return None
        return payload[:payload_len]
