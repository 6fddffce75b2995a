"""Conformant DVB-T frame modulator (behavioral spec: modulate/dvb_t_frame.rs;
ETSI EN 300 744). Preamble-less: TS packets + energy dispersal → RS(204,188)
+ K=7 conv + Forney I=12 → Figure-9a mapping through the four-phase
scattered-pilot grid → TPS DBPSK on the 17 reserved carriers → IFFT + CP.

Design: the whole frame is one batched tensor program — map all symbols'
bits at once, one vectorized grid scatter, one (n_sym, 2048) IFFT — no
per-symbol loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..multicarrier import ofdm_assemble, symbol_taper, TxLowpass
from ..dsp.device import cjit
from ..constellation import BITS_PER_SYMBOL
from ..frame.chain import block_plan, encode_chain
from ..frame.types import InterleaverKind, ScramblerKind, SCRAMBLER_BEFORE_OUTER
from ..waveform.dvb_t import (
    DVB_T_N_FFT, DVB_T_KMAX, DVB_T_DATA_CARRIERS, DvbTFrameParams,
    DvbTHierFrameParams,
    guard_cp_len_2k, dvb_t_map_symbols, scattered_map_frame, tps_carrier_bins,
    dvb_t_frame_outer, dvb_t_frame_outer_il,
)
from ..waveform.dvb_t_tps import tps_encode_frame, TPS_SYMBOLS_PER_FRAME
from ..waveform.dvb_t_ts import (
    TS_PACKET_LEN, ts_packetize, ts_stuff_null_packets, ts_energy_disperse,
)


class DvbTFrame(NamedTuple):
    """Modulated frame + the numerology a receiver needs (ref DvbTFrame)."""
    iq: np.ndarray
    n_symbols: int
    samples_per_symbol: int


def tx_lowpass_for_2k(num_taps: int, stopband_db: float) -> TxLowpass:
    """Spectral mask sized for the 2K band edge (active ±852 of 2048)."""
    return TxLowpass.for_null_band(DVB_T_N_FFT, DVB_T_KMAX // 2, num_taps,
                                   stopband_db)


def _coded_bits_for_packets(n_pkt: int, params: DvbTFrameParams) -> int:
    return block_plan(n_pkt * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      params.inner(), dvb_t_frame_outer_il(),
                      InterleaverKind.none()).coded_bits


@dataclass
class DvbTFrameMod:
    """One-frame-per-call DVB-T modulator (ref DvbTFrameMod)."""

    params: DvbTFrameParams
    window_roll_off: int = 0
    tx_lowpass: Optional[TxLowpass] = None

    def with_symbol_window(self, roll_off: int) -> "DvbTFrameMod":
        return DvbTFrameMod(self.params, roll_off, self.tx_lowpass)

    def with_tx_lowpass(self, lowpass: TxLowpass) -> "DvbTFrameMod":
        return DvbTFrameMod(self.params, self.window_roll_off, lowpass)

    def modulate(self, payload) -> DvbTFrame:
        params = self.params
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        bits_per_sym = DVB_T_DATA_CARRIERS * vbits

        # 1. TS-packetize; frame spans max(payload symbols, 68) so a full TPS
        #    block is present.
        ts = ts_packetize(np.frombuffer(bytes(payload), np.uint8)
                          if isinstance(payload, (bytes, bytearray))
                          else np.asarray(payload, np.uint8))
        n_real = len(ts) // TS_PACKET_LEN
        payload_bits = _coded_bits_for_packets(n_real, params)
        payload_syms = -(-payload_bits // bits_per_sym)
        n_symbols = max(payload_syms, TPS_SYMBOLS_PER_FRAME)

        # 2. Null-packet stuffing until the coded stream fills every data
        #    carrier (§4.4), then energy dispersal over the whole TS stream.
        capacity_bits = n_symbols * bits_per_sym
        target = max(n_real, 1)
        while _coded_bits_for_packets(target, params) < capacity_bits:
            target += 1
        ts = ts_stuff_null_packets(ts, target)
        ts = ts_energy_disperse(ts)

        # 3. Payload FEC (no CRC, no extra scrambler — dispersal was TS-keyed).
        coded = encode_chain(ts, "none", dvb_t_frame_outer(), params.inner(),
                             dvb_t_frame_outer_il(), InterleaverKind.none(),
                             ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0)
        assert len(coded) >= capacity_bits

        # 4.-5. Figure-9a map, rotating-grid scatter, TPS overwrite, IFFT+CP
        #    (+ optional taper) — one device program per frame geometry.
        tps_block = params.tps_word().pack()
        cells = tps_encode_frame(tps_block)          # (68, 17)
        reps = -(-n_symbols // TPS_SYMBOLS_PER_FRAME)
        cells_all = np.tile(cells, (reps, 1))[:n_symbols]
        iq = _assemble_frame(coded[:capacity_bits], cells_all, vbits,
                             n_symbols, cp_len, self.window_roll_off)
        if self.tx_lowpass is not None:
            iq = self.tx_lowpass.apply(iq)
        return DvbTFrame(iq=np.asarray(iq).astype(np.complex64),
                         n_symbols=n_symbols, samples_per_symbol=sps)


@cjit
def _assemble_frame(coded_bits, tps_cells, vbits: int, n_symbols: int,
                    cp_len: int, window_roll_off: int, alpha: int = 1):
    """Map → scatter (rotating grid) → TPS overwrite → IFFT+CP (+taper)."""
    data = dvb_t_map_symbols(coded_bits, vbits, alpha)
    data = data.reshape(n_symbols, DVB_T_DATA_CARRIERS)
    freq = scattered_map_frame(data)
    freq = freq.at[:, tps_carrier_bins()].set(jnp.asarray(tps_cells))
    taper = symbol_taper(DVB_T_N_FFT + cp_len, window_roll_off) \
        if window_roll_off else None
    return ofdm_assemble(freq, cp_len, taper=taper)


# ── hierarchical transmission (§4.3.5/§5.1 — beyond the reference) ───────────


def _coded_bits_for_stream(n_pkt: int, inner) -> int:
    return block_plan(n_pkt * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      inner, dvb_t_frame_outer_il(),
                      InterleaverKind.none()).coded_bits


def _prepare_stream(payload, inner, capacity_bits: int) -> np.ndarray:
    """TS-packetize → null-stuff to the symbol capacity → energy dispersal →
    RS + Forney + conv encode; returns exactly ``capacity_bits`` coded bits."""
    ts = ts_packetize(np.frombuffer(bytes(payload), np.uint8)
                      if isinstance(payload, (bytes, bytearray))
                      else np.asarray(payload, np.uint8))
    target = max(len(ts) // TS_PACKET_LEN, 1)
    while _coded_bits_for_stream(target, inner) < capacity_bits:
        target += 1
    ts = ts_stuff_null_packets(ts, target)
    ts = ts_energy_disperse(ts)
    coded = encode_chain(ts, "none", dvb_t_frame_outer(), inner,
                         dvb_t_frame_outer_il(), InterleaverKind.none(),
                         ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0)
    assert len(coded) >= capacity_bits
    return np.asarray(coded[:capacity_bits], np.uint8)


@dataclass
class DvbTHierFrameMod:
    """Hierarchical DVB-T modulator: two transport streams per frame — HP
    on the 2 quadrant MSBs of a non-uniform 16-/64-QAM cell (an embedded
    QPSK that survives lower SNR), LP on the remaining v−2 bits — each with
    its own RS(204,188) + Forney + K=7 inner code (EN 300 744 §4.3.5/§5.1;
    the reference implements only the non-hierarchical path)."""

    params: "DvbTHierFrameParams"
    window_roll_off: int = 0
    tx_lowpass: Optional[TxLowpass] = None

    def with_symbol_window(self, roll_off: int) -> "DvbTHierFrameMod":
        return DvbTHierFrameMod(self.params, roll_off, self.tx_lowpass)

    def with_tx_lowpass(self, lowpass: TxLowpass) -> "DvbTHierFrameMod":
        return DvbTHierFrameMod(self.params, self.window_roll_off, lowpass)

    def modulate(self, hp_payload, lp_payload) -> DvbTFrame:
        params = self.params
        params.link.validate()
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        hp_per_sym = DVB_T_DATA_CARRIERS * 2
        lp_per_sym = DVB_T_DATA_CARRIERS * (vbits - 2)

        def syms_for(payload, inner, per_sym):
            raw = np.frombuffer(bytes(payload), np.uint8) \
                if isinstance(payload, (bytes, bytearray)) \
                else np.asarray(payload, np.uint8)
            n_pkt = len(ts_packetize(raw)) // TS_PACKET_LEN
            return -(-_coded_bits_for_stream(n_pkt, inner) // per_sym)

        n_symbols = max(syms_for(hp_payload, params.inner_hp(), hp_per_sym),
                        syms_for(lp_payload, params.inner_lp(), lp_per_sym),
                        TPS_SYMBOLS_PER_FRAME)

        hp = _prepare_stream(hp_payload, params.inner_hp(),
                             n_symbols * hp_per_sym)
        lp = _prepare_stream(lp_payload, params.inner_lp(),
                             n_symbols * lp_per_sym)
        # multiplex: per cell, [hp0, hp1, lp0..lp(v-3)] = y0..y(v-1)
        n_cells = n_symbols * DVB_T_DATA_CARRIERS
        bits = np.concatenate([hp.reshape(n_cells, 2),
                               lp.reshape(n_cells, vbits - 2)],
                              axis=-1).reshape(-1)

        tps_block = params.tps_word().pack()
        cells = tps_encode_frame(tps_block)
        reps = -(-n_symbols // TPS_SYMBOLS_PER_FRAME)
        cells_all = np.tile(cells, (reps, 1))[:n_symbols]
        iq = _assemble_frame(bits, cells_all, vbits, n_symbols, cp_len,
                             self.window_roll_off, params.link.alpha)
        if self.tx_lowpass is not None:
            iq = self.tx_lowpass.apply(iq)
        return DvbTFrame(iq=np.asarray(iq).astype(np.complex64),
                         n_symbols=n_symbols, samples_per_symbol=sps)
