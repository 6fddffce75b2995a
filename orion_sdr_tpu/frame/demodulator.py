"""OFDM frame demodulators (behavioral spec: demodulate/ofdm_frame.rs).

soft_demap runs the whole symbol run as one batched tensor program
(symbol FFT → optional ZF equalize → grid extract → max-log LLRs); the
header/payload decode chains and the streaming feed/flush driver are host
orchestration around device kernels, holding an Incomplete frame rather than
mis-reporting it and skipping past a corrupt preamble on Failed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple, Union

import numpy as np
import jax.numpy as jnp

from ..ofdm import OfdmConfig, zf_equalize, OfdmRxFrame
from ..multicarrier import CarrierGrid, symbol_fft, grid_extract
from ..constellation import soft_llr, BITS_PER_SYMBOL
from ..dsp.osc import rotate_host
from ..dsp.device import cjit
from ..sync.ofdm_sync import OfdmPreamble, ofdm_sync
from .types import (FramePacket, FrameMetadata, McsTable, OuterFec, InnerFec,
                    InterleaverKind, ScramblerKind, RxError, header_has_block,
                    SCRAMBLER_BEFORE_OUTER)
from .chain import block_plan, decode_chain, decode_chain_batch
from .modulator import (HEADER_FIELD_BYTES, HEADER_CONSTELLATION, HEADER_LDPC,
                        header_block_plan, symbols_for_coded_bits)


class _Incomplete(Exception):
    """Streaming hold: not enough samples yet (ref BodyError::Incomplete)."""


@cjit
def soft_demap(cfg: OfdmConfig, constellation: str, iq, n_symbols: int,
               estimate=None) -> Optional[np.ndarray]:
    """IQ → LLRs for n_symbols OFDM symbols; None if iq is too short.

    ``estimate``: optional (n_fft,) channel for per-bin ZF equalization
    (the streaming training-symbol-hold path); None = flat channel.
    When ``cfg.equalizer_method == 'pilot_interp'`` and the plan carries
    pilots, the channel is instead re-estimated EVERY symbol by linear
    interpolation between the plan's pilot bins (ref
    EqualizerMethod::PerSymbolPilotInterp, demodulate/ofdm.rs:241-448) —
    here one interpolation matmul over the whole symbol run.
    """
    g = CarrierGrid(cfg.carrier_plan)
    sps = g.n_fft + g.cp_len
    z = jnp.asarray(iq)
    if z.shape[-1] < n_symbols * sps:
        return None
    z = z[..., : n_symbols * sps]
    freq = symbol_fft(z, g.n_fft, g.cp_len, backoff=cfg.rx_window_backoff,
                      n_symbols=n_symbols)
    csi = None
    if cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size:
        from ..ofdm import channel_estimate_pilots
        known = (g.pilot_values * np.complex64(cfg.gain))
        est = channel_estimate_pilots(freq, g.pilot_bins, known, g.n_fft)
        freq = zf_equalize(freq, est)
        csi = (jnp.abs(est) ** 2).astype(jnp.float32)
    elif estimate is not None:
        est = jnp.asarray(estimate)
        freq = zf_equalize(freq, est)
        csi = jnp.broadcast_to((jnp.abs(est) ** 2).astype(jnp.float32),
                               freq.shape)
    syms = grid_extract(g, freq)
    if cfg.transform_precoding:
        # DFT-s-OFDM: despread back to single-carrier constellation points
        # after the frequency-domain equalizer. The IDFT mixes every bin
        # into every output symbol, so per-bin CSI weighting no longer
        # applies (each coded bit already sees the average channel).
        from ..ofdm import dft_deprecode
        syms = dft_deprecode(syms)
        csi = None
    if cfg.phase_tracking == "cpe":
        from ..ofdm import cpe_correct
        syms, _ = cpe_correct(syms, constellation)
    flat = syms.reshape(syms.shape[:-2] + (-1,))
    llr = soft_llr(flat, constellation).astype(jnp.float32)
    if csi is not None:
        # CSI-weight (max-ratio): ZF amplifies noise 1/|h| on faded bins
        # while the max-log distances keep full confidence; scale each
        # data bin's LLRs by |h|^2/mean_sym(|h|^2). Flat channel => 1.
        # Per-symbol normalization keeps the sharded demap bit-equal.
        cd = grid_extract(g, csi)
        w = cd / jnp.maximum(jnp.mean(cd, axis=-1, keepdims=True), 1e-9)
        wflat = w.reshape(w.shape[:-2] + (-1,))
        bits = BITS_PER_SYMBOL[constellation]
        llr = (llr.reshape(wflat.shape + (bits,)) * wflat[..., None]
               ).reshape(llr.shape)
    return llr


def decode_frame_body(cfg: OfdmConfig, mcs_table: McsTable, iq,
                      channel_estimate=None,
                      ) -> Tuple[FramePacket, int]:
    """Decode header+payload from iq[0] (first sample AFTER preamble+training,
    CFO-corrected). Returns (packet, samples consumed). Raises _Incomplete
    (too short) or RxError (genuine failure). ref :456-613."""
    iq = np.asarray(iq)
    sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len
    cursor = 0

    if not header_has_block(cfg.header_format):
        # NoHeader / DvbTps links are decoded by their dedicated assemblers.
        raise RxError(RxError.MALFORMED_HEADER)

    hplan = header_block_plan(cfg)
    n_sym = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION, hplan.coded_bits)
    llrs = soft_demap(cfg, HEADER_CONSTELLATION, iq, n_sym, channel_estimate)
    if llrs is None:
        raise _Incomplete()
    fields, ok = decode_chain(
        llrs, hplan, cfg.header_crc, OuterFec.none(),
        InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
        InterleaverKind.none(), ScramblerKind.none(),
        SCRAMBLER_BEFORE_OUTER, 0,
        # header always decodes with exact sum-product (ref :532-535)
        ldpc_rule="sum_product")
    if not ok:
        raise RxError(RxError.HEADER_CRC_MISMATCH)
    if len(fields) < HEADER_FIELD_BYTES:
        raise RxError(RxError.MALFORMED_HEADER)
    mcs_index = int(fields[0])
    payload_len = int.from_bytes(bytes(fields[1:5]), "big")
    sequence_num = int.from_bytes(bytes(fields[5:9]), "big")
    flags = int(fields[9])
    seed = int.from_bytes(bytes(fields[10:14]), "big")
    cursor += n_sym * sps

    mcs = mcs_table.get(mcs_index)
    if mcs is None:
        raise RxError(RxError.MALFORMED_HEADER)
    pplan = block_plan(payload_len, cfg.payload_crc, mcs.outer_fec,
                       mcs.inner_fec, cfg.outer_interleaver,
                       cfg.inner_interleaver)
    n_sym = symbols_for_coded_bits(cfg, mcs.constellation, pplan.coded_bits)
    llrs = soft_demap(cfg, mcs.constellation, iq[cursor:], n_sym,
                      channel_estimate)
    if llrs is None:
        raise _Incomplete()
    data, ok = decode_chain(
        llrs, pplan, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
        cfg.outer_interleaver, cfg.inner_interleaver, cfg.scrambler,
        cfg.scrambler_pos, seed, ldpc_rule=cfg.ldpc_decode_rule)
    if not ok:
        raise RxError(RxError.CRC_MISMATCH)
    cursor += n_sym * sps
    payload = data[:payload_len]
    meta = FrameMetadata(sequence_num=sequence_num, mcs_index=mcs_index,
                         flags=flags)
    return FramePacket(meta, payload), cursor


class OfdmFrameDemod:
    """Batch demod at a KNOWN start (iq[0] = first post-preamble sample),
    flat channel (ref OfdmFrameDemod)."""

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 cache=None) -> None:
        self.cfg = cfg
        self.mcs_table = mcs_table

    def decode(self, iq) -> FramePacket:
        try:
            packet, _ = decode_frame_body(self.cfg, self.mcs_table, iq)
        except _Incomplete:
            raise RxError(RxError.MALFORMED_HEADER) from None
        return packet

    def decode_batch(self, iq_batch) -> List[Union[FramePacket, RxError]]:
        """Batched decode of B ALIGNED frame captures (iq[b, 0] = first
        post-preamble sample, flat channel) → per-frame FramePacket or
        RxError, in order.

        The batched throughput path the one-frame-per-call reference
        (demodulate/ofdm_frame.rs:616-646) has no analogue for: one device
        program demaps every header, ONE batched LDPC BP decodes them all,
        then frames group by (mcs_index, payload_len) and each group's
        payload demap + FEC chain runs batched across the group.
        """
        cfg = self.cfg
        iq_batch = np.asarray(iq_batch)
        assert iq_batch.ndim == 2
        n_frames = iq_batch.shape[0]
        sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len
        results: List[Union[FramePacket, RxError, None]] = [None] * n_frames

        hplan = header_block_plan(cfg)
        n_sym_h = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION,
                                         hplan.coded_bits)
        hllrs = soft_demap(cfg, HEADER_CONSTELLATION, iq_batch, n_sym_h)
        if hllrs is None:
            raise RxError(RxError.MALFORMED_HEADER)
        fields, hok = decode_chain_batch(
            hllrs, hplan, cfg.header_crc, OuterFec.none(),
            InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
            InterleaverKind.none(), ScramblerKind.none(),
            SCRAMBLER_BEFORE_OUTER, [0] * n_frames, ldpc_rule="sum_product")

        headers = [None] * n_frames   # (mcs_index, payload_len, seq, flags, seed)
        for b in range(n_frames):
            f = fields[b]
            if not hok[b] or f is None:
                results[b] = RxError(RxError.HEADER_CRC_MISMATCH)
            elif len(f) < HEADER_FIELD_BYTES:
                results[b] = RxError(RxError.MALFORMED_HEADER)
            else:
                headers[b] = (int(f[0]),
                              int.from_bytes(bytes(f[1:5]), "big"),
                              int.from_bytes(bytes(f[5:9]), "big"),
                              int(f[9]),
                              int.from_bytes(bytes(f[10:14]), "big"))

        cursor = n_sym_h * sps
        groups: dict = {}
        for b, h in enumerate(headers):
            if h is None:
                continue
            if self.mcs_table.get(h[0]) is None:
                results[b] = RxError(RxError.MALFORMED_HEADER)
                continue
            groups.setdefault((h[0], h[1]), []).append(b)

        for (mcs_index, payload_len), idxs in groups.items():
            mcs = self.mcs_table.get(mcs_index)
            pplan = block_plan(payload_len, cfg.payload_crc, mcs.outer_fec,
                               mcs.inner_fec, cfg.outer_interleaver,
                               cfg.inner_interleaver)
            n_sym = symbols_for_coded_bits(cfg, mcs.constellation,
                                           pplan.coded_bits)
            llr = soft_demap(cfg, mcs.constellation,
                             iq_batch[idxs, cursor:], n_sym)
            if llr is None:
                for b in idxs:
                    results[b] = RxError(RxError.MALFORMED_HEADER)
                continue
            datas, pok = decode_chain_batch(
                llr, pplan, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
                cfg.outer_interleaver, cfg.inner_interleaver, cfg.scrambler,
                cfg.scrambler_pos, [headers[b][4] for b in idxs],
                ldpc_rule=cfg.ldpc_decode_rule)
            for j, b in enumerate(idxs):
                if not pok[j] or datas[j] is None:
                    results[b] = RxError(RxError.CRC_MISMATCH)
                    continue
                h = headers[b]
                meta = FrameMetadata(sequence_num=h[2], mcs_index=h[0],
                                     flags=h[3])
                results[b] = FramePacket(meta, datas[j][:payload_len])
        return results


@dataclass
class RxFrame:
    """Received frame + RX diagnostics (ref RxFrame)."""
    packet: FramePacket
    diagnostics: OfdmRxFrame


class OfdmFrameStreamDemod:
    """Streaming receiver: feed IQ, poll frames/errors (ref :695-893).

    Per attempt: ofdm_sync → score ≥ threshold → total-CFO derotate →
    training-symbol channel estimate at the data back-off → decode →
    drain; Incomplete holds the buffer, Failed emits and skips the preamble.
    """

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 preamble: OfdmPreamble, score_threshold: float = 0.5,
                 cache=None) -> None:
        self.cfg = cfg
        self.mcs_table = mcs_table
        self.preamble = preamble
        self.score_threshold = score_threshold
        self._buf = np.zeros(0, np.complex64)

    def __len__(self) -> int:
        return len(self._buf)

    def view_buf(self) -> np.ndarray:
        return self._buf

    def clear(self) -> None:
        self._buf = np.zeros(0, np.complex64)

    def feed(self, iq) -> List[Union[RxFrame, RxError]]:
        from ..dsp.device import sanitize_iq
        self._buf = np.concatenate([self._buf, sanitize_iq(iq)])
        return self._drain()

    def flush(self) -> List[Union[RxFrame, RxError]]:
        return self._drain()

    def _drain(self):
        out = []
        while True:
            step = self._try_one_frame()
            if step is None:
                return out
            result, consume_to = step
            self._buf = self._buf[consume_to:]
            out.append(result)

    def _estimate_channel(self, corrected: np.ndarray):
        t = self.preamble.training_symbol
        if t is None:
            return None
        start = self.preamble.num_repeats * self.preamble.repeat_len
        end = start + t.n_fft + t.cp_len
        if len(corrected) < end:
            return None
        freq = symbol_fft(corrected[start:end], t.n_fft, t.cp_len,
                          backoff=self.cfg.rx_window_backoff, n_symbols=1)
        from ..sync.ofdm_sync import training_symbol_freq_pattern
        from ..ofdm import channel_estimate_denoise
        known = training_symbol_freq_pattern(t.n_fft) * self.cfg.gain
        raw = (np.asarray(freq)[0] / known).astype(np.complex64)
        # delay-domain denoise: any in-guard channel passes unchanged, the
        # single-symbol estimation noise drops by ~n_fft/(cp+backoff)
        return channel_estimate_denoise(raw, t.cp_len,
                                        self.cfg.rx_window_backoff)

    def _try_one_frame(self):
        n_fft = self.cfg.carrier_plan.n_fft
        cp_len = self.cfg.carrier_plan.cp_len
        pre_len = self.preamble.total_len()
        if len(self._buf) < pre_len + n_fft + cp_len:
            return None

        sync = ofdm_sync(self._buf, self.cfg.fs, self.preamble, 0,
                         len(self._buf))
        passing = [r for r in sync if r.score >= self.score_threshold]
        if not passing:
            # nothing acquirable in the buffer: keep only a tail long enough
            # to hold a preamble straddling the feed boundary, so dead air
            # neither grows the buffer nor makes every re-sync more expensive
            keep = pre_len + (n_fft + cp_len) * 4
            if len(self._buf) > keep:
                self._buf = self._buf[len(self._buf) - keep:]
            return None
        # Earliest among near-equal top scores: the sliding-sum metric can
        # jitter by an LSB between identical preambles, and decoding a LATER
        # frame first would drain an earlier one with it.
        top = max(r.score for r in passing)
        best = min((r for r in passing if r.score >= top - 1e-3),
                   key=lambda r: r.start_sample)

        spacing = self.cfg.fs / n_fft
        total_cfo = best.cfo_hz + best.integer_cfo_bins * spacing
        corrected, _ = rotate_host(self._buf[best.start_sample:],
                                   np.float32(-total_cfo), self.cfg.fs)
        if len(corrected) < pre_len:
            return None
        est = self._estimate_channel(corrected)
        body = corrected[pre_len:]
        try:
            packet, body_samples = decode_frame_body(
                self.cfg, self.mcs_table, body, est)
        except _Incomplete:
            return None
        except RxError as e:
            skip = min(best.start_sample + pre_len, len(self._buf))
            return e, skip
        diagnostics = OfdmRxFrame(
            bits=np.zeros(0, np.uint8), num_symbols=0, evm_db=None,
            cfo_hz=float(total_cfo),
            timing_offset_samples=int(best.start_sample), channel_mse=None)
        consume_to = best.start_sample + pre_len + body_samples
        if consume_to > len(self._buf):
            return None
        return RxFrame(packet=packet, diagnostics=diagnostics), consume_to
