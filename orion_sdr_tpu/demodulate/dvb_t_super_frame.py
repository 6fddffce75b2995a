"""DVB-T super-frame demodulator (behavioral spec:
demodulate/dvb_t_super_frame.rs): four per-frame decodes, frame-number
sequence 0,1,2,3 verified, 16-bit cell id reassembled, payloads concatenated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from ..waveform.dvb_t import (DVB_T_N_FFT, guard_cp_len_2k,
                              DvbTSuperFrameParams,
                              DVB_T_FRAMES_PER_SUPER_FRAME)
from .dvb_t_frame import DvbTFrameDemod, DvbTRxError


class DvbTRxSuperFrame(NamedTuple):
    payload: np.ndarray
    cell_id: int


class DvbTRxSuperFrameError(Exception):
    def __init__(self, kind: str, frame: int = -1, got=None) -> None:
        super().__init__(kind)
        self.kind = kind
        self.frame = frame
        self.got = got


@dataclass
class DvbTSuperFrameDemod:
    params: DvbTSuperFrameParams
    integer_cfo: bool = False
    rx_window_backoff: int = 0

    def with_integer_cfo_correction(self, on: bool = True):
        return DvbTSuperFrameDemod(self.params, on, self.rx_window_backoff)

    def with_rx_window_backoff(self, backoff: int):
        return DvbTSuperFrameDemod(self.params, self.integer_cfo, backoff)

    def decode(self, iq, symbols_per_frame: int,
               frame_payload_lens) -> DvbTRxSuperFrame:
        iq = np.asarray(iq)
        cp_len = guard_cp_len_2k(self.params.link.guard)
        frame_samples = symbols_per_frame * (DVB_T_N_FFT + cp_len)
        payloads = []
        frame_numbers = []
        cell_hi = cell_lo = 0
        for f in range(DVB_T_FRAMES_PER_SUPER_FRAME):
            start = f * frame_samples
            if start >= len(iq):
                raise DvbTRxSuperFrameError("incomplete", frame=f)
            try:
                rx = DvbTFrameDemod(self.params.frame(f),
                                    integer_cfo=self.integer_cfo,
                                    rx_window_backoff=self.rx_window_backoff
                                    ).decode(iq[start:], symbols_per_frame,
                                             frame_payload_lens[f])
            except DvbTRxError as e:
                raise DvbTRxSuperFrameError(f"frame {f} failed: {e.kind}",
                                            frame=f) from e
            frame_numbers.append(rx.tps.frame_number)
            if f % 2 == 0:
                cell_hi = rx.tps.cell_id
            else:
                cell_lo = rx.tps.cell_id
            payloads.append(rx.payload)
        if frame_numbers != [0, 1, 2, 3]:
            raise DvbTRxSuperFrameError("frame numbers out of sequence",
                                        got=frame_numbers)
        return DvbTRxSuperFrame(payload=np.concatenate(payloads),
                                cell_id=(cell_hi << 8) | cell_lo)

    def decode_batch(self, iq, symbols_per_frame: int,
                     frame_payload_lens) -> DvbTRxSuperFrame:
        """Single-acquisition batched receive: the four frames of one
        super-frame are contiguous, so ONE GI sync aligns them all and ONE
        fused receive program demaps all four — vs the per-frame path's
        4 syncs + 4 receive calls. Payload FEC
        still runs per frame (lengths may differ). Same result as decode,
        and the same contract: the capture starts at the super-frame
        (sub-symbol timing jitter is absorbed by the GI sync; arbitrary
        offsets are DvbTFrameStreamDemod's job)."""
        from ..constellation import BITS_PER_SYMBOL
        from ..sync.dvb_t_gi_sync import dvb_t_gi_sync
        from ..waveform.dvb_t_tps import (TPS_SYMBOLS_PER_FRAME, TpsWord,
                                          tps_decode_frame)
        from .dvb_t_frame import _receive_frame

        iq = np.asarray(iq)
        cp_len = guard_cp_len_2k(self.params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        frame_samples = symbols_per_frame * sps
        fd = DvbTFrameDemod(self.params.frame(0), integer_cfo=self.integer_cfo,
                            rx_window_backoff=self.rx_window_backoff)
        corrected = fd._integer_cfo_correct(iq, cp_len)
        if corrected is not None:
            iq = corrected
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fd.fs, sps)
        if acq is None:
            raise DvbTRxSuperFrameError("acquisition")
        start = acq.start_sample
        total = DVB_T_FRAMES_PER_SUPER_FRAME * frame_samples
        if len(iq) < start + total:
            raise DvbTRxSuperFrameError("incomplete")
        segs = iq[start: start + total].reshape(
            DVB_T_FRAMES_PER_SUPER_FRAME, frame_samples)
        vbits = BITS_PER_SYMBOL[self.params.link.constellation]
        llrs, cells = _receive_frame(segs, symbols_per_frame, cp_len,
                                     self.rx_window_backoff, vbits)

        payloads = []
        frame_numbers = []
        cell_hi = cell_lo = 0
        for f in range(DVB_T_FRAMES_PER_SUPER_FRAME):
            tps_word = None
            for blk in range(symbols_per_frame // TPS_SYMBOLS_PER_FRAME):
                bits = tps_decode_frame(
                    cells[f, blk * TPS_SYMBOLS_PER_FRAME:
                          (blk + 1) * TPS_SYMBOLS_PER_FRAME])
                tps_word = TpsWord.unpack(bits)
                if tps_word is not None:
                    break
            if tps_word is None:
                raise DvbTRxSuperFrameError(f"frame {f} failed: TPS", frame=f)
            try:
                rx = fd._decode_payload(llrs[f].reshape(-1),
                                        frame_payload_lens[f], tps_word)
            except DvbTRxError as e:
                raise DvbTRxSuperFrameError(f"frame {f} failed: {e.kind}",
                                            frame=f) from e
            frame_numbers.append(rx.tps.frame_number)
            if f % 2 == 0:
                cell_hi = rx.tps.cell_id
            else:
                cell_lo = rx.tps.cell_id
            payloads.append(rx.payload)
        if frame_numbers != [0, 1, 2, 3]:
            raise DvbTRxSuperFrameError("frame numbers out of sequence",
                                        got=frame_numbers)
        return DvbTRxSuperFrame(payload=np.concatenate(payloads),
                                cell_id=(cell_hi << 8) | cell_lo)
