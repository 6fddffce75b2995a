"""FT8/FT4 streaming decoder (behavioral spec: codec/ft8.rs:159-400).

Host-side accumulate-and-decode driver: feed IQ at 12 kHz; when a full frame
is buffered, run sync (device) → LDPC decode per candidate (device, stops at
the first CRC pass) → unpack77. A CallsignHashTable persists across frames
so hashed nonstandard calls resolve in later messages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from typing import List, Optional

from ..message import CallsignHashTable, unpack77, Ft8Message
from ..modulate.ft8 import (FT8_FRAME_LEN, FT4_FRAME_LEN,
                            FT8_TONE_SPACING_HZ, FT4_TONE_SPACING_HZ)
from ..sync.ft8_sync import ft8_sync, ft4_sync
from .ft8 import ft8_decode_soft, ft4_decode_soft


@dataclass
class Ft8DecodeResult:
    """(ref Ft8DecodeResult)"""
    message: Ft8Message
    carrier_hz: float
    snr_db: float       # Costas score — monotone with true SNR


class Ft8StreamDecoder:
    """Accumulates IQ at 12 kHz and decodes FT8 or FT4 frames."""

    def __init__(self, fs: float, base_hz: float, max_hz: float,
                 max_cand: int = 4, ft8: bool = True, ap=None) -> None:
        self.fs = float(fs)
        self.base_hz = float(base_hz)
        self.max_hz = float(max_hz)
        self.max_cand = max(int(max_cand), 1)
        self.is_ft8 = ft8
        self.frame_len = FT8_FRAME_LEN if ft8 else FT4_FRAME_LEN
        self._buf = np.zeros(0, np.complex64)
        self.hash_table = CallsignHashTable()
        # a-priori prior (positions, bits) from ft8_ap_prior: candidates
        # that fail the plain decode get a second, prior-clamped BP pass
        self.ap = ap

    @classmethod
    def new_ft8(cls, fs: float, base_hz: float, max_hz: float,
                max_cand: int = 4):
        return cls(fs, base_hz, max_hz, max_cand, ft8=True)

    @classmethod
    def new_ft4(cls, fs: float, base_hz: float, max_hz: float,
                max_cand: int = 4):
        return cls(fs, base_hz, max_hz, max_cand, ft8=False)

    def __len__(self) -> int:
        return len(self._buf)

    def view_buf(self) -> np.ndarray:
        return self._buf

    def clear(self) -> None:
        self._buf = np.zeros(0, np.complex64)

    def feed(self, iq) -> List[Ft8DecodeResult]:
        """Append samples; decode when a full frame is buffered."""
        from ..dsp.device import sanitize_iq
        self._buf = np.concatenate([self._buf, sanitize_iq(iq)])
        if len(self._buf) >= self.frame_len:
            return self._decode_buf()
        return []

    def flush(self) -> List[Ft8DecodeResult]:
        """Decode whatever is buffered (does not clear the buffer)."""
        if len(self._buf) == 0:
            return []
        return self._decode_buf()

    def _decode_buf(self) -> List[Ft8DecodeResult]:
        spacing = FT8_TONE_SPACING_HZ if self.is_ft8 else FT4_TONE_SPACING_HZ
        search_min = self.base_hz
        search_max = max(self.max_hz + spacing, search_min + spacing)
        sync = ft8_sync if self.is_ft8 else ft4_sync
        decode = ft8_decode_soft if self.is_ft8 else ft4_decode_soft
        cands = sync(self._buf, self.fs, search_min, search_max,
                     0, 0, self.max_cand)
        # plain decodes first; AP-primed retries only if nothing decodes
        # (matches WSJT-X ordering — an AP decode never masks a full one)
        for ap in ([None, self.ap] if self.ap is not None else [None]):
            for cand in cands:
                payload = decode(cand.llr, ap=ap)
                # the all-zero codeword is CRC-consistent, so silence would
                # otherwise "decode" as an empty free-text message — reject
                if payload is not None and np.any(payload):
                    msg = unpack77(payload, self.hash_table)
                    return [Ft8DecodeResult(
                        message=msg,
                        carrier_hz=self.base_hz + cand.freq_bin * spacing,
                        snr_db=cand.score)]
        return []


def _decode_windows(windows, fs, base_hz, max_hz, max_cand, hash_table, ft8,
                    ap=None):
    from . import ft8_ldpc
    from .ft8 import FT4_XOR
    from ..message import unpack77 as _unpack
    from ..sync.ft8_sync import ft8_sync_batch, ft4_sync_batch

    from ..dsp.device import sanitize_iq
    windows = sanitize_iq(windows)
    assert windows.ndim == 2
    ht = hash_table if hash_table is not None else CallsignHashTable()
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ
    sync_batch = ft8_sync_batch if ft8 else ft4_sync_batch

    cands_per_win = sync_batch(windows, fs, base_hz,
                               max(max_hz + spacing, base_hz + spacing),
                               max_cand)
    all_llrs = [c.llr for cands in cands_per_win for c in cands]
    if not all_llrs:
        return [None] * len(windows)

    # one batched BP over every candidate of every window; with an AP
    # prior the clamped retry rows ride the SAME batch (plain rows win)
    llr_mat = np.stack(all_llrs).astype(np.float32)
    n_plain = llr_mat.shape[0]
    if ap is not None:
        from .ft8 import apply_ap_prior
        llr_mat = np.concatenate([llr_mat, apply_ap_prior(llr_mat, ap)])
    bits, errs = ft8_ldpc.ldpc_decode_soft(llr_mat)
    bits = np.asarray(bits)
    errs = np.asarray(errs)

    from .ft8_crc import ft8_check_crc

    def _extract(k, verify_ap):
        if errs[k] != 0:
            return None
        if verify_ap and not np.array_equal(
                bits[k].astype(np.uint8)[ap[0]], ap[1]):
            return None
        a91 = np.packbits(np.concatenate(
            [bits[k].astype(np.uint8), np.zeros(5, np.uint8)]))
        if not ft8_check_crc(a91) or not np.any(a91[:10]):
            return None
        payload = a91[:10].copy()
        if not ft8:
            payload = (payload ^ FT4_XOR).astype(np.uint8)
        payload[9] &= 0xF8
        return payload

    results: List[Optional[Ft8DecodeResult]] = []
    k0 = 0
    for cands in cands_per_win:
        hit = None
        for pass_base, verify in (((0, False),) if ap is None
                                  else ((0, False), (n_plain, True))):
            if hit is not None:
                break
            for j, c in enumerate(cands):
                payload = _extract(pass_base + k0 + j, verify)
                if payload is not None:
                    hit = Ft8DecodeResult(
                        message=_unpack(payload, ht),
                        carrier_hz=base_hz + c.freq_bin * spacing,
                        snr_db=c.score)
                    break
        k0 += len(cands)
        results.append(hit)
    return results


def ft8_decode_windows(windows, fs: float = 12000.0, base_hz: float = 200.0,
                       max_hz: float = 3000.0, max_cand: int = 4,
                       hash_table: Optional[CallsignHashTable] = None,
                       ap=None):
    """Batch-decode many 15 s FT8 receive windows (BASELINE.json config 3).

    ``windows``: (B, n) IQ at 12 kHz. ONE fused device program computes every
    window's waterfall + Costas score grid + top-k; every candidate's 174
    LLRs across ALL windows then decode in ONE batched LDPC BP call, and
    each window keeps its first CRC-passing candidate. Returns a list
    (len B) of Ft8DecodeResult-or-None.
    """
    return _decode_windows(windows, fs, base_hz, max_hz, max_cand,
                           hash_table, ft8=True, ap=ap)


def ft4_decode_windows(windows, fs: float = 12000.0, base_hz: float = 200.0,
                       max_hz: float = 3000.0, max_cand: int = 4,
                       hash_table: Optional[CallsignHashTable] = None,
                       ap=None):
    """ft8_decode_windows for 7.5 s FT4 windows (XOR-descrambled payloads)."""
    return _decode_windows(windows, fs, base_hz, max_hz, max_cand,
                           hash_table, ft8=False, ap=ap)


def _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand, ft8,
                        hash_table, max_iter: int = 30, ap=None
                        ) -> Optional[Ft8DecodeResult]:
    from ..sync.ft8_sync import ft_sync_multi
    from ..dsp.device import sanitize_iq
    frames = sanitize_iq(frames)
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ
    decode = ft8_decode_soft if ft8 else ft4_decode_soft
    ht = hash_table if hash_table is not None else CallsignHashTable()
    cands = ft_sync_multi(frames, fs, base_hz,
                          max(max_hz + spacing, base_hz + spacing),
                          max_cand, "ft8" if ft8 else "ft4")
    # plain decodes first; AP-primed retries only if none succeed
    for prior in ([None, ap] if ap is not None else [None]):
        for cand in cands:
            payload = decode(cand.llr, max_iter, ap=prior)
            if payload is not None and np.any(payload):
                return Ft8DecodeResult(
                    message=unpack77(payload, ht),
                    carrier_hz=base_hz + cand.freq_bin * spacing,
                    snr_db=cand.score)
    return None


def ft8_decode_multi_frame(frames, fs: float = 12000.0,
                           base_hz: float = 200.0, max_hz: float = 3000.0,
                           max_cand: int = 4, hash_table=None,
                           max_iter: int = 30, ap=None
                           ) -> Optional[Ft8DecodeResult]:
    """Multi-frame averaging FT8 decode (beyond-reference sensitivity).

    ``frames``: (n_frames, 151680) — frame-aligned captures of the SAME
    message repeated over successive 15-s cycles (the WSJT-X multi-frame
    averaging scenario behind its −21 dB floor; the single-frame reference
    stops at −15). Candidates come from the SUMMED Costas score grids and
    their LLRs are summed across frames before one LDPC decode — each
    doubling of n_frames is worth ~1.5 dB of decode floor.
    """
    return _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand,
                               True, hash_table, max_iter, ap=ap)


def ft4_decode_multi_frame(frames, fs: float = 12000.0,
                           base_hz: float = 200.0, max_hz: float = 3000.0,
                           max_cand: int = 4, hash_table=None,
                           max_iter: int = 30, ap=None
                           ) -> Optional[Ft8DecodeResult]:
    """Multi-frame averaging FT4 decode — see ft8_decode_multi_frame
    ((n_frames, 60480) captures)."""
    return _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand,
                               False, hash_table, max_iter, ap=ap)


# ── multi-signal decode via iterative subtraction ────────────────────────────
#
# Beyond the single-signal reference (codec/ft8.rs stops at the first
# CRC-passing candidate): decode EVERY signal in a crowded window by
# re-synthesizing each decoded frame, least-squares fitting it to the
# received IQ, subtracting it, and re-running sync on the residual — the
# WSJT-X multi-pass subtraction loop, batched (re-synthesis is the
# runtime-tone CPFSK device path; the per-symbol complex fit is one
# matmul-shaped reduction).


def _subtract_frame_impl(residual, tones_full, time_sym, f0, fs, sps,
                         mod_batch):
    """LS-subtract one re-synthesized frame from ``residual`` in place.

    Per-symbol complex amplitudes a_k = ⟨r_k, s_k⟩/‖s_k‖² absorb channel
    gain/phase and slow drift; the dominant inter-symbol phase ramp is first
    folded into a frequency refinement (Δf from the a_{k+1}·conj(a_k) phase
    slope — candidates are waterfall-bin-granular, so a real signal can sit
    up to ±spacing/2 off grid) and the frame is re-synthesized once at the
    refined frequency. Returns (refined_hz, lag-1 amplitude coherence,
    fitted rms amplitude).

    The coherence |Σ a_{k+1}·ā_k| / Σ |a_{k+1}||a_k| separates true decodes
    from CRC-14 false positives on noise residuals: a real signal's fitted
    amplitudes share a slowly-varying phase (coherence → 1 even near the
    sensitivity floor) while a garbage fit is i.i.d. noise (≈ 1/√n_syms).
    The rms amplitude √mean|a_k|² feeds the caller's dynamic-range gate.

    Frequency is passed to the modulator as a 0-d ARRAY so every refined
    value reuses one compiled program (cjit treats Python floats as static).
    """
    start = int(time_sym) * sps
    total = len(tones_full) * sps
    end = min(start + total, len(residual))
    n_syms = (end - max(start, 0)) // sps
    if start < 0 or n_syms <= 0:
        return f0, 0.0, 0.0
    t_sym = sps / fs
    f = float(f0)
    a = None
    seg_s = None
    for it in range(2):
        s = np.asarray(mod_batch(tones_full[None, :],  # data tones only
                                 fs, np.float32(f)))[0][:n_syms * sps]
        seg_r = residual[start:start + n_syms * sps].reshape(n_syms, sps)
        seg_s = s.reshape(n_syms, sps)
        a = (seg_r * np.conj(seg_s)).sum(axis=1) / float(sps)
        if it == 1:
            break
        # phase slope across symbols → frequency refinement
        rot = np.sum(a[1:] * np.conj(a[:-1]))
        df = float(np.angle(rot)) / (2.0 * np.pi * t_sym)
        if abs(df) < 0.02:
            break
        f += df
    residual[start:start + n_syms * sps] -= (a[:, None] * seg_s).reshape(-1)
    denom = float(np.sum(np.abs(a[1:]) * np.abs(a[:-1])))
    coh = float(np.abs(np.sum(a[1:] * np.conj(a[:-1])))) / max(denom, 1e-30)
    return f, coh, float(np.sqrt(np.mean(np.abs(a) ** 2)))


def _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand, max_passes,
                         ft8, hash_table, max_iter) -> List[Ft8DecodeResult]:
    from ..dsp.device import sanitize_iq
    from ..sync.ft8_sync import (_MODE, _mode_tables, _extract_llrs)
    from ..sync.waterfall import compute_waterfall
    from ..sync.costas import Candidate, find_candidates
    from .ft8 import ft8_encode, ft4_encode

    mode = "ft8" if ft8 else "ft4"
    m = _MODE[mode]
    costas, sync_pos, data_pos, gray = _mode_tables(mode)
    spacing, sps = m["spacing"], m["sps"]
    decode = ft8_decode_soft if ft8 else ft4_decode_soft
    encode = ft8_encode if ft8 else ft4_encode
    synth = _raw_cpfsk(ft8)
    ht = hash_table if hash_table is not None else CallsignHashTable()

    residual = sanitize_iq(iq).copy()
    search_max = max(max_hz + spacing, base_hz + spacing)
    num_bins = int(np.ceil(max(search_max - base_hz, 0.0) / spacing)) \
        + m["n_tones"] + 1
    wf_syms = m["total_syms"]
    wf_t_max = 0

    results: List[Ft8DecodeResult] = []
    seen = set()
    max_amp = 0.0
    # (time_sym, freq_bin) cells of already-subtracted signals: a co-channel
    # time-aligned weaker signal shares the Costas waveform, so subtraction
    # removes its sync energy too — it can never re-rank in top-k. Force LLR
    # re-extraction at these cells on every later pass.
    revisit: List[tuple] = []
    for _ in range(max(int(max_passes), 1)):
        wf = np.asarray(compute_waterfall(residual, fs, base_hz, spacing,
                                          sps, wf_syms, num_bins, 0))
        cands = list(find_candidates(wf, costas, list(sync_pos),
                                     m["n_tones"], 0, wf_t_max, max_cand))
        have = {(c.time_sym, c.freq_bin) for c in cands}
        cands += [Candidate(time_sym=t, freq_bin=b, score=0.0)
                  for (t, b) in revisit if (t, b) not in have]
        llrs = _extract_llrs(wf, cands, data_pos, gray=gray,
                             bits_per_sym=m["bits_per_sym"])
        found_new = False
        for cand, llr in zip(cands, llrs):
            payload = decode(llr, max_iter)
            if payload is None or not np.any(payload):
                continue
            key = payload.tobytes()
            if key in seen:
                continue
            seen.add(key)
            tones = np.asarray(encode(payload), np.uint8)
            f_est, coh, amp = _subtract_frame_impl(
                residual, tones_full=_full_tone_sequence(tones, ft8),
                time_sym=cand.time_sym,
                f0=base_hz + cand.freq_bin * spacing,
                fs=fs, sps=sps, mod_batch=synth)
            if coh < 0.35 or amp < max_amp * 1e-3:
                # CRC-14 false positive on a residual. Incoherent fit =
                # white-noise residual; fit >60 dB below the strongest
                # subtracted signal = quantization/leakage junk (real FT8
                # bands span ~50 dB). The tiny fit stays subtracted; the
                # payload stays in `seen`.
                continue
            max_amp = max(max_amp, amp)
            found_new = True
            if (cand.time_sym, cand.freq_bin) not in revisit:
                revisit.append((cand.time_sym, cand.freq_bin))
            results.append(Ft8DecodeResult(message=unpack77(payload, ht),
                                           carrier_hz=f_est,
                                           snr_db=cand.score))
        if not found_new:
            break
    return results


def _full_tone_sequence(data_tones: np.ndarray, ft8: bool) -> np.ndarray:
    from ..modulate.ft8 import ft8_symbol_sequence, ft4_symbol_sequence
    seq = ft8_symbol_sequence if ft8 else ft4_symbol_sequence
    return np.asarray(seq(data_tones), np.uint8)


def _raw_cpfsk(ft8: bool):
    """Full-symbol-sequence CPFSK synth (tones incl. Costas, runtime freq)."""
    from ..modulate.ft8 import (cpfsk_mod_batch, FT8_SAMPLES_PER_SYM,
                                FT4_SAMPLES_PER_SYM, FT8_TONE_SPACING_HZ,
                                FT4_TONE_SPACING_HZ)
    sps = FT8_SAMPLES_PER_SYM if ft8 else FT4_SAMPLES_PER_SYM
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ

    def synth(tones_2d, fs, base_hz_arr):
        return cpfsk_mod_batch(tones_2d, sps, fs, base_hz_arr, spacing)
    return synth


def ft8_decode_multi_signal(iq, fs: float = 12000.0, base_hz: float = 200.0,
                            max_hz: float = 3000.0, max_cand: int = 8,
                            max_passes: int = 3, hash_table=None,
                            max_iter: int = 30) -> List[Ft8DecodeResult]:
    """Decode ALL FT8 signals in one receive window by iterative subtraction.

    Each pass: sync → decode every CRC-passing candidate → re-synthesize each
    decoded frame (CPFSK at the refined carrier), least-squares fit per-symbol
    complex amplitudes, subtract, and re-run sync on the residual so weaker
    signals hidden under strong ones become decodable (the WSJT-X multi-pass
    loop; the single-signal reference codec/ft8.rs:159-247 returns only the
    first decode). Stops early when a pass finds nothing new. Returns every
    distinct decode, strongest first.
    """
    return _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand,
                                max_passes, True, hash_table, max_iter)


def ft4_decode_multi_signal(iq, fs: float = 12000.0, base_hz: float = 200.0,
                            max_hz: float = 3000.0, max_cand: int = 8,
                            max_passes: int = 3, hash_table=None,
                            max_iter: int = 30) -> List[Ft8DecodeResult]:
    """ft8_decode_multi_signal for FT4 windows (60 480-sample frames)."""
    return _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand,
                                max_passes, False, hash_table, max_iter)
