"""orion_sdr_tpu — an SDR/DSP framework in JAX, run on NVIDIA GPUs.

Brand-new implementation of the capability set of the reference library
``skynavga/orion-sdr`` (single-core Rust block graph), re-designed for
batched accelerator arrays:

* signals are batched arrays with the time axis last; blocks are pure
  functions ``y, state = f(x, ..., state)`` with explicit carried state;
* linear recurrences (IIR, DC block, one-pole envelopes) run as O(log n)
  associative scans; genuinely data-dependent loops (AGC, PLLs, Viterbi)
  are ``lax.scan`` batched over channels;
* FIR/FFT/mixing/tone-search are whole-capture fused XLA ops (waterfalls and
  matched filters are matmuls); the one hand-written kernel, the Viterbi
  trellis, is CUDA behind a JAX FFI call (orion_sdr_tpu.ops);
* multi-device scaling shards channels and time-blocks over a
  ``jax.sharding.Mesh`` with halo exchange (orion_sdr_tpu.parallel).

The flat namespace mirrors the reference's Python API surface
(/root/reference/python/orion_sdr/__init__.py, docs/api.md) so users can
switch directly; the functional equivalents of its Block classes are listed
in the matching order below.
"""

__version__ = "0.1.0"

# ── util / measurement ───────────────────────────────────────────────────────
from . import util
from .util import (
    rms, hann, tone, gen_complex_tone, snr_db_at, power_spectrum,
    nb_spectrum_snr_db, wb_spectrum_snr_db, spectrum_bw_hz,
    SIGNAL_THRESHOLD, PSK31_BW_HZ, awgn, measure, atan2_approx, trace,
    spectrum_scan, SpectrumSegment,
)

# ── DSP substrate ────────────────────────────────────────────────────────────
from . import dsp

# ── constellations (BpskMapper/QpskMapper/QamMapper + deciders + LLRs) ───────
from . import constellation
from .constellation import map_bits, decide, soft_llr, BITS_PER_SYMBOL

# ── analog modes (CwKeyedMod/CwEnvelopeDemod … PmQuadratureDemod) ────────────
from .modulate.analog import cw_mod, am_mod, ssb_mod, fm_mod, pm_mod
from .demodulate.analog import (cw_demod, cw_envelope_multi, am_demod,
                                ssb_demod, fm_demod, pm_demod,
                                am_band_demod, AmStation,
                                ssb_band_demod, SsbStation)

# ── ADS-B 1090ES / Mode S DF17 (beyond the reference) ────────────────────────
from .codec.adsb import (AdsbMessage, adsb_crc24, adsb_decode_frame,
                         adsb_encode_identification, adsb_encode_position,
                         adsb_encode_velocity, cpr_encode, cpr_decode_global)
from .modulate.adsb import adsb_mod
from .demodulate.adsb import adsb_decode_capture

# ── single-carrier recovery tools (beyond the reference) ─────────────────────
from .demodulate.digital import (estimate_cfo_mpsk, fde_equalize,
                                 burst_demod, symbol_sync_gardner,
                                 symbol_sync_energy, carrier_sync_dd)
from .modulate.digital import burst_mod, burst_preamble, rrc_taps

# ── blind modulation classification + band survey (beyond the reference) ─────
from .classify import (classify_signal, band_survey, band_decode,
                       SignalClass, SurveyEntry, BandDecodeEntry)

# ── capture file IO (beyond the reference) ───────────────────────────────────
from . import io
from .io import (write_iq_wav, read_iq_wav, write_audio_wav, read_audio_wav,
                 write_iq_npy, read_iq_npy)

# ── chirp spread spectrum, LoRa-style (beyond the reference) ─────────────────
from .modulate.css import css_mod
from .demodulate.css import css_demod, CssFrame

# ── SSTV Martin M1 image mode (beyond the reference) ─────────────────────────
from .modulate.sstv import sstv_mod
from .demodulate.sstv import sstv_demod, SstvImage

# ── WSPR-style weak-signal beacon + sequential FEC (beyond the reference) ────
from .fec.sequential import conv_encode_long, stack_decode
from .codec.wspr import WsprMessage, wspr_pack, wspr_unpack
from .modulate.wspr import wspr_mod
from .demodulate.wspr import wspr_demod, wspr_decode_band

# ── GPS L1 C/A acquisition + tracking (beyond the reference) ─────────────────
from .gnss import (GPS_NAV_PREAMBLE, GpsAcquisition, GpsTrack, gps_ca_code,
                   gps_ca_mod, gps_acquire, gps_track, gps_nav_frame_sync)
from .gnss_nav import (GpsEphemeris, GpsNavFrame, GpsSubframe,
                       GpsAlmanac, GpsIono, GpsUtc,
                       nav_word_encode, nav_word_check,
                       nav_subframes_encode, nav_subframes_decode,
                       almanac_page_words, iono_utc_page_words,
                       eph_sat_pos, alm_sat_pos, klobuchar_delay,
                       gps_fix, gps_decode_ephemeris)

# ── AIS marine transponders (beyond the reference) ───────────────────────────
from .codec.ais import AisPosition
from .modulate.ais import ais_mod
from .demodulate.ais import ais_decode

# ── POCSAG radio paging (beyond the reference) ───────────────────────────────
from .codec.pocsag import PocsagPage, pocsag_codeword, pocsag_check
from .modulate.pocsag import pocsag_mod
from .demodulate.pocsag import pocsag_decode

# ── AX.25 packet radio over AFSK-1200 (beyond the reference) ─────────────────
from .codec.ax25 import Ax25Frame, ax25_crc, hdlc_encode, hdlc_decode
from .modulate.afsk import (afsk1200_mod, ax25_beacon, nrzi_encode,
                            nrzi_decode, AFSK_BAUD, rtty_mod)
from .demodulate.afsk import (afsk1200_demod, ax25_decode,
                              rtty_decode, Afsk1200Stream)
from .codec.rtty import baudot_encode, baudot_decode

# ── FM broadcast stereo + RDS (beyond the reference's mono FM pair) ──────────
from .modulate.fm_stereo import (fm_stereo_mod, stereo_mpx, rds_manchester,
                                 FM_STEREO_PILOT_HZ, RDS_CARRIER_HZ)
from .demodulate.fm_stereo import (fm_stereo_demod, FmStereoAudio,
                                   fm_band_demod, FmStation)
from .codec.rds import (RDS_OFFSETS, rds_crc10, rds_block_encode,
                        rds_groups_0a, rds_groups_2a, rds_encode_groups,
                        rds_decode_bits, RdsData)

# ── single-carrier digital (BpskMod/BpskDemod … QamDemod) ────────────────────
from .modulate.digital import psk_qam_mod, digital_mod
from .demodulate.digital import psk_qam_demod, digital_demod

# ── FT8/FT4 (Ft8Mod/Ft8Demod/Ft8Codec + message packing) ─────────────────────
from .modulate.ft8 import ft8_mod, ft4_mod, ft8_mod_batch, ft4_mod_batch
from .demodulate.ft8 import ft8_demod, ft4_demod
from .codec.ft8 import (
    ft8_encode, ft4_encode, ft8_decode_soft, ft4_decode_soft,
    ft8_decode_hard, ft4_decode_hard, ft8_ap_prior, apply_ap_prior,
)
from .codec.ft8_stream import (Ft8StreamDecoder, Ft8DecodeResult,
                               ft8_decode_windows, ft4_decode_windows,
                               ft8_decode_multi_frame, ft4_decode_multi_frame,
                               ft8_decode_multi_signal,
                               ft4_decode_multi_signal)
from .sync.ft8_sync import (ft8_sync, ft4_sync, ft8_sync_batch,
                            ft4_sync_batch)
from . import message
from .message import (
    pack77, unpack77, CallsignHashTable,
    ft8_pack_standard, ft8_pack_free_text, ft8_pack_telemetry, ft8_unpack,
    Standard as Ft8Standard, FreeText as Ft8FreeText,
    NonStd as Ft8NonStd, Telemetry as Ft8Telemetry,
)

# ── PSK31 (Varicode, Bpsk31Mod/Demod/Decider, Qpsk31*, Psk31Stream) ──────────
from .codec.varicode import (
    VaricodeEncoder, VaricodeDecoder, varicode_encode, varicode_decode,
)
from .codec.morse import (MorseEncoder, MorseBandResult, morse_decode,
                          morse_decode_band)
from .modulate.psk31 import (
    bpsk31_mod_bits, qpsk31_mod_bits, bpsk31_mod_text, qpsk31_mod_text,
)
from .demodulate.psk31 import bpsk31_demod, qpsk31_demod, bpsk31_decide
from .sync.psk31_sync import psk31_sync, best_sync as best_psk31_sync
from . import codec


_LAZY_PSK31 = ("Psk31Stream", "Psk31BandResult", "psk31_decode_band")


def __getattr__(name):
    # Psk31Stream & co. resolve lazily (codec package cycle; see
    # codec/__init__).
    if name in _LAZY_PSK31:
        from .codec import psk31_stream
        return getattr(psk31_stream, name)
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY_PSK31))


# ── Block-style drop-in classes (the reference's class surface) ──────────────
from .blocks import (
    CwKeyedMod, CwEnvelopeDemod, AmDsbMod, AmEnvelopeDemod,
    SsbPhasingMod, SsbProductDemod, FmPhaseAccumMod, FmQuadratureDemod,
    PmDirectPhaseMod, PmQuadratureDemod,
    BpskMod, BpskDemod, QpskMod, QpskDemod, QamMod, QamDemod,
    Ft8Mod, Ft8Demod, Ft8Codec, Ft4Mod, Ft4Demod, Ft4Codec,
    Bpsk31Mod, Bpsk31Demod, Bpsk31Decider, Qpsk31Mod, Qpsk31Demod,
    OfdmMod, OfdmDemod,
)

# ── multicarrier / OFDM (OfdmConfig, OfdmMod/Demod, equalizers, sync) ────────
from . import multicarrier
from .multicarrier import CarrierPlan, CarrierGrid, TxLowpass
from . import ofdm as ofdm_mod_api
from .ofdm import (
    OfdmConfig, ofdm_mod, ofdm_demod, ofdm_decide, ofdm_soft_demod,
    zf_equalize, channel_estimate_training, channel_estimate_pilots,
    channel_estimate_denoise, cpe_correct, cpe_raw_phases, cpe_unwrap,
    dft_precode, dft_deprecode, mmse_equalize,
    OfdmRxFrame, build_ofdm_rx_frame,
)
from .otfs import isfft, sfft, otfs_mod, otfs_demod, otfs_num_symbols
from . import sync
from .sync.ofdm_sync import (
    ofdm_sync, generate_ofdm_preamble, OfdmPreamble, TrainingSymbol,
)

# ── FEC (Ldpc/Bch/ReedSolomon/conv/interleavers/scramblers/CRCs) ─────────────
from . import fec

# ── COFDM frame layer (FramePacket, McsTable, OfdmFrame{Mod,Demod,Stream}) ───
from . import frame
from .frame import (
    FramePacket, FrameMetadata, RxError, Mcs, McsTable, CodecCache,
    OfdmFrameMod, OfdmFrameDemod, OfdmFrameStreamDemod,
    OfdmFrameBandStreamDemod, RxFrame,
    OuterFec, InnerFec, InterleaverKind, ScramblerKind,
)

# ── DVB-T 2K / NB-DVB-T ─────────────────────────────────────────────────────
from . import waveform
from .waveform import (
    DvbTLinkParams, DvbTFrameParams, DvbTSuperFrameParams,
    DvbTHierLinkParams, DvbTHierFrameParams,
    TpsWord, dvb_t_config, dvb_t_scattered_config, dvb_t_mcs_table,
    DVB_T_MAX_RX_WINDOW_BACKOFF,
)
from .modulate.dvb_t_frame import (DvbTFrameMod, DvbTFrame, DvbTHierFrameMod,
                                   tx_lowpass_for_2k)
from .modulate.dvb_t_super_frame import DvbTSuperFrameMod, DvbTSuperFrame
from .demodulate.dvb_t_frame import (DvbTFrameDemod, DvbTRxFrame, DvbTRxError,
                                      DvbTHierFrameDemod, DvbTHierRxFrame,
                                      dvb_t_blind_decode, DvbTBlindFrame)
from .demodulate.dvb_t_super_frame import DvbTSuperFrameDemod, DvbTRxSuperFrame
from .demodulate.dvb_t_stream import (DvbTFrameStreamDemod,
                                      DvbTHierFrameStreamDemod,
                                      DvbTBandStreamDemod)

# reference's NB/bandwidth helper surface (python/orion_sdr/__init__.py:65-72)
from .waveform.dvb_t import (
    dvb_t_fs_for_bandwidth as nb_bandwidth_fs,
    dvb_t_occupied_bw as nb_bandwidth_occupied_hz,
    guard_cp_len_2k as dvb_t_cp_len,
)


def dvb_t_max_rx_window_backoff() -> int:
    return DVB_T_MAX_RX_WINDOW_BACKOFF


def dvb_t_tx_lowpass_suggested_taps(stopband_db: float) -> int:
    from .waveform.dvb_t import DVB_T_N_FFT, DVB_T_KMAX
    return TxLowpass.taps_for_null_band(DVB_T_N_FFT, DVB_T_KMAX // 2,
                                        stopband_db)


def dvb_t_tx_lowpass_group_delay(num_taps: int) -> int:
    return (num_taps - 1) // 2


def dvb_t_tx_lowpass_fits_guard(num_taps: int, cp_len: int, roll_off: int,
                                backoff: int) -> bool:
    gd = dvb_t_tx_lowpass_group_delay(num_taps)
    return roll_off + gd <= min(cp_len - backoff, backoff)


# checkpoint / resume for streaming receiver state (beyond the reference:
# SURVEY §5 "Checkpoint / resume: absent")
from .checkpoint import (
    save_checkpoint, load_checkpoint, state_dict, load_state_dict,
)

# channel impairment simulator (beyond the reference: AWGN-only
# qualification in tests/common/mod.rs — no fading/multipath model exists)
from .channel import (
    cfo_apply, phase_noise_apply, iq_imbalance_apply, multipath_apply,
    fading_taps, fading_apply, watterson_apply,
)

# ── package modules ──────────────────────────────────────────────────────────
from . import modulate, demodulate, parallel
