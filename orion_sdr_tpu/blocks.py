"""Drop-in Block-style classes mirroring the reference's Python surface.

The reference exposes its `Block` impls as stateful classes
(`FmQuadratureDemod(fs, dev_hz, audio_bw_hz).process(iq)`, …) registered in
src/python/{modulate,demodulate,ft8,psk31,ofdm}.rs. The batched compute
lives in this package's batched functional API; these wrappers carry the
streaming state between `process()` calls so reference users can switch
without rewriting call sites. Constructor signatures mirror the reference
wrappers exactly (cited per class).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .modulate import analog as _ma
from .demodulate import analog as _da
from .modulate.digital import digital_mod
from .demodulate.digital import digital_demod
from .modulate import psk31 as _mp
from .demodulate import psk31 as _dp
from .modulate.ft8 import ft8_mod, ft4_mod
from .demodulate.ft8 import ft8_demod, ft4_demod
from .codec import ft8 as _ft8c
from .codec.psk31 import viterbi_decode as _psk31_viterbi

__all__ = [
    "CwKeyedMod", "CwEnvelopeDemod", "AmDsbMod", "AmEnvelopeDemod",
    "SsbPhasingMod", "SsbProductDemod", "FmPhaseAccumMod",
    "FmQuadratureDemod", "PmDirectPhaseMod", "PmQuadratureDemod",
    "BpskMod", "BpskDemod", "QpskMod", "QpskDemod", "QamMod", "QamDemod",
    "Ft8Mod", "Ft8Demod", "Ft8Codec", "Ft4Mod", "Ft4Demod", "Ft4Codec",
    "Bpsk31Mod", "Bpsk31Demod", "Bpsk31Decider", "Qpsk31Mod", "Qpsk31Demod",
    "OfdmMod", "OfdmDemod",
]


def _c64(x):
    """Output converter (device results → reference dtype)."""
    return np.ascontiguousarray(np.asarray(x), dtype=np.complex64)


def _f32(x):
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def _check_1d(x, dtype, what: str) -> np.ndarray:
    """Reference array contract (ref docs/api.md:192-201): process() inputs
    must be 1-D C-contiguous numpy arrays of the exact dtype — anything
    else raises ValueError, matching the reference wrappers' strictness
    (python/tests/test_unit.py input-validation tier)."""
    if not isinstance(x, np.ndarray):
        raise ValueError(
            f"{what}: expected numpy.ndarray, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: expected dtype {np.dtype(dtype).name}, "
                         f"got {x.dtype.name}")
    if x.ndim != 1:
        raise ValueError(f"{what}: expected 1-D, got {x.ndim}-D")
    if not x.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what}: expected C-contiguous layout")
    return x


def _in_c64(x):
    return _check_1d(x, np.complex64, "IQ input")


def _in_f32(x):
    return _check_1d(x, np.float32, "audio/soft input")


def _in_u8(x):
    return _check_1d(x, np.uint8, "bits/tones input")


# ── analog TX (ref src/python/modulate.rs) ───────────────────────────────────


class CwKeyedMod:
    """ref modulate.rs:45-75: (sample_rate, tone_hz, rise_ms, fall_ms)."""

    def __init__(self, sample_rate: float, tone_hz: float,
                 rise_ms: float = 3.0, fall_ms: float = 3.0):
        self.fs, self.tone_hz = sample_rate, tone_hz
        self.rise_ms, self.fall_ms = rise_ms, fall_ms
        self.gain = 1.0
        self._state = None

    def set_gain(self, g: float):
        self.gain = g

    def process(self, key_env) -> np.ndarray:
        iq, self._state = _ma.cw_mod(_in_f32(key_env), self.fs, self.tone_hz,
                                     self.rise_ms, self.fall_ms, self.gain,
                                     state=self._state)
        return _c64(iq)


class AmDsbMod:
    """ref modulate.rs:11-43: (fs, rf_hz, carrier_level, modulation_index)."""

    def __init__(self, fs: float, rf_hz: float = 0.0,
                 carrier_level: float = 1.0, modulation_index: float = 1.0):
        self.fs, self.rf_hz = fs, rf_hz
        self.carrier_level, self.modulation_index = (carrier_level,
                                                     modulation_index)
        self.gain, self.clamp = 1.0, False
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def set_clamp(self, on: bool):
        self.clamp = on

    def process(self, audio) -> np.ndarray:
        iq, self._phase = _ma.am_mod(
            _in_f32(audio), self.fs, self.rf_hz, self.carrier_level,
            self.modulation_index, self.gain, self.clamp, self._phase)
        return _c64(iq)


class SsbPhasingMod:
    """ref modulate.rs:143-172: (fs, audio_bw_hz, audio_if_hz, rf_hz, usb)."""

    def __init__(self, fs: float, audio_bw_hz: float, audio_if_hz: float,
                 rf_hz: float = 0.0, usb: bool = True):
        self.args = (fs, audio_bw_hz, audio_if_hz, rf_hz, usb)
        self._state = None

    def process(self, audio) -> np.ndarray:
        fs, bw, aif, rf, usb = self.args
        iq, self._state = _ma.ssb_mod(_in_f32(audio), fs, bw, aif, rf, usb,
                                      state=self._state)
        return _c64(iq)


class FmPhaseAccumMod:
    """ref modulate.rs:77-108: (sample_rate, deviation_hz, rf_hz)."""

    def __init__(self, sample_rate: float, deviation_hz: float,
                 rf_hz: float = 0.0):
        self.fs, self.deviation_hz, self.rf_hz = (sample_rate, deviation_hz,
                                                  rf_hz)
        self.gain = 1.0
        self._state = None

    def set_deviation(self, hz: float):
        self.deviation_hz = hz

    def set_gain(self, g: float):
        self.gain = g

    def process(self, audio) -> np.ndarray:
        iq, self._state = _ma.fm_mod(_in_f32(audio), self.fs, self.deviation_hz,
                                     self.rf_hz, self.gain,
                                     state=self._state)
        return _c64(iq)


class PmDirectPhaseMod:
    """ref modulate.rs:110-141: (sample_rate, kp_rad_per_unit, rf_hz)."""

    def __init__(self, sample_rate: float, kp_rad_per_unit: float,
                 rf_hz: float = 0.0):
        self.fs, self.kp, self.rf_hz = sample_rate, kp_rad_per_unit, rf_hz
        self.gain = 1.0
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def set_sensitivity(self, kp: float):
        self.kp = kp

    def process(self, audio) -> np.ndarray:
        iq, self._phase = _ma.pm_mod(_in_f32(audio), self.fs, self.kp,
                                     self.rf_hz, self.gain,
                                     rf_phase0=self._phase)
        return _c64(iq)


# ── analog RX (ref src/python/demodulate.rs) ─────────────────────────────────


class CwEnvelopeDemod:
    """ref demodulate.rs:11-37: (sample_rate, tone_hz, env_bw_hz)."""

    def __init__(self, sample_rate: float, tone_hz: float,
                 env_bw_hz: float = 300.0):
        self.fs, self.tone_hz, self.env_bw_hz = (sample_rate, tone_hz,
                                                 env_bw_hz)
        self.gain = 1.0
        self._y = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, iq) -> np.ndarray:
        audio, self._y = _da.cw_demod(_in_c64(iq), self.fs, self.env_bw_hz,
                                      self.gain, y0=self._y)
        return _f32(audio)


class AmEnvelopeDemod:
    """ref demodulate.rs:39-68: (fs, audio_bw_hz, abs_approx=False)."""

    def __init__(self, fs: float, audio_bw_hz: float,
                 abs_approx: bool = False):
        self.fs, self.audio_bw_hz = fs, audio_bw_hz
        self.method = "abs_approx" if abs_approx else "power_sqrt"
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.am_demod(_in_c64(iq), self.fs,
                                          self.audio_bw_hz,
                                          method=self.method,
                                          state=self._state)
        return _f32(audio)


class SsbProductDemod:
    """ref demodulate.rs:70-98: (fs, bfo_hz, audio_bw_hz)."""

    def __init__(self, fs: float, bfo_hz: float, audio_bw_hz: float):
        self.fs, self.bfo_hz, self.audio_bw_hz = fs, bfo_hz, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.ssb_demod(_in_c64(iq), self.fs, self.bfo_hz,
                                           self.audio_bw_hz,
                                           state=self._state)
        return _f32(audio)


class FmQuadratureDemod:
    """ref demodulate.rs:100-128: (fs, dev_hz, audio_bw_hz)."""

    def __init__(self, fs: float, dev_hz: float, audio_bw_hz: float):
        self.fs, self.dev_hz, self.audio_bw_hz = fs, dev_hz, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.fm_demod(_in_c64(iq), self.fs, self.dev_hz,
                                          self.audio_bw_hz,
                                          state=self._state)
        return _f32(audio)


class PmQuadratureDemod:
    """ref demodulate.rs:130-158: (fs, k, audio_bw_hz)."""

    def __init__(self, fs: float, k: float, audio_bw_hz: float):
        self.fs, self.k, self.audio_bw_hz = fs, k, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.pm_demod(_in_c64(iq), self.fs, self.k,
                                          self.audio_bw_hz,
                                          state=self._state)
        return _f32(audio)


# ── single-carrier digital (ref modulate.rs:175-330, demodulate.rs:160-330) ──


class _DigitalMod:
    order = "bpsk"

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0):
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, bits) -> np.ndarray:
        iq, self._phase = digital_mod(_in_u8(bits), self.order,
                                      self.fs, self.rf_hz, self.gain,
                                      self._phase)
        return _c64(iq)


class _DigitalDemod:
    order = "bpsk"

    def __init__(self, gain: float = 1.0, fs: float = 1.0,
                 rf_hz: float = 0.0):
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, iq) -> np.ndarray:
        bits, self._phase = digital_demod(_in_c64(iq), self.order, self.fs,
                                          self.rf_hz, self.gain, self._phase)
        return np.asarray(bits, np.uint8)


class BpskMod(_DigitalMod):
    order = "bpsk"


class BpskDemod(_DigitalDemod):
    order = "bpsk"


class QpskMod(_DigitalMod):
    order = "qpsk"


class QpskDemod(_DigitalDemod):
    order = "qpsk"


class QamMod(_DigitalMod):
    """ref modulate.rs:283-330: (order, fs, rf_hz, gain); order ∈ 16/64/256."""

    def __init__(self, order: int, fs: float, rf_hz: float = 0.0,
                 gain: float = 1.0):
        if order not in (16, 64, 256):
            raise ValueError(f"unsupported QAM order {order}")
        super().__init__(fs, rf_hz, gain)
        self.order = f"qam{order}"


class QamDemod(_DigitalDemod):
    """ref demodulate.rs:130-160: (order, gain)."""

    def __init__(self, order: int, gain: float = 1.0, fs: float = 1.0,
                 rf_hz: float = 0.0):
        if order not in (16, 64, 256):
            raise ValueError(f"unsupported QAM order {order}")
        super().__init__(gain, fs, rf_hz)
        self.order = f"qam{order}"


# ── FT8/FT4 (ref src/python/ft8.rs) ──────────────────────────────────────────


class Ft8Mod:
    """ref ft8.rs:25-57: (fs, base_hz, rf_hz, gain)."""

    _mod = staticmethod(ft8_mod)

    def __init__(self, fs: float = 12000.0, base_hz: float = 1000.0,
                 rf_hz: float = 0.0, gain: float = 1.0):
        self.fs, self.base_hz, self.rf_hz, self.gain = fs, base_hz, rf_hz, gain

    def modulate(self, data_tones) -> np.ndarray:
        return _c64(type(self)._mod(_in_u8(data_tones),
                                    self.fs, self.base_hz, self.rf_hz,
                                    self.gain))


class Ft4Mod(Ft8Mod):
    """ref ft8.rs:167-199."""

    _mod = staticmethod(ft4_mod)


class Ft8Demod:
    """ref ft8.rs:59-92: (fs, base_hz); per-symbol tone argmax."""

    _demod = staticmethod(ft8_demod)

    def __init__(self, fs: float = 12000.0, base_hz: float = 1000.0):
        self.fs, self.base_hz = fs, base_hz

    def demodulate(self, iq) -> np.ndarray:
        return np.asarray(type(self)._demod(_in_c64(iq), self.fs, self.base_hz),
                          np.uint8)


class Ft4Demod(Ft8Demod):
    """ref ft8.rs:201-234."""

    _demod = staticmethod(ft4_demod)


class Ft8Codec:
    """ref ft8.rs:94-165: encode / decode_hard / decode_soft."""

    _enc = staticmethod(_ft8c.ft8_encode)
    _dec_hard = staticmethod(_ft8c.ft8_decode_hard)
    _dec_soft = staticmethod(_ft8c.ft8_decode_soft)

    def encode(self, payload) -> np.ndarray:
        p = np.frombuffer(bytes(payload), np.uint8)
        return np.asarray(type(self)._enc(p), np.uint8)

    def decode_hard(self, tones) -> Optional[bytes]:
        out = type(self)._dec_hard(_in_u8(tones))
        return None if out is None else bytes(out)

    def decode_soft(self, llr) -> Optional[bytes]:
        out = type(self)._dec_soft(_in_f32(llr))
        return None if out is None else bytes(out)


class Ft4Codec(Ft8Codec):
    """ref ft8.rs:236-307."""

    _enc = staticmethod(_ft8c.ft4_encode)
    _dec_hard = staticmethod(_ft8c.ft4_decode_hard)
    _dec_soft = staticmethod(_ft8c.ft4_decode_soft)


# ── PSK31 (ref src/python/psk31.rs) ──────────────────────────────────────────


class Bpsk31Mod:
    """ref psk31.rs:92-134: (fs, rf_hz, gain); modulate_text / modulate_bits."""

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0):
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain

    def modulate_text(self, text: str, preamble_bits: int = 32,
                      postamble_bits: int = 32) -> np.ndarray:
        return _c64(_mp.bpsk31_mod_text(text, self.fs, self.rf_hz, self.gain,
                                        preamble_bits, postamble_bits))

    def modulate_bits(self, bits) -> np.ndarray:
        iq, _ = _mp.bpsk31_mod_bits(_in_u8(bits), self.fs,
                                    self.rf_hz, self.gain)
        return _c64(iq)


class Qpsk31Mod(Bpsk31Mod):
    """ref psk31.rs:171-211."""

    def modulate_text(self, text: str, preamble_bits: int = 32,
                      postamble_bits: int = 32) -> np.ndarray:
        return _c64(_mp.qpsk31_mod_text(text, self.fs, self.rf_hz, self.gain,
                                        preamble_bits, postamble_bits))

    def modulate_bits(self, bits) -> np.ndarray:
        iq, _ = _mp.qpsk31_mod_bits(_in_u8(bits), self.fs,
                                    self.rf_hz, self.gain)
        return _c64(iq)


class _Psk31DemodBase:
    qpsk = False

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0):
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self.sps = _mp.psk31_sps(fs)
        self._leftover = np.zeros(0, np.complex64)
        self._n_mixed = 0            # samples already down-mixed (phase carry)
        self._prev_sym = 1.0 + 0.0j
        self._phase_acc = 0.0

    def process(self, iq) -> np.ndarray:
        z = np.concatenate([self._leftover, _in_c64(iq)])
        n_syms = len(z) // self.sps
        if n_syms == 0:
            self._leftover = z
            shape = (0, 2) if self.qpsk else (0,)
            return np.zeros(shape, np.float32)
        take = n_syms * self.sps
        self._leftover = z[take:]
        # continue the down-mix oscillator across process() calls
        # (same carry Psk31Stream threads via its sample counter)
        phase0 = np.float32(-2.0 * np.pi * self.rf_hz
                            * self._n_mixed / self.fs)
        self._n_mixed += take
        soft, prev, acc = _dp.stream_step(
            z[:take], phase0, np.complex64(self._prev_sym),
            np.float32(self._phase_acc), self.sps, self.gain, self.qpsk,
            self.rf_hz, self.fs)
        self._prev_sym = complex(np.asarray(prev).reshape(())[()])
        self._phase_acc = float(np.asarray(acc).reshape(())[()])
        return _f32(soft)


class Bpsk31Demod(_Psk31DemodBase):
    """ref psk31.rs:136-169: (fs, rf_hz, gain) → per-symbol soft Re(d)."""

    qpsk = False


class Qpsk31Demod(_Psk31DemodBase):
    """ref psk31.rs:213-263: buffers differential pairs; flush() runs the
    Viterbi MLSE over everything seen (ref Qpsk31Decider semantics)."""

    qpsk = True

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0):
        super().__init__(fs, rf_hz, gain)
        self._pairs = []

    def process(self, iq) -> np.ndarray:
        soft = super().process(iq)
        if len(soft):
            self._pairs.append(soft)
        return soft

    def flush(self) -> np.ndarray:
        if not self._pairs:
            return np.zeros(0, np.uint8)
        pairs = np.concatenate(self._pairs)
        self._pairs = []
        return np.asarray(_psk31_viterbi(pairs), np.uint8)


class Bpsk31Decider:
    """ref psk31.rs:265-294: soft ≥ 0 → bit 1."""

    def process(self, soft) -> np.ndarray:
        return (_in_f32(soft) >= 0.0).astype(np.uint8)


# ── OFDM (ref src/python/ofdm.rs:479-640) ────────────────────────────────────


class OfdmMod:
    """ref ofdm.rs:479-511: whole-symbol mod of an OfdmConfig link."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._phase = 0.0

    def process(self, bits) -> np.ndarray:
        from .ofdm import ofdm_mod
        iq, self._phase = ofdm_mod(self.cfg, _in_u8(bits),
                                   phase0=self._phase)
        return _c64(iq)

    modulate = process


class OfdmDemod:
    """ref ofdm.rs:513-640: (cfg, equalizer='training_symbol'|'pilot_interp');
    `estimate_channel(rx_training_freq)` installs the held estimate."""

    def __init__(self, cfg, equalizer: str = "training_symbol"):
        if equalizer not in ("training_symbol", "pilot_interp"):
            raise ValueError(
                f"OfdmDemod: unknown equalizer {equalizer!r} (expected "
                "'training_symbol' or 'pilot_interp')")
        self.cfg = cfg.with_equalizer_method(equalizer)
        self.equalizer = equalizer
        self._estimate = None
        self._phase = 0.0

    def estimate_channel(self, rx_training_freq, known_freq=None):
        from .ofdm import channel_estimate_training
        from .sync.ofdm_sync import training_symbol_freq_pattern
        if known_freq is None:
            known_freq = (training_symbol_freq_pattern(
                self.cfg.carrier_plan.n_fft) * self.cfg.gain)
        self._estimate = np.asarray(channel_estimate_training(
            _in_c64(rx_training_freq), _c64(known_freq)))

    def process(self, iq) -> np.ndarray:
        from .ofdm import (ofdm_demod, ofdm_decide, channel_estimate_pilots,
                           zf_equalize)
        from .multicarrier import CarrierGrid, symbol_fft, grid_extract
        from .dsp.osc import rotate_host
        z = _in_c64(iq)
        if self.equalizer == "pilot_interp":
            if self.cfg.rf_hz != 0.0:
                # same down-mix the training_symbol branch gets via
                # ofdm_demod, with the carried oscillator phase
                z, self._phase = rotate_host(z, np.float32(-self.cfg.rf_hz),
                                             self.cfg.fs, self._phase)
            g = CarrierGrid(self.cfg.carrier_plan)
            freq = symbol_fft(z, g.n_fft, g.cp_len,
                              backoff=self.cfg.rx_window_backoff)
            known = g.pilot_values * np.complex64(self.cfg.gain)
            est = channel_estimate_pilots(freq, g.pilot_bins, known, g.n_fft)
            soft = grid_extract(g, zf_equalize(freq, est))
        else:
            soft, self._phase = ofdm_demod(self.cfg, z,
                                           estimate=self._estimate,
                                           phase0=self._phase)
        return np.asarray(ofdm_decide(self.cfg, soft), np.uint8)

    demodulate = process
