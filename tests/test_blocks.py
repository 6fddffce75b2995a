"""Drop-in Block-style class surface (orion_sdr_tpu/blocks.py) — reference
users' call sites (src/python/{modulate,demodulate,ft8,psk31,ofdm}.rs) work
unchanged: construct with the reference signatures, stream through
process(), get the reference dtypes back."""

import numpy as np
import pytest

import orion_sdr_tpu as sdr
from tests.helpers import tone_snr_db


FS = 48_000.0


def _tone(n, hz, fs=FS, amp=0.5):
    return (amp * np.sin(2 * np.pi * hz * np.arange(n) / fs)
            ).astype(np.float32)


class TestAnalogBlocks:
    def test_fm_mod_demod_roundtrip(self):
        audio = _tone(1 << 15, 1000.0)
        mod = sdr.FmPhaseAccumMod(FS, 5000.0)
        demod = sdr.FmQuadratureDemod(FS, 5000.0, 3000.0)
        iq = mod.process(audio)
        assert iq.dtype == np.complex64 and len(iq) == len(audio)
        out = demod.process(iq)
        assert out.dtype == np.float32
        assert tone_snr_db(FS, 1000.0, out[4000:]) > 20.0

    def test_fm_demod_streaming_equals_one_shot(self):
        audio = _tone(1 << 14, 800.0)
        iq = sdr.FmPhaseAccumMod(FS, 5000.0).process(audio)
        one = sdr.FmQuadratureDemod(FS, 5000.0, 3000.0).process(iq)
        s = sdr.FmQuadratureDemod(FS, 5000.0, 3000.0)
        parts = [s.process(iq[:5000]), s.process(iq[5000:11111]),
                 s.process(iq[11111:])]
        np.testing.assert_allclose(np.concatenate(parts), one, atol=2e-5)

    def test_am_roundtrip_both_methods(self):
        audio = _tone(1 << 14, 700.0)
        iq = sdr.AmDsbMod(FS, 0.0, 1.0, 0.8).process(audio)
        for approx in (False, True):
            out = sdr.AmEnvelopeDemod(FS, 3000.0, abs_approx=approx
                                      ).process(iq)
            assert tone_snr_db(FS, 700.0, out[4000:]) > 15.0

    def test_ssb_mod_demod(self):
        audio = _tone(1 << 14, 900.0)
        iq = sdr.SsbPhasingMod(FS, 3000.0, 1500.0, 0.0, True).process(audio)
        out = sdr.SsbProductDemod(FS, 1500.0, 3000.0).process(iq)
        assert tone_snr_db(FS, 900.0, out[4000:]) > 10.0

    def test_pm_roundtrip(self):
        audio = _tone(1 << 14, 600.0)
        iq = sdr.PmDirectPhaseMod(FS, 1.0).process(audio)
        out = sdr.PmQuadratureDemod(FS, 1.0, 3000.0).process(iq)
        assert tone_snr_db(FS, 600.0, out[4000:]) > 15.0

    def test_cw_keyed_envelope(self):
        key = np.zeros(1 << 14, np.float32)
        key[2000:12000] = 1.0
        iq = sdr.CwKeyedMod(FS, 800.0).process(key)
        env = sdr.CwEnvelopeDemod(FS, 800.0, 200.0).process(iq)
        assert env[8000] > 0.5 and env[500] < 0.1


class TestDigitalBlocks:
    @pytest.mark.parametrize("mod_cls,demod_args", [
        (sdr.BpskMod, ()), (sdr.QpskMod, ())])
    def test_psk_bit_exact(self, mod_cls, demod_args):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, 512).astype(np.uint8)
        mod = mod_cls(FS, 0.0, 1.0)
        iq = mod.process(bits)
        demod = (sdr.BpskDemod if mod_cls is sdr.BpskMod
                 else sdr.QpskDemod)(1.0, FS)
        out = demod.process(iq)
        assert np.array_equal(out[:len(bits)], bits)

    @pytest.mark.parametrize("order", [16, 64, 256])
    def test_qam_bit_exact(self, order):
        rng = np.random.default_rng(order)
        bpsym = {16: 4, 64: 6, 256: 8}[order]
        bits = rng.integers(0, 2, 64 * bpsym).astype(np.uint8)
        iq = sdr.QamMod(order, FS).process(bits)
        out = sdr.QamDemod(order, 1.0, FS).process(iq)
        assert np.array_equal(out[:len(bits)], bits)

    def test_qam_rejects_bad_order(self):
        with pytest.raises(ValueError):
            sdr.QamMod(32, FS)
        with pytest.raises(ValueError):
            sdr.QamDemod(5)


class TestFt8Blocks:
    def test_codec_encode_decode(self):
        payload = sdr.ft8_pack_standard("CQ", "KA1ABC", "FN42")
        codec = sdr.Ft8Codec()
        tones = codec.encode(payload)
        assert tones.shape == (58,)
        assert codec.decode_hard(tones) == payload

    def test_mod_demod_tones(self):
        payload = sdr.ft8_pack_free_text("TNX 73")
        tones = sdr.Ft8Codec().encode(payload)
        iq = sdr.Ft8Mod(12000.0, 1000.0).modulate(tones)
        got = sdr.Ft8Demod(12000.0, 1000.0).demodulate(iq)
        assert np.array_equal(got, tones)

    def test_ft4_roundtrip(self):
        payload = sdr.ft8_pack_free_text("FT4 OK")
        codec = sdr.Ft4Codec()
        tones = codec.encode(payload)
        assert tones.shape == (87,)
        iq = sdr.Ft4Mod(12000.0, 1000.0).modulate(tones)
        got = sdr.Ft4Demod(12000.0, 1000.0).demodulate(iq)
        assert np.array_equal(got, tones)
        assert codec.decode_hard(got) == payload


class TestPsk31Blocks:
    def test_bpsk31_text_stream(self):
        fs = 8000.0
        iq = sdr.Bpsk31Mod(fs).modulate_text("hello blocks")
        demod = sdr.Bpsk31Demod(fs)
        soft = np.concatenate([demod.process(iq[:10_000]),
                               demod.process(iq[10_000:])])
        bits = sdr.Bpsk31Decider().process(soft)
        text = sdr.VaricodeDecoder().push_bits(bits)
        assert "hello blocks" in text

    def test_qpsk31_flush_decodes(self):
        fs = 8000.0
        iq = sdr.Qpsk31Mod(fs).modulate_text("qpsk blocks")
        demod = sdr.Qpsk31Demod(fs)
        demod.process(iq)
        bits = demod.flush()
        text = sdr.VaricodeDecoder().push_bits(bits)
        assert "qpsk blocks" in text


class TestOfdmBlocks:
    def test_ofdm_mod_demod_classes(self):
        from orion_sdr_tpu.multicarrier import CarrierPlan
        plan = CarrierPlan(64, 16).with_contiguous_data(edge_guard=4)
        cfg = sdr.OfdmConfig(plan, fs=FS, constellation="qpsk")
        rng = np.random.default_rng(7)
        bits = rng.integers(0, 2, cfg.bits_per_ofdm_symbol() * 6
                            ).astype(np.uint8)
        iq = sdr.OfdmMod(cfg).process(bits)
        out = sdr.OfdmDemod(cfg).process(iq)
        assert np.array_equal(out[:len(bits)], bits)

    def test_ofdm_demod_pilot_interp_class(self):
        from orion_sdr_tpu.multicarrier import CarrierPlan
        plan = (CarrierPlan(256, 64)
                .with_pilot_carriers([(i, 1.0 + 0j)
                                      for i in range(-100, 101, 8)])
                .with_contiguous_data(edge_guard=27))
        cfg = sdr.OfdmConfig(plan, fs=FS, constellation="qpsk")
        rng = np.random.default_rng(8)
        bits = rng.integers(0, 2, cfg.bits_per_ofdm_symbol() * 4
                            ).astype(np.uint8)
        iq = sdr.OfdmMod(cfg).process(bits)
        h = np.zeros(8, np.complex64)
        h[0], h[5] = 1.0, 0.4 * np.exp(1j * 1.1)
        rx = np.convolve(iq, h)[:len(iq)].astype(np.complex64)
        out = sdr.OfdmDemod(cfg, equalizer="pilot_interp").process(rx)
        assert np.array_equal(out[:len(bits)], bits)
        with pytest.raises(ValueError):
            sdr.OfdmDemod(cfg, equalizer="nope")


class TestBlockStateCarry:
    def test_bpsk31_demod_phase_carry_across_chunks(self):
        """Regression: the down-mix oscillator phase must continue across
        process() calls — at an rf that is not a multiple of the symbol
        rate, a restarted mixer decodes a wrong bit at every chunk seam."""
        fs = 8000.0
        rf = 1001.5625          # NOT a multiple of 31.25 Hz
        iq = np.asarray(sdr.Bpsk31Mod(fs, rf_hz=rf
                                      ).modulate_text("phase carry"))
        one = sdr.Bpsk31Demod(fs, rf_hz=rf).process(iq)
        s = sdr.Bpsk31Demod(fs, rf_hz=rf)
        two = np.concatenate([s.process(iq[:30_011]),
                              s.process(iq[30_011:])])
        n = min(len(one), len(two))
        np.testing.assert_allclose(two[:n], one[:n], atol=1e-4)

    def test_ofdm_demod_pilot_interp_with_rf(self):
        """Regression: the pilot_interp branch must down-mix cfg.rf_hz
        exactly like the training_symbol branch does via ofdm_demod."""
        from orion_sdr_tpu.multicarrier import CarrierPlan
        plan = (CarrierPlan(256, 64)
                .with_pilot_carriers([(i, 1.0 + 0j)
                                      for i in range(-100, 101, 8)])
                .with_contiguous_data(edge_guard=27))
        cfg = sdr.OfdmConfig(plan, fs=FS, constellation="qpsk",
                             rf_hz=1000.0)
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, cfg.bits_per_ofdm_symbol() * 4
                            ).astype(np.uint8)
        iq = sdr.OfdmMod(cfg).process(bits)
        out = sdr.OfdmDemod(cfg, equalizer="pilot_interp").process(iq)
        assert np.array_equal(out[:len(bits)], bits)


class TestInputValidation:
    """The reference array contract (ref docs/api.md:192-201, mirrored from
    python/tests/test_unit.py): wrong dtype / ndim / layout raise ValueError
    instead of being silently coerced."""

    def test_demod_wrong_dtype(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.CwEnvelopeDemod(FS, 700.0, 300.0).process(
                np.zeros(256, np.complex128))

    def test_mod_wrong_dtype(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.AmDsbMod(FS, 0.0, 1.0, 0.8).process(np.zeros(256, np.float64))

    def test_demod_2d_input(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.FmQuadratureDemod(FS, 2500.0, 5000.0).process(
                np.zeros((2, 128), np.complex64))

    def test_non_contiguous(self):
        import pytest
        iq = np.zeros(512, np.complex64)[::2]
        with pytest.raises(ValueError):
            sdr.FmQuadratureDemod(FS, 2500.0, 5000.0).process(iq)

    def test_list_input_rejected(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.BpskMod(FS).process([0, 1, 0, 1])

    def test_tones_dtype_enforced(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.Ft8Mod().modulate(np.zeros(79, np.int64))

    def test_llr_dtype_enforced(self):
        import pytest
        with pytest.raises(ValueError):
            sdr.Ft8Codec().decode_soft(np.zeros(174, np.float64))

    def test_correct_dtypes_still_pass(self):
        iq = sdr.FmPhaseAccumMod(FS, 5000.0).process(
            np.zeros(1024, np.float32))
        out = sdr.FmQuadratureDemod(FS, 5000.0, 3000.0).process(iq)
        assert out.dtype == np.float32

    def test_sliced_view_accepted(self):
        # unit-stride 1-D slices stay C-contiguous and must keep working
        iq = sdr.FmPhaseAccumMod(FS, 5000.0).process(
            np.zeros(1024, np.float32))
        out = sdr.FmQuadratureDemod(FS, 5000.0, 3000.0).process(iq[:512])
        assert out.dtype == np.float32
