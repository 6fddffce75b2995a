"""FM broadcast stereo MPX + RDS — beyond the reference (its FM pair is
mono: modulate/fm.rs, demodulate/fm.rs). Pilot-coherent stereo decode,
RDS (26,16) block code + group layer, end-to-end text through the FM chain."""

import numpy as np
import pytest

from orion_sdr_tpu.codec import rds as R
from orion_sdr_tpu.modulate.fm_stereo import (fm_stereo_mod, stereo_mpx,
                                              rds_manchester)
from orion_sdr_tpu.modulate.analog import fm_mod
from orion_sdr_tpu.demodulate.fm_stereo import fm_stereo_demod

FS = 240_000.0


def _tone_amp(x, f, fs=FS, guard=20_000):
    seg = np.asarray(x)[guard:-guard]
    ph = np.exp(-2j * np.pi * f * np.arange(guard, guard + len(seg)) / fs)
    return 2 * abs(np.mean(seg * ph))


def _lr(n, fs=FS):
    t = np.arange(n) / fs
    left = (0.8 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    right = (0.8 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32)
    return left, right


# ── RDS coding layer ─────────────────────────────────────────────────────────

def test_rds_crc_is_linear_and_zero_preserving():
    assert R.rds_crc10(0) == 0
    a, b = 0x1234, 0xBEEF
    assert R.rds_crc10(a ^ b) == R.rds_crc10(a) ^ R.rds_crc10(b)


def test_rds_block_roundtrip_all_offsets():
    for name in R.RDS_OFFSETS:
        blk = R.rds_block_encode(0xCAFE, name)
        assert blk.shape == (26,)
        assert R.rds_block_classify(blk) == (name, 0xCAFE)


def test_rds_single_bit_correction_is_role_aware():
    blk = R.rds_block_encode(0xCAFE, "B")
    blk[7] ^= 1
    # context-free classification must NOT guess (a 1-bit error pattern can
    # sit within distance 1 of a different offset's coset)
    assert R.rds_block_classify(blk)[0] is None
    assert R._classify_expected(blk, ("B",)) == ("B", 0xCAFE)


def test_rds_group_decode_misaligned_stream():
    groups = R.rds_groups_0a(0x52A1, pty=9, tp=True, ps_name="ORIONFM ") \
        + R.rds_groups_2a(0x52A1, pty=9, tp=True, radiotext="HELLO WORLD")
    bits = R.rds_encode_groups(groups)
    rng = np.random.default_rng(0)
    stream = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8), bits,
                             rng.integers(0, 2, 20).astype(np.uint8)])
    d = R.rds_decode_bits(stream)
    assert d.pi == 0x52A1 and d.pty == 9 and d.tp is True
    assert d.ps_name == "ORIONFM " and d.radiotext == "HELLO WORLD"


def test_rds_group_decode_survives_bit_error():
    bits = R.rds_encode_groups(R.rds_groups_0a(0x1001, ps_name="TESTFM  "))
    stream = np.tile(bits, 2)
    stream[104 + 40] ^= 1          # one bit inside a synced group
    d = R.rds_decode_bits(stream)
    assert d.pi == 0x1001 and d.ps_name == "TESTFM  "


def test_rds_radiotext_long_message_segments():
    rt = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789"
    d = R.rds_decode_bits(R.rds_encode_groups(R.rds_groups_2a(0x2002,
                                                              radiotext=rt)))
    assert d.radiotext == rt


# ── MPX physical layer ───────────────────────────────────────────────────────

def test_stereo_separation_clean():
    n = 1 << 18
    left, right = _lr(n)
    iq, _ = fm_stereo_mod(left, right, FS)
    out = fm_stereo_demod(np.asarray(iq), FS)
    assert out.pilot_level == pytest.approx(0.09, rel=0.05)
    lL, lR = _tone_amp(out.left, 1000), _tone_amp(out.right, 1000)
    rR, rL = _tone_amp(out.right, 2500), _tone_amp(out.left, 2500)
    assert lL == pytest.approx(0.8, rel=0.05)
    assert rR == pytest.approx(0.8, rel=0.05)
    assert 20 * np.log10(lL / max(lR, 1e-9)) > 40.0
    assert 20 * np.log10(rR / max(rL, 1e-9)) > 40.0


def test_stereo_under_awgn_and_pilot_gate():
    n = 1 << 18
    left, right = _lr(n)
    iq = np.asarray(fm_stereo_mod(left, right, FS)[0])
    rng = np.random.default_rng(3)
    z = iq + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              .astype(np.complex64) * np.sqrt(1.0 / 10 ** 1.5 / 2))  # 15 dB
    out = fm_stereo_demod(z, FS)
    sep = 20 * np.log10(_tone_amp(out.left, 1000)
                        / max(_tone_amp(out.right, 1000), 1e-9))
    assert sep > 25.0
    assert out.pilot_level == pytest.approx(0.09, rel=0.15)
    # a mono transmission reads ~zero pilot — the stereo-blend gate
    mono_iq = np.asarray(fm_mod(left, FS, 75e3)[0])
    assert fm_stereo_demod(mono_iq, FS).pilot_level < 0.005


def test_rds_end_to_end_through_fm_chain():
    n = 1 << 19
    left, right = _lr(n)
    groups = R.rds_groups_0a(0x52A1, pty=9, tp=True, ps_name="ORIONFM ") \
        + R.rds_groups_2a(0x52A1, pty=9, radiotext="JAX NATIVE SDR")
    bits = R.rds_encode_groups(groups)
    iq = np.asarray(fm_stereo_mod(left, right, FS, rds_bits=bits)[0])
    rng = np.random.default_rng(5)
    z = iq + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              .astype(np.complex64) * np.sqrt(1.0 / 10 ** 1.5 / 2))  # 15 dB
    out = fm_stereo_demod(z, FS, decode_rds=True)
    assert out.rds.pi == 0x52A1
    assert out.rds.ps_name == "ORIONFM "
    assert out.rds.radiotext == "JAX NATIVE SDR"


def test_stereo_batched_matches_single():
    n = 1 << 17
    left, right = _lr(n)
    iq = np.asarray(fm_stereo_mod(left, right, FS)[0])
    iq2 = np.stack([iq, iq * np.complex64(np.exp(0.7j))])
    single = fm_stereo_demod(iq, FS)
    batched = fm_stereo_demod(iq2, FS)
    assert batched.left.shape == (2, n)
    np.testing.assert_allclose(batched.left[0], single.left, atol=1e-4)
    # a constant IQ phase offset is invisible to the discriminator past the
    # sample-0 impulse's filter transient (~pilot filter length)
    np.testing.assert_allclose(batched.left[1][4000:], single.left[4000:],
                               atol=1e-3)
    assert batched.pilot_level[0] == pytest.approx(0.09, rel=0.05)


def test_fm_stereo_fs_validation_and_manchester_seam():
    with pytest.raises(ValueError):
        fm_stereo_mod(np.zeros(64, np.float32), np.zeros(64, np.float32),
                      48_000.0)
    with pytest.raises(ValueError):
        fm_stereo_demod(np.zeros(64, np.complex64), 48_000.0)
    # odd-parity bit stream: the differential chain must continue across
    # message repeats (seam bug would flip one bit per wrap)
    bits = np.array([1, 0, 1, 1, 1], np.uint8)      # parity 0... make odd:
    bits = np.array([1, 0, 0, 0], np.uint8)         # parity 1
    wave = np.asarray(rds_manchester(bits, FS, 4096))
    assert wave.shape == (4096,) and np.isfinite(wave).all()


def test_fm_band_demod_blind_scan_three_stations():
    """Gateway receive: 3 stereo+RDS stations in one 2.4 MHz capture, found
    blind by spectrum_scan, channelized + demodulated in batched device
    programs."""
    from orion_sdr_tpu.demodulate.fm_stereo import fm_band_demod
    from orion_sdr_tpu.dsp.osc import rotate
    fs_wide = 2_400_000.0
    n = (1 << 18) * 10
    t = np.arange(n) / fs_wide

    def station(f_l, f_r, ps, center, gain=1.0):
        left = (0.8 * np.sin(2 * np.pi * f_l * t)).astype(np.float32)
        right = (0.8 * np.sin(2 * np.pi * f_r * t)).astype(np.float32)
        bits = R.rds_encode_groups(R.rds_groups_0a(0x1234, ps_name=ps))
        iq, _ = fm_stereo_mod(left, right, fs_wide, rds_bits=bits)
        return gain * np.asarray(rotate(np.asarray(iq), center, fs_wide)[0])

    band = (station(1000, 2500, "ALPHA FM", -800e3)
            + station(600, 1800, "BETA  FM", 0.0)
            + station(400, 3000, "GAMMAFM ", 650e3, gain=0.5)
            ).astype(np.complex64)
    rng = np.random.default_rng(1)
    band += ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             .astype(np.complex64) * 0.02)
    stations = fm_band_demod(band, fs_wide, decode_rds=True)
    found = {s.audio.rds.ps_name: s for s in stations}
    assert set(found) == {"ALPHA FM", "BETA  FM", "GAMMAFM "}
    assert abs(found["ALPHA FM"].center_hz + 800e3) < 5e3
    assert abs(found["GAMMAFM "].center_hz - 650e3) < 5e3
    for name, (f_l, f_r) in {"ALPHA FM": (1000, 2500),
                             "BETA  FM": (600, 1800),
                             "GAMMAFM ": (400, 3000)}.items():
        a = found[name].audio
        assert a.pilot_level == pytest.approx(0.09, rel=0.1)
        l_amp = _tone_amp(a.left, f_l, fs=240_000.0)
        leak = _tone_amp(a.right, f_l, fs=240_000.0)
        assert l_amp == pytest.approx(0.8, rel=0.1)
        assert 20 * np.log10(l_amp / max(leak, 1e-9)) > 25.0
        assert _tone_amp(a.right, f_r, fs=240_000.0) == pytest.approx(
            0.8, rel=0.1)


def test_de_emphasis_attenuates_highs():
    n = 1 << 17
    t = np.arange(n) / FS
    hi = (0.5 * np.sin(2 * np.pi * 12_000 * t)).astype(np.float32)
    lo = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    iq = np.asarray(fm_stereo_mod(hi + lo, hi + lo, FS)[0])
    out = fm_stereo_demod(iq, FS, de_emphasis_us=50.0)
    # 50 µs: |H| at 12 kHz ≈ 1/sqrt(1+(2π·12e3·50e-6)²) ≈ 0.26 of 300 Hz
    ratio = _tone_amp(out.left, 12_000) / _tone_amp(out.left, 300)
    assert ratio < 0.35


def test_am_band_demod_blind_scan():
    """AM band gateway: three carriers found blind, envelope audio correct,
    leakage-skirt artifacts gated out."""
    from orion_sdr_tpu.modulate.analog import am_mod
    from orion_sdr_tpu.demodulate.analog import am_band_demod
    from orion_sdr_tpu.dsp.osc import rotate
    fs = 1_000_000.0
    n = 1 << 19
    t = np.arange(n) / fs

    def station(f_audio, center, gain):
        audio = (0.6 * np.sin(2 * np.pi * f_audio * t)).astype(np.float32)
        iq, _ = am_mod(audio, fs)
        return gain * np.asarray(rotate(np.asarray(iq), center, fs)[0])

    band = (station(800, -300e3, 1.0) + station(1500, 50e3, 0.6)
            + station(2200, 350e3, 0.3)).astype(np.complex64)
    rng = np.random.default_rng(0)
    band += ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             .astype(np.complex64) * 0.01)
    stations = am_band_demod(band, fs)
    assert len(stations) == 3
    got = {}
    for s in stations:
        seg = s.audio[4000:]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        f = np.fft.rfftfreq(len(seg), 1 / s.fs_audio)
        got[round(s.center_hz / 1e3)] = f[np.argmax(spec[5:]) + 5]
    assert abs(got[-300] - 800) < 5
    assert abs(got[50] - 1500) < 5
    assert abs(got[350] - 2200) < 5


def test_ssb_band_demod_three_channels():
    """SSB gateway: three USB voice channels from one capture; LSB sense
    via channel conjugation."""
    from orion_sdr_tpu.modulate.analog import ssb_mod
    from orion_sdr_tpu.demodulate.analog import ssb_band_demod
    from orion_sdr_tpu.dsp.osc import rotate
    from tests.helpers import tone_snr_db
    fs = 480_000.0
    n = 1 << 17
    t = np.arange(n) / fs

    def station(f_audio, dial, usb=True):
        audio = (0.5 * np.sin(2 * np.pi * f_audio * t)).astype(np.float32)
        iq, _ = ssb_mod(audio, fs, 2800.0, 1500.0, 0.0, usb=usb)
        return np.asarray(rotate(np.asarray(iq), dial, fs)[0])

    band = (station(1200, -150e3) + station(800, 10e3)
            + station(500, 120e3)).astype(np.complex64)
    rng = np.random.default_rng(0)
    band += ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             .astype(np.complex64) * 0.005)
    stations = ssb_band_demod(band, fs, [-150e3, 10e3, 120e3])
    assert len(stations) == 3
    for s, f_a in zip(stations, (1200, 800, 500)):
        seg = s.audio[int(0.12 * s.fs_audio):]
        assert tone_snr_db(s.fs_audio, f_a, seg) > 20.0, s.center_hz

    lsb = np.asarray(station(900, -40e3, usb=False), np.complex64)
    got = ssb_band_demod(lsb, fs, [-40e3], usb=False)
    seg = got[0].audio[int(0.12 * got[0].fs_audio):]
    assert tone_snr_db(got[0].fs_audio, 900, seg) > 20.0
