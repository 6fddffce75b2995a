"""GPS LNAV message layer: parity, subframe codec, ephemeris, PVT.

Completes the GNSS family's codec → capture decode arc.
"""
import os

import numpy as np
import pytest

import orion_sdr_tpu as sdr
from orion_sdr_tpu.gnss_nav import (GPS_MU, GPS_OMEGA_E, _solve_tail,
                                    nav_word_encode, nav_word_check)


EPH = sdr.GpsEphemeris(
    week=221, ura=1, sv_health=0, iodc=0x1A7, t_gd=-5.12e-9,
    t_oc=302400.0, a_f2=0.0, a_f1=-3.1e-12, a_f0=4.57e-4,
    iode=0xA7, c_rs=-112.8125, delta_n=4.3e-9, m0=1.23456,
    c_uc=-6.3e-6, e=0.0123456, c_us=5.2e-6, sqrt_a=5153.712,
    t_oe=302400.0, c_ic=1.1e-7, omega0=-2.2345, c_is=-9.3e-8,
    i0=0.9617, c_rc=287.46875, omega=2.7182, omega_dot=-8.1e-9,
    idot=4.0e-10,
)


def test_word_parity_roundtrip_all_seeds():
    rng = np.random.default_rng(0)
    for d29s in (0, 1):
        for d30s in (0, 1):
            for _ in range(20):
                d = int(rng.integers(0, 1 << 24))
                w = nav_word_encode(d, d29s, d30s)
                assert nav_word_check(w, d29s, d30s) == d


def test_word_parity_detects_any_single_bit_error():
    w = nav_word_encode(0x8B0123, 0, 0)
    for i in range(30):
        bad = w.copy()
        bad[i] ^= 1
        assert nav_word_check(bad, 0, 0) is None


def test_solved_tail_zeroes_trailing_parity():
    for d29s in (0, 1):
        for d30s in (0, 1):
            w = nav_word_encode(_solve_tail(0x2ABCDE >> 2, d29s, d30s),
                                d29s, d30s)
            assert w[28] == 0 and w[29] == 0


def test_subframe_roundtrip_ephemeris():
    bits = sdr.nav_subframes_encode(EPH, tow_count_start=201600)
    assert bits.shape == (1500,)
    frame = sdr.nav_subframes_decode(bits)
    assert [s.sfid for s in frame.subframes] == [1, 2, 3, 4, 5]
    # HOW carries the NEXT subframe's start time
    assert frame.subframes[0].tow_s == (201600 + 4) * 1.5
    d = frame.ephemeris
    assert d is not None
    assert (d.week, d.iodc, d.iode) == (EPH.week, EPH.iodc, EPH.iode)
    # quantization: each field must round-trip within one wire LSB
    for name, scale in [
        ("t_gd", 2**-31), ("a_f1", 2**-43), ("a_f0", 2**-31),
        ("c_rs", 2**-5), ("c_uc", 2**-29), ("c_us", 2**-29),
        ("c_ic", 2**-29), ("c_is", 2**-29), ("c_rc", 2**-5),
        ("e", 2**-33), ("sqrt_a", 2**-19),
    ]:
        assert abs(getattr(d, name) - getattr(EPH, name)) <= scale, name
    for name in ("m0", "omega0", "i0", "omega"):
        assert abs(getattr(d, name) - getattr(EPH, name)) <= np.pi * 2**-31
    for name in ("delta_n", "omega_dot", "idot"):
        assert abs(getattr(d, name) - getattr(EPH, name)) <= np.pi * 2**-43
    assert d.t_oc == EPH.t_oc and d.t_oe == EPH.t_oe


def test_subframe_decode_inverted_polarity_and_offset():
    bits = sdr.nav_subframes_encode(EPH)
    lead = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1], np.uint8)
    stream = np.concatenate([lead, 1 - bits])        # inverted + offset
    frame = sdr.nav_subframes_decode(stream)
    assert frame.ephemeris is not None
    assert frame.ephemeris.iodc == EPH.iodc


def test_subframe_parity_error_drops_subframe():
    bits = sdr.nav_subframes_encode(EPH)
    bad = bits.copy()
    bad[300 + 95] ^= 1                                # inside subframe 2
    frame = sdr.nav_subframes_decode(bad)
    assert 2 not in [s.sfid for s in frame.subframes]
    assert frame.ephemeris is None                    # SF2 lost


def test_eph_sat_pos_orbit_sanity():
    p1 = sdr.eph_sat_pos(EPH, EPH.t_oe)
    r = np.linalg.norm(p1)
    # GPS semi-major axis ~26560 km; small e keeps |r| within ~2%
    assert 25.9e6 < r < 27.2e6
    # 45 min later (~1/16 orbit + earth rotation) the chord is ~0.3 r
    p2 = sdr.eph_sat_pos(EPH, EPH.t_oe + 2700.0)
    assert np.linalg.norm(p2 - p1) > 0.2 * r
    # ECEF speed = inertial (~n0*r ≈ 3.9 km/s) minus the earth-rotation
    # carry (ω_e*r*cos(i-ish) ≈ 1.9 km/s), so anywhere in 2-4 km/s is sane
    dt = 10.0
    p3 = sdr.eph_sat_pos(EPH, EPH.t_oe + dt)
    v = np.linalg.norm(p3 - p1) / dt
    n0 = np.sqrt(GPS_MU / EPH.sqrt_a**6)
    w_e = GPS_OMEGA_E * r
    assert n0 * r - w_e - 300 < v < n0 * r + w_e + 300


def test_gps_fix_recovers_position_and_clock():
    rng = np.random.default_rng(3)
    truth = np.array([1113194.0, -4842168.0, 3985243.0])
    bias = 8500.0                                     # meters (~28 us)
    sats = []
    for k in range(6):
        e = sdr.GpsEphemeris(
            sqrt_a=5153.7, e=0.01, m0=k * 1.05, omega0=k * 1.0,
            i0=0.96, omega=0.3 * k, t_oe=302400.0)
        sats.append(sdr.eph_sat_pos(e, 302400.0 + 40.0 * k))
    sats = np.stack(sats)
    pr = np.linalg.norm(sats - truth, axis=1) + bias \
        + rng.normal(0, 0.5, len(sats))
    pos, b = sdr.gps_fix(sats, pr)
    assert np.linalg.norm(pos - truth) < 5.0
    assert abs(b - bias) < 5.0


def test_gps_fix_requires_four_sats():
    with pytest.raises(ValueError):
        sdr.gps_fix(np.zeros((3, 3)), np.zeros(3))


@pytest.mark.skipif(not os.environ.get("ORION_SDR_TPU_PERF"),
                    reason="tier 3: ~3 min CPU (19 s capture, 2 tracks); "
                           "verified green 2026-08-19 (175 s)")
def test_two_satellite_capture_to_ephemeris_roundtrip():
    """Synthesized 2-SV capture → acquire → track → nav bits → parity →
    ephemeris fields, per satellite (the full codec → capture decode arc).
    ~19 s of signal: three subframes at 50 bps plus tracking settle."""
    FS = 2.048e6
    eph2 = sdr.GpsEphemeris(
        week=222, ura=2, sv_health=0, iodc=0x055, t_gd=3.1e-9,
        t_oc=54000.0, a_f2=0.0, a_f1=1.2e-12, a_f0=-2.3e-4,
        iode=0x55, c_rs=54.03125, delta_n=5.1e-9, m0=-2.5,
        c_uc=3.1e-6, e=0.0045, c_us=-1.2e-6, sqrt_a=5153.655,
        t_oe=54000.0, c_ic=-6.5e-8, omega0=1.75, c_is=4.1e-8,
        i0=0.9722, c_rc=-198.5, omega=-0.77, omega_dot=-7.7e-9,
        idot=-2.5e-10)
    rng = np.random.default_rng(9)
    svs = [(7, 1200.0, 101.7, 1.0, EPH), (13, -2600.0, 512.2, 0.8, eph2)]
    streams = {}
    n_bits = 30 + 900 + 6
    n_ms = n_bits * 20 + 15
    n = int(FS * 1e-3) * n_ms
    z = (0.25 / np.sqrt(2) * (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for prn, dopp, chips, amp, eph in svs:
        bits = np.concatenate([
            rng.integers(0, 2, 30).astype(np.uint8),
            sdr.nav_subframes_encode(eph)[:900],
            rng.integers(0, 2, 6).astype(np.uint8)])
        streams[prn] = bits
        z = z + sdr.gps_ca_mod(prn, FS, n_ms, dopp, chips, nav_bits=bits,
                               amplitude=amp,
                               carrier_phase=rng.uniform(0, 2 * np.pi))
    for prn, dopp, chips, amp, eph in svs:
        frame = sdr.gps_decode_ephemeris(z, FS, prn)
        d = frame.ephemeris
        assert d is not None, f"PRN {prn}: no ephemeris decoded"
        assert d.iodc == eph.iodc and d.iode == eph.iode
        assert d.week == eph.week
        assert abs(d.sqrt_a - eph.sqrt_a) <= 2**-19
        assert abs(d.e - eph.e) <= 2**-33
        assert abs(d.m0 - eph.m0) <= np.pi * 2**-31
        assert abs(d.omega0 - eph.omega0) <= np.pi * 2**-31
        assert d.t_oe == eph.t_oe
        # and the decoded ephemeris places the satellite on a GPS orbit
        r = np.linalg.norm(sdr.eph_sat_pos(d, d.t_oe))
        assert 25.9e6 < r < 27.2e6


def test_capture_to_ephemeris_single_subframe_bits():
    """Bits → frame machinery over a tracked-bits-shaped stream: encode,
    embed at a bit offset with noise-free polarity flip, decode."""
    bits = sdr.nav_subframes_encode(EPH, tow_count_start=4)
    rng = np.random.default_rng(5)
    stream = np.concatenate([
        rng.integers(0, 2, 17).astype(np.uint8), bits])
    frame = sdr.nav_subframes_decode(stream)
    assert frame.ephemeris is not None
    assert frame.ephemeris.sqrt_a == pytest.approx(EPH.sqrt_a, abs=2**-19)


# ── subframe 4/5 wire format: almanac, iono/UTC, Klobuchar ──────────────────

ALM = sdr.GpsAlmanac(
    prn=7, e=0.0091, t_oa=319488.0, delta_i=0.0123, omega_dot=-2.51e-9,
    sv_health=0, sqrt_a=5153.6, omega0=-1.9876, omega=0.8765, m0=-2.3456,
    a_f0=3.8e-5, a_f1=-7.3e-12,
)
IONO = sdr.GpsIono(alpha=(1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8),
                   beta=(1.29e5, 4.9152e4, -1.966e5, 3.277e5))
UTC = sdr.GpsUtc(a0=9.3e-9, a1=-2.7e-15, t_ot=405504.0, wn_t=221,
                 delta_t_ls=18, wn_lsf=137, dn=7, delta_t_lsf=18)


def test_almanac_iono_utc_page_roundtrip():
    """Wire-format round-trip of the LNAV subframe 4/5 layer (IS-GPS-200
    20.3.3.5.1.2 almanac page, 20.3.3.5.1.6/7 page 18): encode both pages
    into a full frame, decode, and recover every field within one LSB."""
    bits = sdr.nav_subframes_encode(
        EPH, tow_count_start=8,
        sf4_words=sdr.iono_utc_page_words(IONO, UTC),
        sf5_words=sdr.almanac_page_words(ALM))
    frame = sdr.nav_subframes_decode(bits)
    assert frame.ephemeris is not None

    assert set(frame.almanacs) == {7}
    (key,) = frame.almanacs
    assert type(key) is int                      # clean host-side API
    a = frame.almanacs[7]
    assert type(a.prn) is int and a.prn == ALM.prn
    assert a.sv_health == ALM.sv_health
    assert a.t_oa == ALM.t_oa                    # 4096 s LSB, exact here
    assert abs(a.e - ALM.e) <= 2**-21
    assert abs(a.sqrt_a - ALM.sqrt_a) <= 2**-11
    assert abs(a.delta_i - ALM.delta_i) <= np.pi * 2**-19
    assert abs(a.omega_dot - ALM.omega_dot) <= np.pi * 2**-38
    for name in ("omega0", "omega", "m0"):
        assert abs(getattr(a, name) - getattr(ALM, name)) <= np.pi * 2**-23
    assert abs(a.a_f0 - ALM.a_f0) <= 2**-20
    assert abs(a.a_f1 - ALM.a_f1) <= 2**-38

    assert frame.iono is not None and frame.utc is not None
    for got, want, lsb in zip(frame.iono.alpha, IONO.alpha,
                              (2**-30, 2**-27, 2**-24, 2**-24)):
        assert abs(got - want) <= lsb
    for got, want, lsb in zip(frame.iono.beta, IONO.beta,
                              (2**11, 2**14, 2**16, 2**16)):
        assert abs(got - want) <= lsb
    u = frame.utc
    assert abs(u.a0 - UTC.a0) <= 2**-30
    assert abs(u.a1 - UTC.a1) <= 2**-50
    assert u.t_ot == UTC.t_ot
    assert (u.wn_t, u.delta_t_ls, u.wn_lsf, u.dn, u.delta_t_lsf) == \
        (UTC.wn_t, UTC.delta_t_ls, UTC.wn_lsf, UTC.dn, UTC.delta_t_lsf)
    assert all(type(v) is int
               for v in (u.wn_t, u.delta_t_ls, u.wn_lsf, u.dn,
                         u.delta_t_lsf))


def test_navframe_default_almanacs_not_shared():
    """GpsNavFrame() without almanacs must not expose one shared mutable
    dict across instances."""
    f1 = sdr.GpsNavFrame([], None)
    f2 = sdr.GpsNavFrame([], None)
    assert f1.almanacs is None and f2.almanacs is None


def test_klobuchar_known_answers():
    """Klobuchar model (IS-GPS-200 20.3.3.5.2.5) against the classic
    Klobuchar-1987 broadcast set (40°N 260°E, el 20°, az 210°): expected
    values from an independent step-by-step hand evaluation of the ICD
    equations (pinned; night case is the 5 ns floor × slant)."""
    iono_1987 = sdr.GpsIono(alpha=(3.82e-9, 1.49e-8, -1.79e-7, 0.0),
                            beta=(1.43e5, 0.0, -3.28e5, 1.13e5))
    lat, lon = np.deg2rad(40.0), np.deg2rad(-100.0)
    az, el = np.deg2rad(210.0), np.deg2rad(20.0)
    # night (t=593100 s): AMP clamps at 0 → slant × 5 ns = 10.880 ns
    night = sdr.klobuchar_delay(iono_1987, lat, lon, az, el, 593100.0)
    assert night == pytest.approx(1.08801243e-8, rel=1e-6)
    # day (local ~14:00 at the pierce point): cosine term near peak
    day = sdr.klobuchar_delay(IONO, lat, lon, az, el, 75440.0)
    assert day == pytest.approx(2.98407515e-8, rel=1e-6)
    assert day > night
    # zenith reduces the slant factor toward 1
    zen = sdr.klobuchar_delay(IONO, lat, lon, az, np.deg2rad(90.0), 75440.0)
    assert zen < day


def test_alm_sat_pos_matches_ephemeris_orbit():
    """An almanac distilled from EPH (harmonics dropped, i = 0.3 sc + δi)
    places the satellite within tens of km of the full ephemeris."""
    alm = sdr.GpsAlmanac(
        prn=1, e=EPH.e, t_oa=EPH.t_oe,
        delta_i=EPH.i0 - 0.3 * np.pi, omega_dot=EPH.omega_dot,
        sqrt_a=EPH.sqrt_a, omega0=EPH.omega0, omega=EPH.omega, m0=EPH.m0)
    for dt in (0.0, 1800.0):
        pa = sdr.alm_sat_pos(alm, EPH.t_oe + dt)
        pe = sdr.eph_sat_pos(EPH, EPH.t_oe + dt)
        assert np.linalg.norm(pa - pe) < 50e3
        r = np.linalg.norm(pa)
        assert 25.9e6 < r < 27.2e6
