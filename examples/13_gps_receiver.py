"""GPS L1 C/A receiver: acquisition → tracking → LNAV message → PVT.

Two-part demo (full-length nav decode takes a ~19 s capture — see
tests/test_gnss_nav.py::test_two_satellite_capture_to_ephemeris_roundtrip
for that end-to-end proof):

1. Signal layer on a 1-second two-satellite capture: the batched
   acquisition grid finds both PRNs' Doppler + code phase, tracking holds
   lock and recovers nav bits.
2. Message layer at bit level: encode a broadcast ephemeris into wire
   LNAV subframes (IS-GPS-200 parity), decode it back, place the
   satellite on its orbit, and solve a 5-satellite position fix.

Run: python examples/13_gps_receiver.py   (CPU or GPU)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr


def main():
    fs = 2.048e6
    rng = np.random.default_rng(0)

    # ── 1. signal layer: two satellites + noise, one second ────────────
    svs = [(7, 1200.0, 101.7, 1.0), (13, -2600.0, 512.2, 0.7)]
    n_ms = 1000
    n = int(fs * 1e-3) * n_ms
    z = (0.8 / np.sqrt(2) * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    nav = rng.integers(0, 2, 64).astype(np.uint8)
    for prn, dopp, chips, amp in svs:
        z += sdr.gps_ca_mod(prn, fs, n_ms, dopp, chips, nav_bits=nav,
                            amplitude=amp)

    print("acquisition (32 PRN x 41 Doppler x 2048 code phases):")
    for acq in sdr.gps_acquire(z, fs):
        print(f"  PRN {acq.prn:2d}: doppler {acq.doppler_hz:+7.0f} Hz, "
              f"code phase {acq.code_phase_samples:5d} samp, "
              f"score {acq.score:.1f}")

    acq = sdr.gps_acquire(z, fs, prns=[7])[0]
    trk = sdr.gps_track(z, fs, 7, acq.doppler_hz, acq.code_phase_samples)
    print(f"tracking PRN 7: lock {trk.lock:.1f}, "
          f"doppler settles to {float(np.median(trk.doppler_hz[300:])):+.0f} Hz, "
          f"{len(trk.nav_bits)} nav bits recovered")

    # ── 2. message layer: ephemeris through the LNAV wire format ───────
    eph = sdr.GpsEphemeris(
        week=221, iodc=0x1A7, iode=0xA7, sqrt_a=5153.712, e=0.0123,
        m0=1.2345, omega0=-2.2345, i0=0.9617, omega=2.7182,
        omega_dot=-8.1e-9, delta_n=4.3e-9, idot=4.0e-10,
        t_oe=302400.0, t_oc=302400.0, a_f0=4.57e-4, a_f1=-3.1e-12,
        c_rs=-112.8, c_rc=287.5, c_uc=-6.3e-6, c_us=5.2e-6,
        c_ic=1.1e-7, c_is=-9.3e-8, t_gd=-5.1e-9)
    bits = sdr.nav_subframes_encode(eph, tow_count_start=201600)
    frame = sdr.nav_subframes_decode(bits)
    d = frame.ephemeris
    print(f"\nLNAV roundtrip: subframes {[s.sfid for s in frame.subframes]},"
          f" IODC {d.iodc:#x}, sqrt_a {d.sqrt_a:.3f}, e {d.e:.7f}")

    pos = sdr.eph_sat_pos(d, d.t_oe)
    print(f"satellite at t_oe: |r| = {np.linalg.norm(pos) / 1e6:.3f} Mm "
          f"(GPS orbit ~26.56 Mm)")

    # 5-satellite fix with a receiver clock bias
    truth = np.array([1113194.0, -4842168.0, 3985243.0])
    sats, prs = [], []
    for k in range(5):
        e2 = sdr.GpsEphemeris(sqrt_a=5153.7, e=0.01, m0=1.05 * k,
                              omega0=1.0 * k, i0=0.96, omega=0.3 * k,
                              t_oe=302400.0)
        p = sdr.eph_sat_pos(e2, 302400.0 + 40.0 * k)
        sats.append(p)
        prs.append(np.linalg.norm(p - truth) + 8500.0
                   + rng.normal(0.0, 0.5))
    fix, bias = sdr.gps_fix(np.stack(sats), np.array(prs))
    print(f"PVT fix error: {np.linalg.norm(fix - truth):.2f} m, "
          f"clock bias {bias:.1f} m (true 8500)")


if __name__ == "__main__":
    main()
