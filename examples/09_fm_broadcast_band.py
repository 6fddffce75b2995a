"""FM broadcast band: three stereo+RDS stations in one wideband capture —
blind-scan the band, channelize every station in one batched device
program, and decode stereo audio + station text for all of them at once.

Run: python examples/09_fm_broadcast_band.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr

FS_WIDE = 2_400_000.0          # one SDR front-end capture of the band
N = (1 << 18) * 10             # ~1.1 s

t = np.arange(N) / FS_WIDE
rng = np.random.default_rng(7)


def station(f_left, f_right, pi, ps, rt, center_hz, gain):
    """One broadcaster: distinct L/R program + RDS PS/radiotext."""
    left = (0.8 * np.sin(2 * np.pi * f_left * t)).astype(np.float32)
    right = (0.8 * np.sin(2 * np.pi * f_right * t)).astype(np.float32)
    groups = sdr.rds_groups_0a(pi, pty=10, ps_name=ps) \
        + sdr.rds_groups_2a(pi, pty=10, radiotext=rt)
    iq, _ = sdr.fm_stereo_mod(left, right, FS_WIDE,
                              rds_bits=sdr.rds_encode_groups(groups))
    from orion_sdr_tpu.dsp.osc import rotate
    return gain * np.asarray(rotate(np.asarray(iq), center_hz, FS_WIDE)[0])


band = (station(1000, 2500, 0x1111, "ALPHA FM", "MORNING SHOW", -800e3, 1.0)
        + station(600, 1800, 0x2222, "BETA  FM", "ALL NEWS ALL DAY", 0.0, 0.7)
        + station(400, 3000, 0x3333, "GAMMAFM ", "CLASSIC HITS", 650e3, 0.4)
        ).astype(np.complex64)
band += ((rng.standard_normal(N) + 1j * rng.standard_normal(N))
         .astype(np.complex64) * 0.02)

# scan-then-receive: no prior channel plan
stations = sdr.fm_band_demod(band, FS_WIDE, decode_rds=True,
                             de_emphasis_us=50.0)

print(f"found {len(stations)} stations:")
for s in stations:
    a = s.audio
    rms_l = float(np.sqrt(np.mean(a.left[20000:] ** 2)))
    print(f"  {s.center_hz / 1e3:+9.1f} kHz  pilot={a.pilot_level:.3f}  "
          f"audio rms={rms_l:.2f}  PI=0x{a.rds.pi:04X}  "
          f"PS={a.rds.ps_name!r}  RT={a.rds.radiotext!r}")
