"""Weak-signal beacon band: three WSPR-style transmitters at different
powers and offsets in one 200 Hz window, the weakest far below the noise
floor — all recovered by the K=32 sequential decoder from a single
spectrogram program.

Run: python examples/12_weak_signal_beacons.py   (~1 min on CPU)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr
from orion_sdr_tpu.demodulate.wspr import wspr_decode_band

rng = np.random.default_rng(11)

b1 = np.asarray(sdr.wspr_mod("K1ABC", "FN42", 37, base_hz=1420.0))
b2 = np.asarray(sdr.wspr_mod("W1AW", "FN31", 30, base_hz=1500.0)) * 0.4
b3 = np.asarray(sdr.wspr_mod("DL2XYZ", "JO62", 23, base_hz=1565.0)) * 0.15

n = len(b1) + 40_000
band = np.zeros(n, np.complex64)
band[:len(b1)] += b1
band[9_000:9_000 + len(b2)] += b2
band[22_000:22_000 + len(b3)] += b3

# complex noise with per-sample variance 0.02: the 0.15-amplitude beacon
# sits ≈ −24 dB in the 2.5 kHz reference bandwidth
band += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64) * np.sqrt(0.02 / 2)

for m in wspr_decode_band(band):
    print(f"  {m.callsign:8s} {m.grid}  {m.dbm} dBm")
