"""Fully blind reception, twice over:

1. `band_decode`: scan a wideband capture, classify every occupant, run
   the right receiver — AM audio, POCSAG pager text — no channel plan.
2. `dvb_t_blind_decode`: a DVB-T capture with UNKNOWN guard interval,
   constellation, code rate and payload length — everything recovered
   from the GI metric + TPS signalling + the TS layer itself.

Run: python examples/11_blind_receive.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr
from orion_sdr_tpu.dsp.osc import rotate

rng = np.random.default_rng(7)

# ── 1. a mystery band ────────────────────────────────────────────────────────
fs = 500_000.0
n = 1 << 19
t = np.arange(n) / fs


def at(z, center, gain=1.0):
    zz = np.ascontiguousarray(np.asarray(z)[:n], np.complex64)
    if len(zz) < n:
        zz = np.concatenate([zz, np.zeros(n - len(zz), np.complex64)])
    return gain * np.asarray(rotate(zz, center, fs)[0])


am = sdr.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32), fs)[0]
pager = sdr.pocsag_mod([sdr.PocsagPage(address=0xB41, function=3,
                                       text="MEET AT 0900")] * 4, fs)
band = (at(am, -150e3) + at(pager, 100e3, 0.8)).astype(np.complex64)
band += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64) * 0.004

print("band_decode over a blind 500 kHz capture:")
for e in sdr.band_decode(band, fs):
    extra = f"text={e.text!r}" if e.text else \
        (f"audio {len(e.audio)} samples @ {e.fs_audio:.0f} Hz"
         if e.audio is not None else "")
    print(f"  {e.segment.center_hz / 1e3:+9.1f} kHz  "
          f"{e.signal.label:10s} ({e.signal.confidence:.2f})  {extra}")

# ── 2. a mystery DVB-T transmission ──────────────────────────────────────────
payload = rng.integers(0, 256, 700).astype(np.uint8)
secret_params = sdr.DvbTFrameParams(
    sdr.DvbTLinkParams("1/16", "qam16", "3/4"), 1, 42)
frame = sdr.DvbTFrameMod(secret_params).modulate(payload)
capture = np.concatenate([np.zeros(2000, np.complex64), frame.iq])

out = sdr.dvb_t_blind_decode(capture)
print("\ndvb_t_blind_decode (TX parameters withheld):")
print(f"  guard={out.guard}  constellation={out.tps.constellation}  "
      f"rate={out.tps.code_rate_hp}  cell_id={out.tps.cell_id}")
print(f"  payload recovered: "
      f"{bool(np.array_equal(out.payload[:len(payload)], payload))} "
      f"({len(payload)} bytes)")
