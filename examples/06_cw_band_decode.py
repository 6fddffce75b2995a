"""CW/Morse: key three transmissions into one band, decode them all at once.

Run: python examples/06_cw_band_decode.py
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr

FS = 8000.0

# three operators on the band: different speeds, tones, signal strengths
signals = [
    ("CQ CQ DE W1AW", 18.0, 550.0, 1.0),
    ("HELLO WORLD", 28.0, 950.0, 0.3),
    ("73 GL SK", 35.0, 1350.0, 0.12),
]

rng = np.random.default_rng(42)
n = int(FS * 14)
buf = (rng.normal(0, 0.02, n) + 1j * rng.normal(0, 0.02, n)).astype(
    np.complex64)
for text, wpm, tone, amp in signals:
    enc = sdr.MorseEncoder(FS, wpm).with_jitter(12.0)   # a human fist
    iq, _ = sdr.cw_mod(enc.encode_text(text), FS, tone)
    start = int(rng.integers(0, FS))
    buf[start:start + len(iq)] += amp * np.asarray(iq)[: n - start]

# one batched device pass extracts every carrier's keying envelope
for r in sdr.morse_decode_band(buf, FS, 400.0, 1500.0):
    print(f"{r.tone_hz:7.1f} Hz  {r.score_db:5.1f} dB  {r.wpm:4.1f} wpm  "
          f"{r.text!r}")
