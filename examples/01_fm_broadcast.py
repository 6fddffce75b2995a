"""FM broadcast receive: synthesize → demodulate → measure.

Run: python examples/01_fm_broadcast.py   (CPU or GPU)
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr


def main():
    fs = 480_000.0
    deviation = 75_000.0
    n = 1 << 18

    # a 1 kHz test tone, FM modulated, with 20 dB of channel noise
    t = np.arange(n) / fs
    audio_in = 0.5 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    iq, _ = sdr.fm_mod(audio_in, fs, deviation)
    iq = np.asarray(iq)
    iq = iq + np.asarray(sdr.awgn(np.random.default_rng(0), n, 0.01))

    audio, _ = sdr.fm_demod(iq, fs, deviation, audio_bw_hz=5_000.0)
    audio = np.asarray(audio, np.float64)[4096:]

    # scale-invariant tone check: projection onto 1 kHz vs an off-tone bin
    def proj(f):
        t = 2 * np.pi * f / fs * np.arange(len(audio))
        return np.hypot(np.sum(audio * np.cos(t)), np.sum(audio * np.sin(t)))

    snr = 20 * np.log10(proj(1000.0) / max(proj(730.0), 1e-30))
    print(f"recovered 1 kHz tone: {snr:.1f} dB above off-tone floor")
    assert snr > 20.0


if __name__ == "__main__":
    main()
