"""Drop-in Block-style classes: reference call sites, batched JAX compute.

Users of the reference's Python API (`orion_sdr`) construct stateful Block
classes and stream captures through `.process()`. The same code runs here —
`orion_sdr_tpu.blocks` wraps the batched functional compute in classes with
the reference wrappers' exact constructor signatures.

Run: python examples/05_dropin_blocks.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr


def main():
    fs = 48_000.0

    # 1. FM, reference-style: construct once, stream chunks through process()
    t = np.arange(1 << 15) / fs
    audio = 0.4 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    mod = sdr.FmPhaseAccumMod(fs, 5000.0)
    demod = sdr.FmQuadratureDemod(fs, 5000.0, 3000.0)
    iq = mod.process(audio)
    out = np.concatenate([demod.process(c)
                          for c in np.array_split(iq, 7)])
    # the reference's demod gain convention recovers the tone scaled by
    # 2π/fs; measure the tone projection SNR like its tests do
    n = len(out) - 4000
    tt = np.arange(n) / fs
    proj = abs(np.mean(out[4000:] * np.exp(-2j * np.pi * 1000.0 * tt)))
    off = abs(np.mean(out[4000:] * np.exp(-2j * np.pi * 730.0 * tt)))
    print(f"1. FM blocks: {len(out)} audio samples, tone SNR "
          f"{20*np.log10(proj/(off+1e-20)):.0f} dB")

    # 2. FT8, reference-style: Codec + Mod/Demod classes
    payload = sdr.ft8_pack_standard("CQ", "KA1ABC", "FN42")
    codec = sdr.Ft8Codec()
    tones = codec.encode(payload)
    iq8 = sdr.Ft8Mod(12000.0, 1000.0).modulate(tones)
    got = sdr.Ft8Demod(12000.0, 1000.0).demodulate(iq8)
    decoded = codec.decode_hard(got)
    print(f"2. FT8 blocks: {sdr.ft8_unpack(decoded)}")

    # 3. PSK31 streaming demod class with carried AFC/mixer state
    iq31 = sdr.Bpsk31Mod(8000.0, rf_hz=1000.0).modulate_text("via blocks")
    d31 = sdr.Bpsk31Demod(8000.0, rf_hz=1000.0)
    soft = np.concatenate([d31.process(c)
                           for c in np.array_split(iq31, 5)])
    bits = sdr.Bpsk31Decider().process(soft)
    print(f"3. PSK31 blocks: {sdr.VaricodeDecoder().push_bits(bits)!r}")

    # 4. QAM at an RF carrier
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 64 * 6).astype(np.uint8)
    iqq = sdr.QamMod(64, fs, rf_hz=12_000.0).process(bits)
    back = sdr.QamDemod(64, 1.0, fs, rf_hz=12_000.0).process(iqq)
    print(f"4. QAM-64 blocks bit-exact: "
          f"{np.array_equal(back[:len(bits)], bits)}")


if __name__ == "__main__":
    main()
