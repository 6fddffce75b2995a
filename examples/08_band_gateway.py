"""Gateway band receive: many links, one wideband capture.

Three COFDM links at different centers inside an 8 MS/s capture are
channelized in ONE batched device program (`dsp.Channelizer`) and decoded
by per-channel streaming receivers (`OfdmFrameBandStreamDemod`). The same
pattern serves DVB-T multiplexes via `DvbTBandStreamDemod`.

Run: python examples/08_band_gateway.py
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr


def upsample8(x):
    """Exact bandlimited 8× upsampling by FFT zero-padding (the frame is
    zero-guarded, so the circular wrap only touches dead air)."""
    x = np.concatenate([np.zeros(256), np.asarray(x, np.complex128),
                        np.zeros(256)])
    spec = np.fft.fft(x)
    n = len(x)
    wide = np.zeros(8 * n, np.complex128)
    wide[: n // 2] = spec[: n // 2]
    wide[-(n - n // 2):] = spec[n // 2:]
    return 8.0 * np.fft.ifft(wide)


def main():
    fs_link, fs_wide = 1e6, 8e6
    plan = sdr.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = sdr.OfdmConfig(plan, fs=fs_link)
    pre = sdr.OfdmPreamble(repeat_len=128, num_repeats=4
                           ).with_training_symbol(256, 64)
    table = sdr.McsTable.default_ladder()

    centers = [-2.4e6, 0.2e6, 2.9e6]
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, 160).astype(np.uint8) for _ in centers]

    # build the air: three independently-timed links, upconverted and summed
    n_wide = 120_000
    k = np.arange(n_wide)
    wide = np.zeros(n_wide, np.complex128)
    for i, (fc, p) in enumerate(zip(centers, payloads)):
        iq = sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
            sdr.FramePacket(sdr.FrameMetadata(i, 1), p), 100 + i)
        x = upsample8(iq) / 8.0
        row = np.zeros(n_wide, np.complex128)
        start = 3000 + 9000 * i
        row[start:start + len(x)] = x
        wide += row * np.exp(2j * np.pi * fc * k / fs_wide)
    wide = wide.astype(np.complex64)
    sig = float(np.mean(np.abs(wide) ** 2))
    wide += (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide)
             ).astype(np.complex64) * np.sqrt(sig * 0.002 / 2)

    # find the occupied channels blind — no channel plan needed
    segs = sdr.spectrum_scan(wide, fs_wide, min_bw_hz=200e3)
    found = [s.center_hz for s in segs]
    print("spectrum_scan:", ", ".join(
        f"{s.center_hz/1e6:+.2f} MHz ({s.bw_hz/1e3:.0f} kHz, "
        f"{s.snr_db:.0f} dB)" for s in segs))
    # scan centers ride the preamble's power comb (tens of kHz of skew);
    # the receiver's integer-CFO search + S&C fractional capture absorb it
    order = [int(np.argmin(np.abs(np.array(found) - fc))) for fc in centers]
    rx = sdr.OfdmFrameBandStreamDemod(cfg, table, pre,
                                      [found[i] for i in order], fs_wide)
    got = {}
    for i in range(0, n_wide, 30_000):          # stream in arbitrary chunks
        for c, res in rx.feed(wide[i:i + 30_000]).items():
            got.setdefault(c, []).extend(res)
    for c, res in rx.flush().items():
        got.setdefault(c, []).extend(res)

    failures = 0
    for c, p in enumerate(payloads):
        frames = [r for r in got.get(c, []) if hasattr(r, "packet")]
        if frames and np.array_equal(frames[0].packet.payload, p):
            m = frames[0].packet.metadata
            print(f"channel {c} @ {centers[c]/1e6:+.1f} MHz: seq={m.sequence_num} "
                  f"({len(p)} bytes) decoded intact")
        else:
            print(f"channel {c} @ {centers[c]/1e6:+.1f} MHz: FAILED "
                  f"({got.get(c)})")
            failures += 1
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
