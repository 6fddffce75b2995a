"""Robust COFDM link through an impaired channel.

Drives the streaming frame receiver through the channel simulator's
multipath + oscillator phase noise + AWGN, with the three beyond-reference
RX stages on: delay-domain training-estimate denoising (always on), CSI
LLR weighting (always on when an estimate exists), and per-symbol
common-phase-error tracking (`with_phase_tracking("cpe")`).

Run: python examples/07_robust_cofdm_link.py
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
    fs = 1e6
    plan = sdr.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = sdr.OfdmConfig(plan, fs=fs).with_phase_tracking("cpe")
    pre = sdr.OfdmPreamble(repeat_len=128, num_repeats=4
                           ).with_training_symbol(256, 64)
    table = sdr.McsTable.default_ladder()

    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 400).astype(np.uint8)
    packet = sdr.FramePacket(sdr.FrameMetadata(sequence_num=1, mcs_index=1),
                             payload)
    iq = np.asarray(sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
        packet, 0x1234))

    # channel: unknown start + in-guard 2-ray multipath + 12 Hz-linewidth
    # oscillator + 8 dB AWGN
    buf = np.concatenate([np.zeros(5000, np.complex64), iq,
                          np.zeros(2000, np.complex64)])
    buf = sdr.multipath_apply(buf, [0, 24], [1.0, 0.45 * np.exp(0.9j)])
    buf = sdr.phase_noise_apply(rng, buf, 12.0, fs)
    body = iq[pre.total_len():]
    sig = float(np.mean(np.abs(body) ** 2))
    snr_db = 8.0
    sigma = np.sqrt(sig / (2 * 10 ** (snr_db / 10)))
    buf = buf + (rng.standard_normal(len(buf)) +
                 1j * rng.standard_normal(len(buf))
                 ).astype(np.complex64) * sigma

    rx = sdr.OfdmFrameStreamDemod(cfg, table, pre)
    results = []
    for i in range(0, len(buf), 20000):        # stream in arbitrary chunks
        results += rx.feed(buf[i:i + 20000])
    results += rx.flush()

    from orion_sdr_tpu.frame import RxFrame
    frames = [r for r in results if isinstance(r, RxFrame)]
    print(f"channel: 2-ray multipath, 12 Hz phase noise, {snr_db:.0f} dB SNR")
    if not frames:
        print("no frame decoded:", results)
        return 1
    f = frames[0]
    print(f"decoded frame seq={f.packet.metadata.sequence_num} "
          f"mcs={f.packet.metadata.mcs_index} "
          f"({len(f.packet.payload)} bytes), "
          f"payload intact: {np.array_equal(f.packet.payload, payload)}")
    print(f"estimated CFO {f.diagnostics.cfo_hz:+.2f} Hz, "
          f"timing offset {f.diagnostics.timing_offset_samples} samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
