"""DVB-T 2K: transport-stream payload → conformant frame → streamed receive
at an unknown sample offset, recovering payload + every TPS parameter.

Run: python examples/03_dvb_t_link.py
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
    link = sdr.DvbTLinkParams(guard="1/16", constellation="qpsk",
                              code_rate="2/3")
    params = sdr.DvbTFrameParams(link, frame_number=0, cell_id=0xBEEF >> 8)
    payload = b"The quick brown fox jumps over the lazy DVB-T multiplex. " * 8

    frame = sdr.DvbTFrameMod(params).modulate(payload)
    iq = np.asarray(frame.iq)

    # unknown offset + 12 dB AWGN channel
    rng = np.random.default_rng(1)
    sig = float(np.mean(np.abs(iq) ** 2))
    # lead-in, the frame, and a trailing symbol of dead air (the streaming
    # receiver keeps one symbol of look-ahead before committing to a frame)
    capture = np.concatenate([np.zeros(40, np.complex64), iq,
                              np.zeros(frame.samples_per_symbol, np.complex64)])
    capture = capture + (rng.standard_normal(len(capture)) +
                         1j * rng.standard_normal(len(capture))
                         ).astype(np.complex64) * np.sqrt(sig / 10 ** 1.2 / 2)

    rx = sdr.DvbTFrameStreamDemod(params, frame.n_symbols, len(payload))
    for chunk in np.array_split(capture, 7):       # arbitrary chunking
        for got in rx.feed(chunk):
            tps = got.tps
            print(f"TPS: frame={tps.frame_number} const={tps.constellation} "
                  f"rate={tps.code_rate_hp} guard={tps.guard} "
                  f"cell_id={tps.cell_id}")
            print("payload ok:", bytes(got.payload) == payload)


if __name__ == "__main__":
    main()
