"""FT8: pack a message, modulate, receive many noisy windows in one batch.

Run: python examples/02_ft8_receive.py
"""
import os
import sys

# runnable from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr

FS = 12_000.0


def main():
    ht = sdr.CallsignHashTable()
    rng = np.random.default_rng(0)
    calls = ["KA1ABC", "W9XYZ", "K5GPU"]
    windows = []
    for i, call in enumerate(calls):
        payload = sdr.pack77(sdr.Ft8Standard("CQ", call, "FN42"), ht)
        iq = np.asarray(sdr.ft8_mod(sdr.ft8_encode(payload), FS,
                                    base_hz=1000.0 + i * 25))
        # −12 dB SNR in the 2.5 kHz reference bandwidth
        power = FS / (2500.0 * 10 ** (-12.0 / 10.0))
        iq = iq + ((rng.standard_normal(len(iq)) +
                    1j * rng.standard_normal(len(iq)))
                   * np.sqrt(power / 2)).astype(np.complex64)
        windows.append(iq)

    # one fused device program syncs every window; one BP decodes them all
    results = sdr.ft8_decode_windows(np.stack(windows), FS, 950.0, 1150.0,
                                     hash_table=ht)
    for i, r in enumerate(results):
        if r is None:
            print(f"window {i}: no decode")
        else:
            m = r.message
            print(f"window {i}: {m.call_to} {m.call_de} {m.extra} "
                  f"@ {r.carrier_hz:.1f} Hz (score {r.snr_db:.1f})")


if __name__ == "__main__":
    main()
