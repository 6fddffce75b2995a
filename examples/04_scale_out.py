"""Scale-out: shard SDR pipelines over a device mesh.

Demonstrates the three sharding shapes of the framework on a virtual
8-device CPU mesh (the same code runs on a mesh of GPUs):

1. channel-parallel — many independent receivers, no collectives;
2. time-parallel streaming state — one fast PSK31 stream whose AFC/PLL
   recurrence carries across shards (matched-filter matmuls shard, the
   tiny per-symbol products all_gather);
3. psum-reduced link metrics over the mesh.

Run: python examples/04_scale_out.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr
from orion_sdr_tpu.parallel import (
    make_mesh, fm_demod_sharded, psk31_stream_decode_sharded, ber_sharded,
    make_process_mesh, measure_scaling, format_scaling_table,
)
from jax.sharding import Mesh


def main():
    print(f"mesh: {len(jax.devices())} devices "
          f"(process mesh {make_process_mesh().devices.shape})")

    # 1. channel + time parallel FM demod with halo exchange
    mesh = make_mesh(8, shape=(2, 4))        # 2 channel groups × 4 time blocks
    rng = np.random.default_rng(0)
    fs = 48_000.0
    iq = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
          ).astype(np.complex64)
    taps = sdr.dsp.kaiser_lowpass_taps(31, 0.2, 50.0)
    audio = fm_demod_sharded(iq, taps, mesh, fs, 2500.0)
    print(f"1. sharded FM demod: {np.asarray(audio).shape} across 8 devices")

    # 2. time-sharded PSK31 text decode (AFC/PLL state exact across shards)
    text = "sharded psk31 stream decode"
    iq31 = np.asarray(sdr.bpsk31_mod_text(text, 8000.0))
    decoded = psk31_stream_decode_sharded(iq31, mesh, 8000.0)
    print(f"2. time-sharded PSK31 decode: {decoded.strip()!r}")
    assert text in decoded

    # 3. BER reduced across the mesh with one psum
    flat = Mesh(np.array(jax.devices()[:8]), ("ch",))
    ref = rng.integers(0, 2, (8, 4096)).astype(np.uint8)
    hat = ref.copy()
    hat[2, :41] ^= 1
    ber, errs, n = ber_sharded(ref, hat, flat)
    print(f"3. psum BER over the mesh: {errs}/{n} = {ber:.2e}")

    # 4. the scaling-efficiency harness (weak scaling; meaningful speedups
    #    need real chips — virtual devices share this host's core)
    def make_fn(mesh_n):
        from jax.sharding import NamedSharding, PartitionSpec as P
        jf = jax.jit(lambda x: sdr.dsp.fir_apply(x, taps)[0])

        def fn(x):
            return jf(jax.device_put(
                x, NamedSharding(mesh_n, P("ch", None))))
        return fn

    def make_input(nd):
        return (np.random.default_rng(nd).standard_normal(
            (2 * nd, 1 << 14)).astype(np.float32),)

    rows = measure_scaling(make_fn, make_input, device_counts=[1, 2, 4, 8],
                           reps=2)
    print("4. scaling harness:")
    print(format_scaling_table(rows))


if __name__ == "__main__":
    main()
