"""Multi-host machinery: process-aware meshes, psum-reduced link metrics,
and the scaling-efficiency harness (BASELINE north star: samples/s at
1 chip / 1 host / N hosts, ≥80% scaling efficiency).

The reference has NO distributed backend (SURVEY §2) — this is the
subsystem that replaces it. Design: the cards of one host talk over their
own links, hosts over the network; the mesh's LEADING axis is laid out
host-major so sharding a workload's channel axis over it keeps each host's
traffic inside the host and only reductions cross the network.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize `jax.distributed` for a multi-host run. No-op (False) when
    single-process (the common case);
    returns True when the cluster initialized. Call before any jax op."""
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_process_mesh(axis_names=("host", "chip"), shape=None) -> Mesh:
    """Host-major device mesh: axis 0 enumerates processes (hosts), axis 1
    the devices within each process. On a single process this degenerates to
    (1, n_local) — code written against it runs unchanged on many hosts.

    ``shape`` overrides the (host, chip) factorization (e.g. to fold hosts
    and chips into one data axis)."""
    devs = jax.devices()
    n_proc = jax.process_count()
    if shape is None:
        shape = (n_proc, len(devs) // n_proc)
    # jax.devices() sorts by process index first, so this reshape is
    # host-major: mesh[h, c] lives on host h.
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


# ── psum-reduced link metrics ────────────────────────────────────────────────


def ber_sharded(bits_ref, bits_hat, mesh: Mesh):
    """Global bit-error rate over channel-sharded bit tensors: each device
    counts its own errors, one scalar `psum` crosses the mesh. Returns
    (ber, n_errors, n_bits)."""


    def local(r, h):
        errs = jnp.sum((r != h).astype(jnp.float32))
        n = jnp.float32(r.size)
        return (jax.lax.psum(errs, mesh.axis_names),
                jax.lax.psum(n, mesh.axis_names))

    spec = P(mesh.axis_names)
    f = jax.jit(jax.shard_map(local, mesh=mesh,
                              in_specs=(spec, spec),
                              out_specs=(P(), P()), check_vma=False))
    sh = NamedSharding(mesh, spec)
    r = jax.device_put(np.asarray(bits_ref, np.uint8), sh)
    h = jax.device_put(np.asarray(bits_hat, np.uint8), sh)
    errs, n = f(r, h)
    errs, n = float(errs), float(n)
    return (errs / n if n else 0.0), int(errs), int(n)


def power_spectrum_sharded(x, mesh: Mesh, nfft: int = 1024):
    """Mean power spectrum over channel-sharded captures: per-device Welch
    accumulation, one (nfft,) `psum` across the mesh. x: (channels, n)."""

    nd = int(np.prod(mesh.devices.shape))
    x = np.asarray(x)
    ch = x.shape[0]
    assert ch % nd == 0, "channels must split evenly across the mesh"

    def local(re, im):
        z = re + 1j * im
        n_seg = z.shape[-1] // nfft
        segs = z[..., : n_seg * nfft].reshape(z.shape[0], n_seg, nfft)
        spec = jnp.mean(jnp.abs(jnp.fft.fft(segs, axis=-1)) ** 2,
                        axis=(0, 1))
        total = jax.lax.psum(spec * z.shape[0], mesh.axis_names)
        cnt = jax.lax.psum(jnp.float32(z.shape[0]), mesh.axis_names)
        return total / cnt

    spec_in = P(mesh.axis_names, None)
    f = jax.jit(jax.shard_map(local, mesh=mesh,
                              in_specs=(spec_in, spec_in),
                              out_specs=P(), check_vma=False))
    sh = NamedSharding(mesh, spec_in)
    re = jax.device_put(np.ascontiguousarray(x.real, np.float32), sh)
    im = jax.device_put(np.ascontiguousarray(x.imag, np.float32), sh)
    return np.asarray(f(re, im))


# ── scaling-efficiency harness ───────────────────────────────────────────────


def measure_scaling(make_fn: Callable[[Mesh], Callable],
                    make_input: Callable[[int], tuple],
                    device_counts: Sequence[int] | None = None,
                    reps: int = 3):
    """Samples/s at 1/2/…/N devices → scaling-efficiency table.

    ``make_fn(mesh)`` returns a callable over the arrays from
    ``make_input(n_devices)`` (input sized PROPORTIONALLY to the device
    count — weak scaling, the SDR deployment shape: more devices monitor
    more channels). Returns a list of dicts with samples/s and efficiency
    vs the 1-device run; runnable today on the virtual CPU mesh, unchanged
    on a real slice.
    """
    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devs)]
    rows = []
    base_rate = None
    for n in device_counts:
        mesh = Mesh(np.array(devs[:n]), ("ch",))
        fn = make_fn(mesh)
        args = make_input(n)
        n_samples = int(np.asarray(args[0]).size)
        # synchronized warm-up: on an async backend an unsynced first rep
        # can overlap the warm-up dispatch tail and inflate its time
        jax.block_until_ready(fn(*args))
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        rate = n_samples / best
        if base_rate is None:
            base_rate = rate
        rows.append({
            "devices": n,
            "samples_per_s": rate,
            "speedup": rate / base_rate,
            "efficiency": rate / (base_rate * n),
        })
    return rows


def format_scaling_table(rows) -> str:
    lines = ["devices  Msamples/s  speedup  efficiency"]
    for r in rows:
        lines.append(f"{r['devices']:7d}  {r['samples_per_s']/1e6:10.1f}  "
                     f"{r['speedup']:7.2f}  {r['efficiency']*100:9.1f}%")
    return "\n".join(lines)
