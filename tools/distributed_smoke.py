"""2-process `jax.distributed` smoke run.

Proves the multi-process code path EXECUTES: two CPU processes join one
cluster (coordinator + init_distributed), build the host-major process
mesh, and reduce a link metric with a cross-process psum (ber_sharded).

Run as launcher (spawns both workers, checks the reduced metric):
    python tools/distributed_smoke.py
Run as worker (internal):
    python tools/distributed_smoke.py --worker <pid> <nproc> <port>
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PER_PROC = 512  # bits per process shard


def worker(process_id: int, num_processes: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from orion_sdr_tpu.parallel.distributed import (
        init_distributed, make_process_mesh, ber_sharded)

    ok = init_distributed(coordinator=f"localhost:{port}",
                          num_processes=num_processes,
                          process_id=process_id)
    assert ok, "init_distributed must initialize the cluster"
    assert jax.process_count() == num_processes
    mesh = make_process_mesh(shape=(num_processes, 1))

    # deterministic global data; each process owns its host-major slice of
    # the channel axis (jax.device_put under multi-process addresses only
    # local shards — the global array is assembled by the runtime)
    rng = np.random.default_rng(0)
    total = num_processes * N_PER_PROC
    ref = rng.integers(0, 2, (num_processes, total // num_processes)
                       ).astype(np.uint8)
    hat = ref.copy()
    # flip a known pattern: 3 errors in process 0's shard, 5 in process 1's
    flips = {0: 3, 1: 5}
    for p, k in flips.items():
        if p < num_processes:
            hat[p, :k] ^= 1
    ber, errs, n = ber_sharded(ref, hat, mesh)
    expect_errs = sum(k for p, k in flips.items() if p < num_processes)
    assert n == total, (n, total)
    assert errs == expect_errs, (errs, expect_errs)
    print(f"proc {process_id}: psum-reduced ber={ber:.6f} "
          f"errs={errs}/{n} OK", flush=True)


def main() -> int:
    port = int(os.environ.get("ORION_SDR_TPU_SMOKE_PORT", "51423"))
    nproc = 2
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         str(i), str(nproc), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(nproc)]
    outs = []
    rc = 0
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            rc = 1
        outs.append(out)
        rc = rc or p.returncode
    for i, out in enumerate(outs):
        print(f"--- worker {i} ---\n{out}", flush=True)
    if rc == 0 and all("OK" in o for o in outs):
        print("distributed smoke: PASS", flush=True)
        return 0
    print("distributed smoke: FAIL", flush=True)
    return 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(main())
