"""Two-process multi-host smoke test for parallel/mesh.py.

Exercises the multi-process path on one machine:
``pdwt_tpu.parallel.init_distributed`` with an explicit localhost
coordinator, a GLOBAL mesh spanning two processes (4 virtual CPU
devices each), and one sharded denoise step whose ring halo exchange
crosses the process boundary.  Every process asserts its addressable
shards of the distributed result against the same step computed
single-process on the full image.

Run (from the repo root):

    python tools/multihost_smoke.py            # spawns the 2 workers

Exit code 0 + "MULTIHOST SMOKE OK" from both workers = pass.  Wired as
an opt-in test in tests/test_parallel.py (PDWT_TPU_MULTIHOST=1).
"""
import os
import subprocess
import sys


def worker(pid: int, port: int) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    # jax.distributed on the CPU backend: the CPU client must be built
    # with a cross-process collectives implementation (gloo ships in
    # jaxlib) or it silently comes up single-process.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from pdwt_tpu.parallel import init_distributed

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    import numpy as np

    from pdwt_tpu import models
    from pdwt_tpu.parallel import make_mesh

    rng = np.random.default_rng(7)  # same image on both processes
    img = rng.standard_normal((64, 128)).astype(np.float32)

    mesh = make_mesh((2, 4), ("row", "col"))
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("row", "col"))
    gimg = jax.make_array_from_callback(img.shape, sh,
                                        lambda idx: img[idx])
    out, n1 = models.sharded_denoise_step(
        gimg, "db4", 2, 0.1, mesh, row_axis="row", col_axis="col",
        swt=True)

    ref, ref_n1 = models.denoise_step(img, None, "db4", 2, 0.1, swt=True)
    ref = np.asarray(ref)
    worst = 0.0
    for s in out.addressable_shards:
        want = ref[s.index]
        worst = max(worst, float(np.abs(np.asarray(s.data) - want).max()))
    dn1 = abs(float(n1) - float(ref_n1)) / max(1.0, abs(float(ref_n1)))
    print(f"[proc {pid}] max|sharded - single| = {worst:.3e}, "
          f"rel dnorm1 = {dn1:.3e}", flush=True)
    assert worst < 1e-4, worst
    assert dn1 < 1e-5, dn1
    print(f"[proc {pid}] MULTIHOST SMOKE OK", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return 0
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    import re

    # drop any inherited device-count forcing (e.g. the pytest conftest's
    # 8) — the LAST occurrence of the flag wins inside XLA
    inherited = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                       os.environ.get("XLA_FLAGS", ""))
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(inherited
                          + " --xla_force_host_platform_device_count=4"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i),
         str(port)],
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        # a hung worker (wedged coordinator handshake) must not leave
        # orphaned jax.distributed processes spinning
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        print(f"FAILED: worker rcs {rcs}", flush=True)
        return 1
    print("MULTIHOST SMOKE OK (2 processes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
