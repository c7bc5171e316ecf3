"""Time the port's 32-slot closed serving loop of ``tests/test_torch_obs.py``
(obs off) in several processes at once, as the test suite's workers run it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/measure_thread_collapse.py \\
        --procs 6 --runs 2

Each process builds the loop's graph and stack, runs one untimed warm-up
loop, then times ``--runs`` loops on the host clock and prints them; all
start together.  ``--procs 1`` gives the time alone.  A measurement of the
CPU plain route, not of a device.
"""
import argparse
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def child(runs: int) -> None:
    sys.path.insert(0, str(HERE))
    import numpy as np
    from repro.graphs import ctr_like
    from test_torch_obs import _closed_loop_run
    from test_torch_serving import Pkg

    g = ctr_like(600, 1200, nnz_per_row=12, clusters=8, locality=0.85,
                 seed=0)
    labels = np.where(np.random.default_rng(0).random(g.num_u) < 0.5,
                      1.0, -1.0).astype(np.float32)
    port = Pkg.of(True, g)
    _closed_loop_run(port, labels, obs=None, n_slots=32)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _closed_loop_run(port, labels, obs=None, n_slots=32)
        times.append(time.perf_counter() - t0)
    print(" ".join(f"{t:.3f}" for t in times), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.runs)
        return
    cmd = [sys.executable, __file__, "--child", "--runs", str(args.runs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
             for _ in range(args.procs)]
    for i, p in enumerate(procs):
        out, _ = p.communicate()
        print(f"process {i}: seconds a run {out.strip()}")


if __name__ == "__main__":
    main()
