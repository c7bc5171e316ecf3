"""The margin of ``tests/test_torch_serving.py::
test_async_overlap_is_measured_not_assumed``: how often one try of its
check (async ``hidden_s`` above 0, ``blocked_s`` under 0.8 of sync's and
``wall_s`` under sync's) misses, for the port's engine and the JAX
package's, on the test's own graph and ``_engine`` (a 5e4 B/s link, 12
requests, warm-up 2).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/measure_overlap_margin.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/measure_overlap_margin.py \\
        --seconds 40 --hog 6

``--hog N`` runs N processes of torch matrix products on 8 intra-op
threads each beside the measurement (six of them load 8 cores as a
parallel test run's workers can).  ``--beside`` runs the multi-rank test
modules (``BESIDE``: 4-rank gloo groups and JAX subprocesses, ``pytest -n
4``, run after run) beside it.  Prints,
for each package, the pairs run, the tries that miss, those with no
overlap at all, the ratio's median and 90th percentile, and the async
run's median time of pulls queued behind earlier transfers on their
link.  It reads the test module's graph and engine helpers from
``tests/``.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import shlex
import signal
import subprocess
import sys
import time

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent.parent / "tests"
sys.path.insert(0, str(TESTS))

HOG = ("import torch\ntorch.set_num_threads(8)\na = torch.randn(512, 512)\n"
       "while True:\n    a = torch.tanh(a @ a)\n")
BESIDE = ("test_torch_dist_moe.py", "test_torch_dist_elastic.py",
          "test_torch_dist.py", "test_torch_dist_tp.py")


def measure(port: bool, seconds: float) -> dict:
    import test_torch_serving as T

    g = T.ctr_like(600, 1200, nnz_per_row=12, clusters=8, locality=0.85,
                   seed=0)
    labels = np.where(np.random.default_rng(0).random(g.num_u) < 0.5,
                      1.0, -1.0).astype(np.float32)
    pkg = T.Pkg.of(port, g)
    ratios, misses, no_overlap, queued = [], 0, 0, []
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        sync_e, _, _ = T._engine(pkg, labels, prefetch=False, bandwidth=5e4)
        async_e, _, _ = T._engine(pkg, labels, prefetch=True, bandwidth=5e4)
        s = sync_e.run(12)
        a = async_e.run(12)
        ratios.append(a["blocked_s"] / s["blocked_s"])
        no_overlap += not a["overlap"]["hidden_s"] > 0
        misses += not (a["overlap"]["hidden_s"] > 0
                       and a["blocked_s"] < 0.8 * s["blocked_s"]
                       and a["wall_s"] < s["wall_s"])
        queued.append(sum(r.queue_s for r in async_e.recorder.records
                          if not r.warmup))
    r = np.asarray(ratios)
    return {"pairs": len(r), "misses": misses, "no_overlap": no_overlap,
            "ratio_median": float(np.median(r)),
            "ratio_p90": float(np.quantile(r, 0.9)),
            "async_queued_ms_median": float(np.median(queued)) * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="seconds of pairs per package")
    ap.add_argument("--beside", action="store_true",
                    help="run the multi-rank test modules beside it")
    ap.add_argument("--hog", type=int, default=0, metavar="N",
                    help="run N processes of 8-thread matrix products "
                    "beside it")
    args = ap.parse_args(argv)
    hogs = [subprocess.Popen([sys.executable, "-c", HOG],
                             start_new_session=True)
            for _ in range(args.hog)]
    load = None
    if args.beside:
        env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
                   JAX_PLATFORMS="cpu")
        run = shlex.join(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "xdist", "-n", "4", "--dist", "loadfile",
             *(f"tests/{m}" for m in BESIDE)])
        # again and again until the measurement ends; a run with a
        # failure ends the loop, and the script says so
        load = subprocess.Popen(
            ["bash", "-c", f"while {run}; do :; done"],
            cwd=TESTS.parent, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, start_new_session=True)
        time.sleep(10)          # the ranks and JAX subprocesses start
    try:
        for port in (True, False):
            got = measure(port, args.seconds)
            print(("port" if port else "jax ") + " " + " ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in got.items()), flush=True)
        if load is not None:    # a load that ended early loaded less
            rc = load.poll()
            print("beside: " + ("running to the end" if rc is None
                                else f"ended early with rc {rc}"), flush=True)
    finally:
        for h in hogs:
            h.kill()
            h.wait()
        if load is not None:      # the workers, ranks and JAX with it
            try:
                os.killpg(load.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            load.wait()


if __name__ == "__main__":
    main()
