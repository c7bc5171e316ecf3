#!/usr/bin/env python3
"""Drive the PyTorch port of Parsa on one NVIDIA GPU and hold every CUDA
kernel to its plain PyTorch version.

    python3 chip_smoke.py                 # all phases, one card

Run it from the root of a checkout (it imports ``src/repro_torch``).  It
needs a CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``); it builds the kernels from ``src/`` at first use.
Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel against its plain version on the card, bit for bit, across
   shape sweeps (tolerance: 0, the program is integer);
3. the main path at full size: ``text_like(100_000, 65_536, mean_len=20,
   seed=0)`` through ``partition(..., ParsaConfig(k=16,
   backend="device_scan", refine_backend="device", sweeps=2))`` on cuda,
   with its launch counts, held to the numpy oracles and to the
   host_blocked_oracle backend on the card;
4. cpu against cuda on a reduced graph, both backends, every output equal;
5. each kernel timed at the main path's shapes (CUDA events, median of 21
   samples after warm-up; ``ms`` from launches replayed in a CUDA graph,
   ``eager_ms`` from launches made one by one from Python) beside its bound
   and its plain version, then a window of the scan and the whole refine
   under ``torch.profiler``: device kernels per round and the device's idle
   share.

The last lines are the card, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("build", "kernels", "main", "parity", "times")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor fp32
# rate, the only CUDA-core rate in that sheet; int32 and popcount work is
# counted against it one operation per instruction.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

MAIN_GRAPH = dict(num_docs=100_000, vocab=65_536, mean_len=20, seed=0)
SMALL_GRAPH = dict(num_docs=4_000, vocab=8_192, mean_len=20, seed=1)
K = 16
BLOCK = 256
PROFILE_BLOCKS = 8  # scan blocks in the profiled window

# which TPU kernel each CUDA kernel replaces (repro/ file:line of the
# pallas_call wrapper), and its source in this repository
KERNELS = {
    "parsa_cost": ("src/repro/kernels/parsa_cost/parsa_cost.py:55",
                   "src/repro_torch/kernels/parsa_cost/csrc/parsa_cost.cu"),
    "parsa_select_tile": ("src/repro/kernels/parsa_cost/select.py:327",
                          "src/repro_torch/kernels/parsa_cost/csrc/parsa_select.cu"),
    "parsa_select_reduce": ("src/repro/kernels/parsa_cost/select.py:327",
                            "src/repro_torch/kernels/parsa_cost/csrc/parsa_select.cu"),
    "refine_sweep": ("src/repro/kernels/parsa_cost/select.py:263",
                     "src/repro_torch/kernels/parsa_cost/csrc/refine_sweep.cu"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs
def rand_words(rng, shape, density=None):
    """int32 words: full-range random bits (bit 31 included), or each bit
    set with probability ``density``."""
    import numpy as np

    if density is None:
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.int32)[..., 0]


def sparse_rows(rng, n, num_v, max_len=60):
    from repro_torch.kernels.parsa_cost import pack_bitmask

    return pack_bitmask([rng.choice(num_v, size=int(rng.integers(0, max_len)),
                                    replace=False) for _ in range(n)], num_v)


def consistent_prev(rng, words, frac=0.6):
    """A previous assignment that only ever names a needer."""
    import numpy as np

    k, cw = words.shape
    bits = ((words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32))
            & 1).reshape(k, 32 * cw)
    prev = np.full(32 * cw, -1, np.int32)
    for j in range(32 * cw):
        nz = np.flatnonzero(bits[:, j])
        if nz.size and rng.random() < frac:
            prev[j] = rng.choice(nz)
    return prev


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.parsa_cost import (
        ops, parsa_cost_ref, refine_sweep_ref, select_from_cost,
        select_greedy_from_cost)

    rng = np.random.default_rng(0)
    res = {name: {"cases": 0, "max_abs_err": 0} for name in KERNELS}

    def compare(name, got, want, case):
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {case}: shape/dtype {g.shape} {g.dtype} vs "
                  f"{w.shape} {w.dtype}")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            check(torch.equal(g, w), f"{name} {case}: differs from plain "
                  f"version (max abs err {err})")
        res[name]["cases"] += 1

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for U in (7, 256, 1000):
        for Kc in (3, 16, 64):
            for W in (2, 33, 2048):
                nbr, s = T(rand_words(rng, (U, W))), T(rand_words(rng, (Kc, W)))
                got = ops.parsa_cost(nbr, s)
                compare("parsa_cost", [got], [parsa_cost_ref(nbr, s)],
                        (U, Kc, W))
    torch.cuda.synchronize()

    W = 2048
    num_v = 32 * W
    # B x k sweep, plus the largest k the wrapper takes
    shapes = [(B, k) for B in (256, 1024) for k in (8, 16, 64)]
    for B, k in shapes + [(256, ops.SELECT_MAX_K)]:
        for dense in (False, True):
            nbr = T(rand_words(rng, (B, W)) if dense
                    else sparse_rows(rng, B, num_v))
            s = T(rand_words(rng, (k, W), 0.25))
            retired = T(rng.random(B) < 0.3)
            order = T(rng.permutation(k).astype(np.int32))
            enabled = T(rng.random(k) < 0.8)
            tile = ops.parsa_select_tile(nbr, s)
            compare("parsa_select_tile", [tile],
                    [parsa_cost_ref(nbr, s).T.contiguous()], (B, k, dense))
            plain = tile.clone()
            compare("parsa_select_reduce",
                    ops.parsa_select_reduce(tile, retired),
                    select_from_cost(plain.T, retired), (B, k, "indep"))
            compare("parsa_select_reduce",
                    ops.parsa_select_reduce(tile, retired, order, enabled),
                    select_greedy_from_cost(plain.T, retired, order,
                                            enabled), (B, k, "greedy"))
    # all-identical columns: the worst-case collision cascade
    B, k = 1024, 64
    nbr = T(sparse_rows(rng, B, num_v, max_len=25))
    s = torch.zeros((k, W), dtype=torch.int32, device=dev)
    retired = torch.zeros(B, dtype=torch.bool, device=dev)
    order = torch.arange(k, dtype=torch.int32, device=dev)
    enabled = torch.ones(k, dtype=torch.bool, device=dev)
    u, c = ops.parsa_cost_select(nbr, s, retired, order=order, enabled=enabled)
    compare("parsa_select_reduce", [u, c], select_greedy_from_cost(
        parsa_cost_ref(nbr, s), retired, order, enabled), "cascade")
    check(len(set(u.tolist())) == k and bool((c < 2**30).all()),
          "cascade: picks are not k distinct active rows")
    torch.cuda.synchronize()

    # the main path's chunk width, plus the largest k the wrapper takes
    for k, cw in ((16, 32), (64, 32), (ops.REFINE_MAX_K, 4)):
        for sweep in (1, 2):
            words = rand_words(rng, (k, cw), 0.2)
            words[:, -1] &= 0xFFFF  # some empty parameters
            prev = (np.full(32 * cw, -1, np.int32) if sweep == 1
                    else consistent_prev(rng, words))
            cost = rng.integers(0, 3000, k).astype(np.int32)
            w_t, p_t, c_t = T(words), T(prev), T(cost)
            compare("refine_sweep", ops.refine_sweep_chunk(w_t, p_t, c_t),
                    refine_sweep_ref(w_t, p_t, c_t), (k, cw, sweep))
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------- phase 3
def phase_main(dev) -> dict:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.costs import evaluate, need_matrix
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.partition_v import partition_v
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops, pack_bitmask

    t0 = time.perf_counter()
    g = text_like(**MAIN_GRAPH)
    W = (g.num_v + 31) // 32
    log(f"main graph: |U|={g.num_u} |V|={g.num_v} |E|={g.num_edges} W={W} "
        f"(generated in {time.perf_counter() - t0:.2f} s)")
    cfg = ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                      refine_backend="device", sweeps=2)
    partition(g, cfg, device=dev)  # warm-up: allocator and library loads
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        res = partition(g, cfg, device=dev)
    launches = dict(ops.LAUNCHES)
    log(f"main path dispatches: {dict(counts)}")
    log(f"main path kernel launches per phase: {counts.launches}")
    log("main path timings (s): " + json.dumps(res.timings))
    n_blocks = -(-g.num_u // BLOCK)
    rounds = n_blocks * (1 + -(-(BLOCK - 1) // K))
    n_chunks = -(-W // (cfg.refine_chunk // 32))
    check(launches["parsa_select_tile"] == rounds
          and launches["parsa_select_reduce"] == rounds,
          f"select launches {launches} != {rounds} per stage")
    check(launches["refine_sweep"] == n_chunks * cfg.sweeps,
          f"refine_sweep launches {launches['refine_sweep']} != "
          f"{n_chunks * cfg.sweeps}")
    check(launches["parsa_cost"] == 0, "parsa_cost ran on the scan path")

    sizes = np.bincount(res.parts_u, minlength=K)
    check(int(sizes.max() - sizes.min()) <= 1, f"unbalanced sizes {sizes}")
    need = need_matrix(g, res.parts_u, K)
    check(np.array_equal(res.s_masks, pack_bitmask(need, g.num_v)),
          "s_masks != packed N(U_i) (cold-start invariant)")
    t0 = time.perf_counter()
    want_v = partition_v(g, res.parts_u, K, sweeps=2, need=need)
    check(np.array_equal(res.parts_v, want_v), "parts_v != numpy partition_v")
    mh = evaluate(g, res.parts_u, res.parts_v, K)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"metrics.{f} != numpy evaluate")
    log(f"main path oracles (balance, S_i = N(U_i), partition_v, evaluate) "
        f"agree ({time.perf_counter() - t0:.2f} s); metrics "
        f"{res.metrics.as_dict()}")
    # the parsa_cost kernel's path: the host_blocked_oracle backend, one
    # cost tile per block and one down-date per vertex
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    hbo = partition(g, cfg.replace(backend="host_blocked_oracle"), device=dev)
    hbo_launches = dict(ops.LAUNCHES)
    check(np.array_equal(hbo.parts_u, res.parts_u)
          and np.array_equal(hbo.s_masks, res.s_masks),
          "device_scan != host_blocked_oracle at full size")
    check(hbo_launches["parsa_cost"] == n_blocks + g.num_u,
          f"parsa_cost launches {hbo_launches['parsa_cost']} != "
          f"{n_blocks + g.num_u}")
    log(f"host_blocked_oracle on {dev} agrees at full size "
        f"({time.perf_counter() - t0:.2f} s); launches {hbo_launches}; "
        f"timings (s) {json.dumps(hbo.timings)}")
    launches["parsa_cost"] = hbo_launches["parsa_cost"]
    return {"graph": g, "result": res, "launches": launches,
            "timings": res.timings, "rounds": rounds}


# ---------------------------------------------------------------- phase 4
def phase_parity(dev) -> None:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops

    g = text_like(**SMALL_GRAPH)
    hbo_launches = None
    ref = None
    for backend in ("device_scan", "host_blocked_oracle"):
        cfg = ParsaConfig(k=K, backend=backend, block_size=BLOCK,
                          refine_backend="device", sweeps=2)
        t0 = time.perf_counter()
        rc = partition(g, cfg, device="cpu")
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        rg = partition(g, cfg, device=dev)
        if backend == "host_blocked_oracle":
            hbo_launches = dict(ops.LAUNCHES)
        t2 = time.perf_counter()
        for name in ("parts_u", "s_masks", "parts_v"):
            check(np.array_equal(getattr(rc, name), getattr(rg, name)),
                  f"{backend}: {name} differs between cpu and cuda")
        for f in ("sizes", "footprint", "traffic", "worker_recv",
                  "server_send"):
            check(np.array_equal(getattr(rc.metrics, f),
                                 getattr(rg.metrics, f)),
                  f"{backend}: metrics.{f} differs between cpu and cuda")
        if ref is not None:
            check(np.array_equal(ref.parts_u, rg.parts_u),
                  "host_blocked_oracle != device_scan on the reduced graph")
        ref = rg
        log(f"reduced graph {backend}: cpu == cuda (cpu {t1 - t0:.2f} s, "
            f"cuda {t2 - t1:.2f} s)")
    check(hbo_launches["parsa_cost"] > 0,
          "host_blocked_oracle never launched parsa_cost")


# ---------------------------------------------------------------- phase 5
def time_ms(fn, inner: int, samples: int = 21) -> float:
    """Median per-call time over ``samples`` CUDA-event windows of ``inner``
    calls each, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def time_graph_ms(fn, inner: int, samples: int = 21) -> float:
    """Median per-call device time of ``inner`` calls captured in one CUDA
    graph and replayed: the kernels' own time, without the host's cost of
    each launch, which ``time_ms`` includes once a kernel is shorter than
    that cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, 1, samples) / inner


def profile_window(fn) -> dict:
    """One warm call of ``fn`` timed on the host clock, then one under
    ``torch.profiler``: the device kernels it launched, their summed device
    time, and the device's idle share of the unprofiled wall time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"wall_s": wall, "device_kernels": len(kern)}
    if not kern:
        out["busy_s"] = out["idle_share"] = "not measured"
        return out
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    ours = collections.defaultdict(list)
    for e in kern:
        for name in ("cost_tile_kernel", "select_reduce_kernel",
                     "refine_sweep_kernel"):
            if name in e.name:
                ours[name].append(e.time_range.elapsed_us())
    out.update(busy_s=busy, idle_share=1 - busy / wall,
               port_kernels_mean_us={n: statistics.mean(v)
                                     for n, v in ours.items()},
               top=collections.Counter(e.name[:60] for e in kern)
               .most_common(8))
    return out


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / CORE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_times(dev, main: dict) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core.partition import (
        _partition_scan, _rebuild_nbr, pack_graph_blocks)
    from repro_torch.core.refine import refine_v_device
    from repro_torch.kernels.parsa_cost import (
        ops, parsa_cost_ref, popcount32, refine_sweep_ref,
        select_greedy_from_cost)

    g, res = main["graph"], main["result"]
    order = np.random.default_rng(0).permutation(g.num_u)
    packed = pack_graph_blocks(g, BLOCK, order=order)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # block 0 of the main run against the final sets: the select's shapes
    nbr = _rebuild_nbr(T(packed.widx[0]), T(packed.vals[0]),
                       T(packed.tr_ids[0]), T(packed.tr_masks[0]))[:BLOCK]
    s = T(res.s_masks)
    B, W = nbr.shape
    retired = T(np.random.default_rng(1).random(B) < 0.5)
    order_k = torch.arange(K, dtype=torch.int32, device=dev)
    enabled = torch.ones(K, dtype=torch.bool, device=dev)
    tile = ops.parsa_select_tile(nbr, s)
    # refine: the first chunk of the main run's need words, second sweep
    cw = 32
    words = s[:, :cw].contiguous()
    prev = T(res.parts_v[: 32 * cw].astype(np.int32))
    cost = popcount32(s).sum(dim=1, dtype=torch.int32)

    nz_words = int((nbr != 0).sum())
    nz_cols = int((nbr != 0).any(0).sum())
    tile_bytes = 4 * (B * W + K * nz_cols + K * B)
    tile_ops = 3 * nz_words * K
    rows = []
    specs = [
        ("parsa_cost", lambda: ops.parsa_cost(nbr, s),
         lambda: parsa_cost_ref(nbr, s), 100, 5, tile_bytes, tile_ops),
        ("parsa_select_tile", lambda: ops.parsa_select_tile(nbr, s),
         lambda: parsa_cost_ref(nbr, s).T.contiguous(), 100, 5,
         tile_bytes, tile_ops),
        ("parsa_select_reduce",
         lambda: ops.parsa_select_reduce(tile, retired, order_k, enabled),
         lambda: select_greedy_from_cost(tile.T, retired, order_k, enabled),
         100, 2, 4 * K * B + B + 4 * K + K + 8 * K, 2 * K * B),
        ("refine_sweep", lambda: ops.refine_sweep_chunk(words, prev, cost),
         lambda: refine_sweep_ref(words, prev, cost), 20, 1,
         4 * (K * cw + 2 * 32 * cw + 2 * K), 6 * 32 * cw * K),
    ]
    launches = main["launches"]
    for name, kern, plain, inner, plain_inner, nbytes, nops in specs:
        saved = dict(ops.LAUNCHES)
        ms = time_graph_ms(kern, inner)
        eager_ms = time_ms(kern, inner)
        plain_ms = time_ms(plain, plain_inner)
        ops.LAUNCHES.update(saved)  # timing launches are not path launches
        b_ms, b_by = bound_ms(nbytes, nops)
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][1],
            "replaces": KERNELS[name][0],
            "launches": launches[name],
            "launches_path": ("host_blocked_oracle" if name == "parsa_cost"
                              else "device_scan") + ", main graph",
            "max_abs_err": main["checks"][name]["max_abs_err"],
            "cases": main["checks"][name]["cases"],
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        log(f"time {name}: {ms * 1e3:.2f} us in a CUDA graph, "
            f"{eager_ms * 1e3:.2f} us per eager launch (plain "
            f"{plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.3f} us by {b_by}); "
            f"no single PyTorch call computes it, so library_ms is null")
    per_round = rows[1]["ms"] + rows[2]["ms"]
    busy = (main["rounds"] * per_round
            + launches["refine_sweep"] * rows[3]["ms"]) / 1e3
    wall = main["timings"]["partition_u"] + main["timings"]["partition_v"]
    log(f"kernel time on the main path ~ {busy:.4f} s of {wall:.4f} s "
        f"scan+refine wall ({100 * busy / wall:.1f}%)")

    # where the time goes: the first PROFILE_BLOCKS blocks of the scan and
    # the whole refine, each under torch.profiler
    nb = PROFILE_BLOCKS
    blocks = [T(x[:nb]) for x in (packed.widx, packed.vals, packed.tr_ids,
                                  packed.tr_masks, packed.valid)]

    def scan():
        _partition_scan(*blocks, torch.zeros((K, W), dtype=torch.int32,
                                             device=dev),
                        torch.zeros(K, dtype=torch.int32, device=dev))

    parts_u = T(res.parts_u)
    saved = dict(ops.LAUNCHES)
    for name, fn, steps in (
            ("scan", scan, nb * (1 + -(-(BLOCK - 1) // K))),
            ("refine", lambda: refine_v_device(g, parts_u, K, sweeps=2,
                                               need_words=s),
             launches["refine_sweep"])):
        prof = profile_window(fn)
        if isinstance(prof["busy_s"], float):
            prof["device_kernels_per_step"] = prof["device_kernels"] / steps
        log(f"profile {name} ({steps} rounds or chunk sweeps): "
            + json.dumps(prof))
    ops.LAUNCHES.update(saved)
    return rows


# ---------------------------------------------------------------- entry point
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch.kernels.parsa_cost import build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{sorted(p.name for p in libs.values())}")
    state: dict = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        state["checks"] = phase_kernels(dev)
        log("kernel checks: " + json.dumps(state["checks"]) +
            f" ({time.perf_counter() - t0:.2f} s)")
    if "main" in phases:
        t0 = time.perf_counter()
        state.update(phase_main(dev))
        log(f"main phase {time.perf_counter() - t0:.2f} s")
    if "parity" in phases:
        t0 = time.perf_counter()
        phase_parity(dev)
        log(f"parity phase {time.perf_counter() - t0:.2f} s")
    if "times" in phases:
        rows = phase_times(dev, state)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
    if phases != set(PHASES):
        log(f"ran phases {sorted(phases)} only; no result")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
