"""Process groups for the port's tests: a launcher that starts one process
a rank with ``spawn`` (a ``file://`` store, a deadline, one intra-op
thread a rank), the program each rank of ``tests/test_torch_dist.py``
runs, and the shared helper that runs a JAX script on forced host
devices in a subprocess.  pytest does not collect this module; a spawned
rank imports it by name, so it imports neither ``jax`` nor ``repro``."""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60

# ---------------------------------------------------------- the cases
TEXT = ("text", dict(num_docs=1200, vocab=2000, mean_len=15, seed=4))
BASE = dict(block_size=64, refine_backend="device", sweeps=2, seed=0,
            workers=4)
SKETCH_KW = dict(set_repr="sketch", sketch_hot_bits=1024,
                 sketch_bucket_bits=512)
# name -> (graph, config kwargs), each run by 4 ranks and by JAX
# parallel_device at 4 workers
FACADE = {
    "text_m1": (TEXT, dict(BASE, k=8, merge_every=1)),
    "text_m3": (TEXT, dict(BASE, k=8, merge_every=3)),
    # k does not divide |U|; 16 real blocks padded to 24 (6 a worker)
    "k3_pad": (("text", dict(num_docs=997, vocab=1500, mean_len=12, seed=0)),
               dict(BASE, k=3, merge_every=3)),
    "ctr_m1": (("ctr", dict(num_impressions=800, num_features=4000,
                            nnz_per_row=15, seed=2)),
               dict(BASE, k=8, merge_every=1, block_size=128)),
    "ginit_m3": (TEXT, dict(BASE, k=8, merge_every=3,
                            global_init_frac=0.05)),
}
SKETCH = (("ctr", dict(num_impressions=800, num_features=4000,
                       nnz_per_row=15, seed=2)),
          dict(BASE, k=8, merge_every=1, block_size=128, **SKETCH_KW))
STREAM_GRAPH = ("text", dict(num_docs=900, vocab=1800, mean_len=14, seed=6))
STREAM_BASE = dict(k=8, backend="parallel_device", workers=4, merge_every=2,
                   block_size=64, seed=3)
STREAM_CUTS = (0, 500, 900)
STREAM_WEIGHTS = (None, (1.0, 2.0, 0.5, 3.0))
MESHES = ("2,2", "1,2,2")
METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
TRAFFIC_FIELDS = ("pushed_bytes", "pulled_bytes", "tasks",
                  "stale_pushes_missed", "migration_bytes")


def make_graph(spec):
    from repro_torch.graphs import ctr_like, text_like

    kind, kw = spec
    return (text_like if kind == "text" else ctr_like)(**kw)


def result_arrays(res, prefix: str) -> dict:
    """A ``PartitionResult``'s compared fields as ``prefix/...`` arrays."""
    out = {f"{prefix}/{f}": getattr(res, f)
           for f in ("parts_u", "s_masks", "parts_v")}
    for f in METRIC_FIELDS:
        out[f"{prefix}/m_{f}"] = getattr(res.metrics, f)
    if res.traffic is not None:
        for f in TRAFFIC_FIELDS:
            out[f"{prefix}/t_{f}"] = np.int64(getattr(res.traffic, f))
    return out


def stream_config(**over):
    from repro_torch.api import ParsaConfig
    from repro_torch.stream import ParsaStreamConfig

    return ParsaStreamConfig(base=ParsaConfig(**dict(STREAM_BASE, **over)),
                             repartition="never")


def stream_run(group=None) -> dict:
    """Two shuffled parallel feeds (the second weighted) and an explicit
    ``repartition()`` of one ``StreamSession`` on the CPU: the updates,
    the live state and the repair's plan as arrays."""
    from repro_torch.stream import StreamSession

    g = make_graph(STREAM_GRAPH)
    sess = StreamSession(stream_config(), g.num_v, device="cpu", group=group)
    out = {}
    for i, (lo, hi) in enumerate(zip(STREAM_CUTS, STREAM_CUTS[1:])):
        w = STREAM_WEIGHTS[i]
        upd = sess.feed(g.slice_u(lo, hi),
                        worker_weights=None if w is None else np.asarray(w))
        out[f"feed{i}/parts"] = upd.parts
        out[f"feed{i}/sizes"] = upd.metrics.sizes
        out[f"feed{i}/footprint"] = upd.metrics.footprint
        out[f"feed{i}/traffic"] = np.asarray(
            [getattr(upd.traffic, f) for f in TRAFFIC_FIELDS], np.int64)
        out[f"feed{i}/dispatches"] = np.asarray(
            sorted(f"{k}={v}" for k, v in upd.dispatches.items()))
        out[f"feed{i}/s_masks"] = sess.arena.masks_np()
        out[f"feed{i}/live_sizes"] = sess.arena.sizes.numpy()
    plan = sess.repartition()
    out["repair/parts_u"] = plan.parts_u
    out["repair/s_masks"] = plan.s_masks
    out["repair/assign"] = plan.assign
    out["repair/moved_u"] = np.int64(plan.moved_u)
    out["repair/traffic"] = np.asarray(
        [getattr(sess.traffic, f) for f in TRAFFIC_FIELDS], np.int64)
    out["repair/live_parts"] = sess.parts.copy()
    return out


def _raises(fn, exc=ValueError) -> str:
    """The message of the ``exc`` that ``fn()`` raises ('' if none)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


# ---------------------------------------------------------- a rank's program
def dist_cases(rank: int, world: int, group) -> dict:
    """Every case of ``tests/test_torch_dist.py`` on this rank of a 4-rank
    gloo group; returns the arrays the test compares."""
    import torch.distributed as dist

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core import partition as tp
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.launch import mesh as M
    from repro_torch.stream import StreamSession

    out = {}
    for name, (gspec, ckw) in FACADE.items():
        g = make_graph(gspec)
        with dispatch_counter() as counts:
            res = partition(g, ParsaConfig(backend="parallel_device", **ckw),
                            device="cpu", group=group)
        out.update(result_arrays(res, name))
        out[f"{name}/gather_bytes"] = np.int64(
            counts.bytes_by_phase().get("parallel_merge_gather", -1))
        out[f"{name}/gather_dispatches"] = np.int64(
            counts.get("parallel_merge_gather", 0))
        out[f"{name}/scan_dispatches"] = np.int64(
            counts.get("parallel_partition_scan", 0))

    gspec, ckw = SKETCH
    res = partition(make_graph(gspec),
                    ParsaConfig(backend="parallel_device", **ckw),
                    device="cpu", group=group)
    out.update(result_arrays(res, "sketch"))

    out.update({f"stream/{k}": v for k, v in stream_run(group).items()})

    # world size 1: one group a rank, against device_scan
    solo = [dist.new_group([r], backend="gloo",
                           timeout=datetime.timedelta(
                               seconds=GROUP_TIMEOUT_S))
            for r in range(world)]
    g = make_graph(TEXT)
    one = ParsaConfig(k=8, backend="parallel_device", workers=1,
                      merge_every=3, block_size=64, refine_backend="device",
                      sweeps=2)
    out.update(result_arrays(
        partition(g, one, device="cpu", group=solo[rank]), "w1"))
    out.update(result_arrays(partition(
        g, one.replace(backend="device_scan"), device="cpu"), "w1_scan"))

    # refusals: the size check runs before any packing
    def no_pack(*a, **kw):
        raise AssertionError("packed before the group size was checked")

    packer = tp.pack_graph_blocks
    tp.pack_graph_blocks = no_pack
    try:
        out["err/size_partition"] = np.asarray(_raises(lambda: partition(
            g, ParsaConfig(backend="parallel_device",
                           **dict(FACADE["text_m1"][1], workers=2)),
            device="cpu", group=group)))
        out["err/size_impl"] = np.asarray(_raises(
            lambda: tp.parallel_blocked_partition_u_impl(
                g, 8, workers=8, device="cpu", group=group)))
        out["err/size_stream"] = np.asarray(_raises(
            lambda: StreamSession(stream_config(workers=2), g.num_v,
                                  device="cpu", group=group)))
    finally:
        tp.pack_graph_blocks = packer
    out["err/backend"] = np.asarray(_raises(lambda: partition(
        g, ParsaConfig(k=8, workers=4), device="cpu", group=group)))
    out["err/backend_stream"] = np.asarray(_raises(
        lambda: StreamSession(stream_config(backend="device_scan"), g.num_v,
                              device="cpu", group=group)))
    # each rank draws its own permutation: every rank must refuse
    import torch

    packed = tp.pack_graph_blocks(g, 64)
    W = (g.num_v + 31) // 32
    out["err/perm"] = np.asarray(_raises(lambda: tp._run_parallel_packed_scan(
        packed, torch.zeros((8, W), dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), k=8, workers=world,
        merge_every=2, shuffle_rng=np.random.default_rng(rank),
        group=group)))

    # the production meshes at test scale
    for spec in MESHES:
        os.environ["REPRO_MESH"] = spec
        try:
            m = M.make_production_mesh(device_type="cpu")
        finally:
            del os.environ["REPRO_MESH"]
        out[f"mesh{spec}/names"] = np.asarray(m.mesh_dim_names)
        out[f"mesh{spec}/shape"] = np.asarray(
            [m.size(i) for i in range(m.ndim)])
        out[f"mesh{spec}/name"] = np.asarray(M.mesh_name(m))
        out[f"mesh{spec}/dp_axes"] = np.asarray(M.dp_axes(m), dtype=str)
        out[f"mesh{spec}/tp_axis"] = np.asarray(M.tp_axis(m))
        out[f"mesh{spec}/dp_size"] = np.int64(M.dp_size(m))
    return out


def nccl_one(rank: int, world: int, group) -> dict:
    """A group of one NCCL rank on the card: ``parallel_device`` at one
    worker through the group, without it, and ``device_scan``."""
    import torch

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.dispatch import dispatch_counter

    g = make_graph(TEXT)
    cfg = ParsaConfig(backend="parallel_device",
                      **dict(FACADE["text_m3"][1], workers=1))
    dev = torch.device("cuda", torch.cuda.current_device())
    with dispatch_counter() as counts:
        out = result_arrays(partition(g, cfg, device=dev, group=group),
                            "nccl")
    out["gather_dispatches"] = np.int64(
        counts.get("parallel_merge_gather", 0))
    out.update(result_arrays(partition(g, cfg, device=dev), "ungrouped"))
    out.update(result_arrays(partition(
        g, cfg.replace(backend="device_scan"), device=dev), "scan"))
    return out


# ---------------------------------------------------------- the launcher
def _rank_entry(fn, rank: int, world: int, backend: str, store: str,
                out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)   # four ranks beside the xdist workers
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda",
                                       rank % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S), **kw)
    try:
        out = fn(rank, world, dist.group.WORLD)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def run_ranks(fn, world: int, out_dir: pathlib.Path, backend: str = "gloo",
              deadline_s: float = 300.0) -> list[dict]:
    """Start ``world`` processes (``spawn``), rank r calling ``fn(r, world,
    group)`` in a group over a ``file://`` store under ``out_dir``; wait
    until ``deadline_s``, kill every rank still running, and raise
    unless every rank exited 0.  Returns each rank's arrays, by rank."""
    ctx = multiprocessing.get_context("spawn")
    out_dir.mkdir(parents=True, exist_ok=True)
    store = f"file://{out_dir / 'store'}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, backend, store, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise RuntimeError(f"ranks {hung} still ran after {deadline_s} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------- JAX on host devices
def start_jax(script: str, arg: str, devices: int = 8) -> subprocess.Popen:
    """Start ``python -c script arg`` with ``devices`` forced JAX host
    devices (the count is fixed when JAX starts, hence a subprocess)."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_MESH", None)
    return subprocess.Popen([sys.executable, "-c", script, arg], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_jax(proc: subprocess.Popen, marker: str,
               timeout: float = 900) -> None:
    """Wait for ``start_jax``'s process; fail unless it printed
    ``marker``."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert marker in stdout, stdout + stderr


def run_jax(script: str, arg: str, marker: str, devices: int = 8,
            timeout: float = 900) -> None:
    finish_jax(start_jax(script, arg, devices), marker, timeout)
