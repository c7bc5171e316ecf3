"""Checkpoints of a train state over a (data x model) mesh: the cases of
``tests/test_torch_dist_ckpt.py``, the rank program (``ckpt_cases``,
started by ``torch_dist_ranks.run_ranks``) and the JAX script it runs in
one subprocess on 4 forced host devices.  pytest does not collect this
module; a spawned rank imports it by name, so it imports neither ``jax``
nor ``repro`` at the top."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import pickle
import time

import numpy as np

WORLD = 4
MESH_AXES = ("data", "model")
B, S = 4, 8
STEPS = 4              # the uninterrupted run
EVERY, FAIL_AT = 2, 3  # the interrupted run: saves at 2, fails at 3
REMESH = ((1, 4), (4, 1))
JAX_STEPS = 2          # JAX's TrainLoop saves at 2, then takes step 3
JAX_READY = "jax_ckpt_ready"
JAX_DEADLINE_S = 300

# name -> the reduced config's arch and overrides; every case saves over
# (2, 2)
CASES = {
    "qwen": dict(arch="qwen3-14b", over={}),
    # FSDP: every dim the spec names "data" cut over data
    "cmdr_fsdp": dict(arch="command-r-35b", over={"fsdp": True}),
    # one group of 3 mLSTM blocks and an sLSTM
    "xlstm": dict(arch="xlstm-350m", over={"num_layers": 4}),
}
JAX_CASE = "qwen"

JAX_SCRIPT = r"""
import json, pathlib, pickle, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.launch.sharding import opt_pspecs, param_pspecs, to_named
from repro.launch.steps import make_train_step
from repro.optim import init_opt_state
from repro.runtime import FaultConfig, TrainLoop

case, steps, data_path, ckpt_dir, ready, out_path = json.loads(sys.argv[1])
batches = [{k: jnp.asarray(v) for k, v in b.items()}
           for b in pickle.load(open(data_path, "rb"))[case["arch"]]]
cfg = get_config(case["arch"]).reduced(**case["over"])
# Auto axes, as GSPMD partitions
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                         ("data", "model"))
_, step, init, opt_cfg = make_train_step(cfg, mesh)
jstep = jax.jit(step)


def init_fn():
    p, _ = init(jax.random.PRNGKey(0))
    return p, init_opt_state(p, opt_cfg)


shapes = jax.eval_shape(init_fn)
shard = to_named({"params": param_pspecs(cfg, shapes[0], mesh),
                  "opt": opt_pspecs(cfg, shapes[0], mesh)}, mesh)
p, o = init_fn()
p = jax.device_put(p, shard["params"])
o = jax.device_put(o, shard["opt"])
fault = FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=steps)
loop = TrainLoop(jstep, fault, shardings=shard)
loop.run(p, o, batches[:steps])
pathlib.Path(ready).write_text("done")
start, p, o = TrainLoop(jstep, fault, shardings=shard).resume_or(init_fn)
assert start == steps, start
p, o, m = jstep(p, o, batches[steps])
out = {k: float(np.asarray(v, np.float32)) for k, v in m.items()}
out["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
pickle.dump(out, open(out_path, "wb"))
print("JAX_DIST_CKPT_DONE")
"""


def cfg_of(name):
    from repro_torch.configs import get_config

    c = CASES[name]
    return get_config(c["arch"]).reduced(**c["over"])


def microbatches(name: str, shape) -> int:
    """The microbatches a train step over a mesh of ``shape`` takes."""
    import types

    from repro_torch.launch.steps import _effective_microbatches

    mesh = types.SimpleNamespace(shape=dict(zip(MESH_AXES, shape)),
                                 axis_names=MESH_AXES)
    return _effective_microbatches(cfg_of(name), mesh, B)


def coords_of(shape, rank: int) -> dict:
    return {"data": rank // shape[1], "model": rank % shape[1]}


def make_batches() -> dict:
    """Seeded global batches (B = 4, S = 8) for every arch, one more than
    the longest run takes; the last labels' first positions ignored."""
    rng = np.random.default_rng(41)
    out = {}
    for name in CASES:
        cfg = cfg_of(name)
        bs = []
        for _ in range(STEPS + 1):
            b = {k: rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
                 for k in ("tokens", "labels")}
            b["labels"][0, :2] = -1
            bs.append(b)
        out[CASES[name]["arch"]] = bs
    return out


def start(tmp: pathlib.Path):
    """Write the batches, start JAX's ``TrainLoop`` on 4 forced host
    devices, run the ranks (which restore JAX's checkpoint once it is
    published); returns (JAX's arrays, each rank's arrays, the
    directory of the checkpoints)."""
    import functools

    import torch_dist_ranks as R

    data_path = tmp / "batches.pkl"
    with open(data_path, "wb") as f:
        pickle.dump(make_batches(), f)
    jax_dir = tmp / "jax_ckpt"
    proc = R.start_jax(JAX_SCRIPT, json.dumps(
        [CASES[JAX_CASE], JAX_STEPS, str(data_path), str(jax_dir),
         str(tmp / JAX_READY), str(tmp / "jax.pkl")]), devices=WORLD)
    try:
        ranks = R.run_ranks(functools.partial(
            ckpt_cases, root=str(tmp), data_path=str(data_path)),
            WORLD, tmp / "ranks")
    finally:
        R.finish_jax(proc, "JAX_DIST_CKPT_DONE")
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f), ranks, tmp


# ------------------------------------------------------------ a rank
def _device_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=MESH_AXES)


def _flat(out: dict, prefix: str, tree) -> None:
    from repro_torch.tree import tree_leaves_with_path

    for path, leaf in tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(map(str, path))] = \
            leaf.detach().numpy().copy()


def _state(cfg, seed: int) -> dict:
    """The whole training state from ``seed`` (no mesh)."""
    from repro_torch.launch.steps import make_train_step

    _, _, init, _ = make_train_step(cfg, "cpu")
    p, o = init(seed)
    return {"params": p, "opt": o}


def _blocks(cfg, state, mesh):
    """The place's blocks of a whole state (copies: the steps update the
    blocks in place)."""
    from repro_torch.launch.sharding import shard_tree, state_specs
    from repro_torch.tree import tree_map

    blocks = shard_tree(state, state_specs(cfg, mesh), mesh)
    return tree_map(lambda t: t.clone(), blocks)


def run_case(name: str, rank: int, root: pathlib.Path, batches) -> dict:
    """One case on this rank (see ``tests/test_torch_dist_ckpt.py``)."""
    import torch.distributed as dist

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.launch.sharding import state_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.runtime import FaultConfig, SimulatedFailure, TrainLoop

    cfg = cfg_of(name)
    d = root / name
    mesh = _device_mesh((2, 2))
    specs = state_specs(cfg, mesh)
    _, step, _, _ = make_train_step(cfg, "cpu", mesh=mesh)
    whole = _state(cfg, 0)
    out = {}

    # the step-0 state saved over the mesh, and whole on rank 0
    save_checkpoint(d / "mesh0", 0, _blocks(cfg, whole, mesh), mesh=mesh,
                    specs=specs)
    if rank == 0:
        save_checkpoint(d / "whole0", 0, whole)

    # the uninterrupted run
    st = _blocks(cfg, whole, mesh)
    p, o = st["params"], st["opt"]
    for b in batches[:STEPS]:
        p, o, _ = step(p, o, b)
    _flat(out, "uninterrupted", {"params": p, "opt": o})

    # failure at step FAIL_AT, checkpoints every EVERY; the resume
    # restores into blocks of another seed's state, in place
    st = _blocks(cfg, whole, mesh)
    loop = TrainLoop(step, FaultConfig(ckpt_dir=str(d / "loop"),
                                       ckpt_every=EVERY,
                                       fail_at_step=FAIL_AT),
                     mesh=mesh, specs=specs)
    raised = False
    try:
        loop.run(st["params"], st["opt"], batches[:STEPS])
    except SimulatedFailure:
        raised = True
    out["raised"] = np.bool_(raised)
    out["timings"] = np.asarray(json.dumps(loop.mgr.timings))
    other = _state(cfg, 1)
    loop2 = TrainLoop(step, FaultConfig(ckpt_dir=str(d / "loop"),
                                        ckpt_every=EVERY),
                      mesh=mesh, specs=specs)
    built = []

    def init_fn():
        built.append(_blocks(cfg, other, mesh))
        return built[-1]["params"], built[-1]["opt"]

    start_, p, o = loop2.resume_or(init_fn)
    out["start"] = np.int64(start_)
    out["in_place"] = np.bool_(p is built[0]["params"]
                              and o is built[0]["opt"])
    p, o, _ = loop2.run(p, o, batches[start_:STEPS], start_step=start_)
    _flat(out, "resumed", {"params": p, "opt": o})

    # the step-EVERY checkpoint on other meshes, and with none: the
    # blocks restored, then the next step
    for shape in REMESH:
        m = _device_mesh(shape)
        sp = state_specs(cfg, m)
        st = _blocks(cfg, other, m)
        t0 = time.perf_counter()
        st = restore_checkpoint(d / "loop", EVERY, st, mesh=m, specs=sp,
                                inplace=True)
        tag = "x".join(map(str, shape))
        out[f"restore_s/{tag}"] = np.float64(time.perf_counter() - t0)
        _flat(out, f"restored/{tag}", st)
        _, step_m, _, _ = make_train_step(cfg, "cpu", mesh=m)
        p, o, met = step_m(st["params"], st["opt"], batches[EVERY])
        out[f"next/{tag}/loss"] = met["loss"].numpy()
        out[f"next/{tag}/grad_norm"] = met["grad_norm"].numpy()
        _flat(out, f"next/{tag}", {"params": p})
    if rank == 0:
        st = restore_checkpoint(d / "loop", EVERY, _state(cfg, 1))
        _flat(out, "restored/none", st)
        # the no-mesh route at each mesh's microbatch count (a mesh whose
        # batch axes do not divide cfg.microbatches' slices takes fewer,
        # as the reference does: another mean over the labelled tokens)
        for n in sorted({microbatches(name, s) for s in REMESH}):
            st = restore_checkpoint(d / "loop", EVERY, _state(cfg, 1))
            _, step0, _, _ = make_train_step(
                dataclasses.replace(cfg, microbatches=n), "cpu")
            p, o, met = step0(st["params"], st["opt"], batches[EVERY])
            out[f"next/none{n}/loss"] = met["loss"].numpy()
            out[f"next/none{n}/grad_norm"] = met["grad_norm"].numpy()
            _flat(out, f"next/none{n}", {"params": p})
    dist.barrier()
    return out


def jax_case(rank: int, root: pathlib.Path, batches) -> dict:
    """JAX's checkpoint (its ``TrainLoop`` over its (2, 2) mesh) restored
    into this rank's (2, 2) blocks through
    ``convert.train_state_from_jax_checkpoint``, then the next step."""
    from repro_torch.convert import train_state_from_jax_checkpoint

    from repro_torch.launch.steps import make_train_step

    end = time.monotonic() + JAX_DEADLINE_S
    while not (root / JAX_READY).exists():
        if time.monotonic() > end:
            raise RuntimeError("JAX's checkpoint never came")
        time.sleep(0.2)
    cfg = cfg_of(JAX_CASE)
    mesh = _device_mesh((2, 2))
    step_no, p, o = train_state_from_jax_checkpoint(
        cfg, root / "jax_ckpt", device="cpu")
    st = _blocks(cfg, {"params": p, "opt": o}, mesh)
    _, step, _, _ = make_train_step(cfg, "cpu", mesh=mesh)
    p, o, met = step(st["params"], st["opt"], batches[step_no])
    out = {"step": np.int64(step_no), "loss": met["loss"].numpy(),
           "grad_norm": met["grad_norm"].numpy()}
    _flat(out, "params", p)
    return out


def ckpt_cases(rank: int, world: int, group, root: str,
               data_path: str) -> dict:
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    root = pathlib.Path(root)
    out = {}
    for name in CASES:
        got = run_case(name, rank, root, data[CASES[name]["arch"]])
        out.update({f"{name}/{k}": v for k, v in got.items()})
    got = jax_case(rank, root, data[CASES[JAX_CASE]["arch"]])
    out.update({f"jax/{k}": v for k, v in got.items()})
    return out


# ------------------------------------------------------------ the checks
def fields(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def cut(name: str, tree: dict, shape, rank: int) -> dict:
    """A whole state (``{"params"[, "opt"]}``, numpy leaves) cut to rank
    ``rank``'s blocks on a mesh of ``shape``, keyed by path."""
    import types

    import torch

    from repro_torch.launch.sharding import shard_tree, state_specs
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = cfg_of(name)
    mesh = types.SimpleNamespace(shape=dict(zip(MESH_AXES, shape)),
                                 axis_names=MESH_AXES)
    specs = state_specs(cfg, mesh)
    if set(tree) == {"params"}:
        specs = {"params": specs["params"]}
    tree = tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)
    blocks = shard_tree(tree, specs, mesh, coords=coords_of(shape, rank))
    return {"/".join(map(str, p)): t.numpy()
            for p, t in tree_leaves_with_path(blocks)}
