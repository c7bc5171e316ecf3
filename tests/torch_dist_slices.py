"""Rank programs of ``tests/test_torch_dist_elastic.py``,
``tests/test_torch_dist_moe.py``, ``tests/test_torch_dist_tp.py`` and
``tests/test_torch_dist_rest.py``,
started by ``torch_dist_ranks.run_ranks``
(``spawn``, a ``file://`` store, one intra-op thread a rank).  pytest does
not collect this module.  A spawned rank imports it by name, so it imports
neither ``jax`` nor ``repro`` at the top; the chaos replay takes the
package's modules as arguments, and the JAX subprocess runs the same
function with the JAX package's."""
from __future__ import annotations

import dataclasses
import json

import numpy as np

# ------------------------------------------------------------ elastic
# benchmarks/bench_chaos.py's disaster script at run(scale=0.1)'s graph,
# at parallel_device with 4 workers and the straggler bias on, and a cold
# repair of machine 3 after feed COLD_AT
CHAOS_GRAPH = dict(num_docs=1200, vocab=1638, mean_len=20, seed=0)
CHAOS_CHUNKS = 12
CHAOS_EVENTS = ((2, "add", None, 4.0), (3, "add", None, 4.0),
                (4, "straggle", 1, 4.0), (5, "kill", None, 4.0),
                (6, "add", None, 4.0), (7, "add", None, 4.0),
                (8, "recover", 1, 4.0), (9, "kill", None, 4.0))
COLD_AT, COLD_MACHINE = 10, 3
ELASTIC_BASE = dict(k=8, backend="parallel_device", workers=4,
                    block_size=32, merge_every=1, refine_v=False, seed=0)
WALL_FEEDS = 4
METRICS = ("sizes", "footprint", "traffic", "worker_recv", "server_send")


def op_fields(op) -> list:
    """An ``ElasticOp``'s compared fields (not its wall-clock seconds)."""
    return [op.kind, op.committed, op.k_before, op.k_after, op.machine,
            list(dataclasses.astuple(op.traffic)), op.projected_savings,
            op.moved_u, op.mode, op.partner]


def chaos_replay(api, elastic, graphs, *, base_extra=None,
                 stream_extra=None, observe_wallclock=False, feeds=None,
                 **session_kw) -> dict:
    """The chaos script through one package's ``ElasticSession`` (``api``,
    ``elastic``, ``graphs``: its modules); every feed's state, the ops,
    and ``result(refine_v=True)``, as arrays.  ``session_kw`` goes to
    the session (the port's ``device`` and ``group``)."""
    g = graphs.text_like(**CHAOS_GRAPH)
    bounds = np.linspace(0, g.num_u, CHAOS_CHUNKS + 1).astype(int)
    chunks = [g.slice_u(int(bounds[i]), int(bounds[i + 1]))
              for i in range(CHAOS_CHUNKS)][:feeds]
    base = api.ParsaConfig(**dict(ELASTIC_BASE, **(base_extra or {})))
    cfg = elastic.ElasticConfig(
        stream=api.ParsaStreamConfig(base=base, repartition="never",
                                     **(stream_extra or {})),
        observe_wallclock=observe_wallclock)
    chaos = None if observe_wallclock else elastic.ChaosSchedule(
        [elastic.ChaosEvent(*e) for e in CHAOS_EVENTS], seed=0)
    sess = elastic.ElasticSession(cfg, g.num_v, chaos=chaos, **session_kw)
    out = {}
    for i, c in enumerate(chunks):
        u = sess.feed(c)
        p = f"feed{i}/"
        out[p + "parts"] = sess.parts.copy()
        out[p + "masks"] = sess.stream.arena.masks_np(logical=False)
        out[p + "sizes"] = np.array(sess.stream.arena.sizes)  # a copy
        out[p + "traffic"] = np.asarray(dataclasses.astuple(sess.traffic))
        out[p + "weights"] = sess.ewma.weights()
        out[p + "k"] = np.int64(sess.k)
        out[p + "dispatches"] = np.asarray(json.dumps(u.dispatches,
                                                      sort_keys=True))
        if i == COLD_AT and not observe_wallclock:
            sess.repair(COLD_MACHINE, mode="cold")
            out[p + "cold_parts"] = sess.parts.copy()
            out[p + "cold_masks"] = sess.stream.arena.masks_np(logical=False)
    out["ops"] = np.asarray(json.dumps([op_fields(o) for o in sess.ops]))
    res = sess.result(refine_v=True)
    for f in ("parts_u", "parts_v", "s_masks"):
        out[f"result/{f}"] = np.asarray(getattr(res, f))
    for f in METRICS:
        out[f"result/m_{f}"] = np.asarray(getattr(res.metrics, f))
    return out


def _raises(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def elastic_cases(rank: int, world: int, group) -> dict:
    """Every case of ``tests/test_torch_dist_elastic.py`` on this rank."""
    from repro_torch import api, elastic, graphs
    from repro_torch.core.dispatch import dispatch_counter

    out = {}
    with dispatch_counter() as counts:
        out.update({f"chaos/{k}": v for k, v in chaos_replay(
            api, elastic, graphs, device="cpu", group=group).items()})
    out["chaos_gathers"] = np.int64(counts.get("parallel_merge_gather", 0))
    out.update({f"wall/{k}": v for k, v in chaos_replay(
        api, elastic, graphs, observe_wallclock=True, feeds=WALL_FEEDS,
        device="cpu", group=group).items()})
    # a group of one rank at one worker, against the ungrouped session
    # (no block shuffle: the grouped route draws a block permutation from
    # the stream's generator even at one worker, the ungrouped one-worker
    # feed does not)
    import datetime

    import torch.distributed as dist

    solo = [dist.new_group([r], backend="gloo", timeout=datetime.timedelta(
        seconds=60)) for r in range(world)]
    one = dict(base_extra={"workers": 1},
               stream_extra={"shuffle_blocks": False}, device="cpu")
    out.update({f"w1/{k}": v for k, v in chaos_replay(
        api, elastic, graphs, group=solo[rank], **one).items()})
    out.update({f"w1_ungrouped/{k}": v for k, v in chaos_replay(
        api, elastic, graphs, **one).items()})
    g = graphs.text_like(**CHAOS_GRAPH)

    def session(**over):
        base = api.ParsaConfig(**dict(ELASTIC_BASE, **over))
        return elastic.ElasticSession(elastic.ElasticConfig(
            stream=api.ParsaStreamConfig(base=base, repartition="never")),
            g.num_v, device="cpu", group=group)

    out["err/size"] = np.asarray(_raises(lambda: session(workers=2)))
    out["err/backend"] = np.asarray(_raises(
        lambda: session(backend="device_scan", workers=1)))
    # a rank that runs an op the others do not: every rank refuses at the
    # digest after the op
    sess = session()
    sess.feed(g.slice_u(0, 400))
    out["err/diverged"] = np.asarray(_raises(
        lambda: sess.grow_k(force=True) if rank else sess.shrink_k(
            force=True)))
    return out


# ------------------------------------------------------------ MoE
# name -> the reduced config's overrides, the (data, model) mesh, the
# prompt (B, S), the cache length and the greedy decode steps after it
STEP_CASES = {
    # T_loc = 80 >= 64: the weight path; decode at B_loc = 1, the token path
    "mix_weight": dict(arch="mixtral-8x22b", over={"fsdp": True},
                       mesh=(2, 2), B=2, S=80, cache=84, steps=3),
    # T_loc = 16 < 64: the token path, in prefill and decode
    "mix_token": dict(arch="mixtral-8x22b", over={"fsdp": True},
                      mesh=(2, 2), B=4, S=8, cache=16, steps=6),
    "ds_weight": dict(arch="deepseek-v2-236b", over={"fsdp": True},
                      mesh=(2, 2), B=2, S=80, cache=84, steps=3),
    "ds_token": dict(arch="deepseek-v2-236b", over={"fsdp": True},
                     mesh=(2, 2), B=4, S=8, cache=16, steps=6),
    # 2 experts on 4 model ranks: hidden-sharded, four partials a sum
    "mix_hidden": dict(arch="mixtral-8x22b",
                       over={"fsdp": True, "num_experts": 2},
                       mesh=(1, 4), B=2, S=16, cache=24, steps=4),
    # a dense family on a model axis of one place: its rows split 4 ways
    "dense_dp": dict(arch="qwen3-14b", over={}, mesh=(4, 1), B=4, S=8,
                     cache=16, steps=4),
    # FSDP of the dense weights: every block cut over data too, gathered a
    # layer at a time; the tied embed looked up from its d_model blocks
    "cmdr_fsdp": dict(arch="command-r-35b", over={"fsdp": True},
                      mesh=(2, 2), B=2, S=12, cache=16, steps=3),
    # the local MoE route over a split batch with its experts cut over
    # data (hidden-sharded specs on a model axis of one place)
    "mix_fsdp_dp": dict(arch="mixtral-8x22b", over={"fsdp": True},
                        mesh=(4, 1), B=4, S=8, cache=16, steps=3),
}
# name -> (arch, overrides, mesh, x shape, dtype): apply_moe with aux
APPLY_CASES = {
    "weight": ("mixtral-8x22b", {"fsdp": True}, (2, 2), (2, 80), "float32"),
    "token": ("mixtral-8x22b", {"fsdp": True}, (2, 2), (2, 16), "float32"),
    "hidden": ("mixtral-8x22b", {"fsdp": True, "num_experts": 2}, (1, 4),
               (2, 16), "float32"),
    "shared": ("deepseek-v2-236b", {"fsdp": True}, (2, 2), (2, 16),
               "float32"),
    "token_bf16": ("mixtral-8x22b", {"fsdp": True}, (2, 2), (2, 16),
                   "bfloat16"),
    "hidden_bf16": ("mixtral-8x22b", {"fsdp": True, "num_experts": 2},
                    (1, 4), (2, 16), "bfloat16"),
}
MESH_AXES = ("data", "model")


def _device_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=MESH_AXES)


def branch_spy():
    """Wrap ``models.moe._routed_sharded`` so that each call's branch and
    gathered bytes are kept: returns (the list they go to, undo)."""
    from repro_torch.models import moe

    seen, orig = [], moe._routed_sharded

    def spy(*a, info=None, **kw):
        d = {}
        out = orig(*a, info=d, **kw)
        seen.append(d)
        return out

    moe._routed_sharded = spy
    return seen, lambda: setattr(moe, "_routed_sharded", orig)


def run_steps(case: dict, params: dict, tokens: np.ndarray, mesh,
              frames: np.ndarray | None = None,
              step_gathered: list | None = None) -> dict:
    """A prefill and ``steps`` greedy decode steps of the port over
    ``mesh``: this place's rows of the logits and its block of the caches,
    the global tokens, and the bytes this place gathered in the prefill
    (over a process group; 0 in an emulated mesh).  ``frames``: the
    encoder-decoder's global frame embeddings; ``step_gathered``, a list
    that takes the bytes of each decode step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.mesh import (
        GATHERED,
        axis_group,
        gather_stack,
        reset_gathered,
    )
    from repro_torch.launch.sharding import activation_rules, shard_params
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves_with_path

    cfg = get_config(case["arch"]).reduced(**case["over"])
    full = model_params_from_numpy(cfg, params, device="cpu")
    mine = shard_params(cfg, full, mesh)
    _, prefill = make_prefill_step(cfg, "cpu", mesh=mesh)
    _, serve = make_serve_step(cfg, "cpu", mesh=mesh)
    batch = {"tokens": tokens, "cache_seq": case["cache"]}
    if frames is not None:
        batch["frames"] = frames
    emulated = not hasattr(mesh, "get_group")
    if not emulated:
        reset_gathered()
    logits, cache = prefill(mine, batch)
    out = {"prefill/logits": logits.float().numpy(),
           "prefill/gathered": np.int64(0 if emulated
                                        else GATHERED["bytes"])}
    batch_ax = activation_rules(cfg, mesh, case["B"])["batch"]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if batch_ax is not None:
        tok = gather_stack(tok, axis_group(mesh, batch_ax)).reshape(-1)
    toks = [tok.numpy()]
    for i in range(case["steps"]):
        if not emulated:
            reset_gathered()
        tok, lg, cache = serve(mine, {"token": tok[:, None],
                                      "pos": case["S"] + i, "cache": cache})
        if step_gathered is not None:
            step_gathered.append(0 if emulated else GATHERED["bytes"])
        out[f"step{i}/logits"] = lg.float().numpy()
        toks.append(tok.numpy())
    out["tokens"] = np.stack(toks)
    for path, leaf in tree_leaves_with_path(cache):
        out["cache/" + "/".join(map(str, path))] = leaf.float().numpy()
    return out


def run_apply(case, p: dict, x: np.ndarray, mesh) -> dict:
    """``apply_moe`` with its aux on this place's rows under the rules."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (
        activation_rules,
        batch_rows,
        mesh_rules,
        shard_params,
    )
    from repro_torch.models import moe
    from repro_torch.models.transformer import _gathered

    arch, over, _, _, dt = case
    cfg = get_config(arch).reduced(**over)
    tdt = getattr(torch, dt)
    pt = moe_params(p, tdt)
    mine = shard_params(cfg, {"moe": pt}, mesh)["moe"]
    rules = activation_rules(cfg, mesh, x.shape[0])
    rows = batch_rows(mesh, rules, x.shape[0])
    info = {}
    with mesh_rules(cfg, mesh, x.shape[0]):
        # the router and the shared experts gathered over data, as the
        # layer gathers them (transformer.apply_layer)
        mine = _gathered(mine, "stack/moe")
        y, aux = moe.apply_moe(mine, torch.from_numpy(x[rows]).to(tdt), cfg,
                               dtype=tdt, return_aux=True, info=info)
    return {"out": y.float().numpy(), "aux": aux["aux_loss"].numpy(),
            "counts": aux["expert_counts"].numpy(),
            "branch": np.asarray(info["branch"]),
            "gathered": np.int64(info["gathered_bytes"])}


def moe_params(p: dict, dtype) -> dict:
    """An MoE layer's parameters from the reference's (numpy): matrices in
    ``dtype``, the router float32."""
    import torch

    out = {}
    for name, a in p.items():
        if isinstance(a, dict):
            out[name] = moe_params(a, dtype)
        else:
            out[name] = torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.float32 if name == "router" else dtype)
    return out


def moe_cases(rank: int, world: int, group, data_path: str) -> dict:
    """Every case of ``tests/test_torch_dist_moe.py`` on this rank: each
    over a ``DeviceMesh`` of the 4 ranks, and on rank 0 the in-process
    emulation of every place (``launch.mesh.emulate_mesh``)."""
    import pickle

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import emulate_mesh
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )
    from repro_torch.models import moe

    with open(data_path, "rb") as f:
        data = pickle.load(f)
    out = {}
    seen, undo = branch_spy()
    meshes = {}
    for name, case in STEP_CASES.items():
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = _device_mesh(shape)
        seen.clear()
        got = run_steps(case, data["params"][name], data["tokens"][name],
                        meshes[shape])
        out.update({f"{name}/{k}": v for k, v in got.items()})
        out[f"{name}/branches"] = np.asarray(
            json.dumps([d["branch"] for d in seen]))
        if rank == 0:
            sizes = dict(zip(MESH_AXES, shape))
            emu = emulate_mesh(sizes, lambda m, c=case, n=name: run_steps(
                c, data["params"][n], data["tokens"][n], m))
            for r, e in enumerate(emu):
                out.update({f"emu{r}/{name}/{k}": v for k, v in e.items()})
    undo()
    for name, case in APPLY_CASES.items():
        shape = case[2]
        got = run_apply(case, data["moe"][name], data["x"][name],
                        meshes.get(shape) or _device_mesh(shape))
        out.update({f"apply/{name}/{k}": v for k, v in got.items()})
        if rank == 0:
            arch, over, _, _, dt = case
            cfg = get_config(arch).reduced(**over)
            tdt = getattr(torch, dt)
            y, aux = moe._routed_sharded_plain(
                moe_params(data["moe"][name], tdt),
                torch.from_numpy(data["x"][name]).to(tdt), cfg,
                dict(zip(MESH_AXES, shape)), dtype=tdt, return_aux=True)
            out[f"apply_emu/{name}/out"] = y.float().numpy()
            out[f"apply_emu/{name}/aux"] = aux["aux_loss"].numpy()
    # what no longer refuses over a mesh (a dense family on a model axis
    # of 2, a recurrent family, a train step with fsdp=False, and one with
    # fsdp=True over a split batch: "")
    mesh = meshes[(2, 2)]
    out["err/dense_tp"] = np.asarray(_raises(
        lambda: make_prefill_step(get_config("qwen3-14b").reduced(), "cpu",
                                  mesh=mesh), NotImplementedError))
    out["err/serve_tp"] = np.asarray(_raises(
        lambda: make_serve_step(get_config("qwen3-14b").reduced(), "cpu",
                                mesh=mesh), NotImplementedError))
    out["err/recurrent"] = np.asarray(_raises(
        lambda: make_prefill_step(get_config("xlstm-350m").reduced(), "cpu",
                                  mesh=mesh), NotImplementedError))
    out["err/train"] = np.asarray(_raises(
        lambda: make_train_step(get_config("mixtral-8x22b").reduced(),
                                "cpu", mesh=mesh), NotImplementedError))
    out["err/train_fsdp"] = np.asarray(_raises(
        lambda: make_train_step(get_config("mixtral-8x22b").reduced(
            fsdp=True), "cpu", mesh=mesh), NotImplementedError))
    return out


def cache_block(cfg, key: str, arr: np.ndarray, shape, rank: int):
    """The block of a global cache leaf ``arr`` (``key`` its path under
    ``cache/``) that rank ``rank`` of a (data, model) mesh of ``shape``
    holds: ``launch.sharding.cache_specs``' block."""
    import types

    import torch

    from repro_torch.launch import sharding as TS

    d, m = shape
    stand_in = types.SimpleNamespace(shape=dict(zip(MESH_AXES, shape)),
                                     axis_names=MESH_AXES)
    tree = leaf = torch.empty(arr.shape, device="meta")
    for k in reversed(key.split("/")):
        tree = {k: tree}
    specs = TS.cache_specs(cfg, tree, stand_in)
    for k in key.split("/"):
        specs = specs[k]
    del leaf
    coords = {"data": rank // m, "model": rank % m}
    return TS._block(torch.from_numpy(arr), specs, dict(zip(MESH_AXES, shape)),
                     coords).numpy()


# ------------------------------------------------------------ dense TP
# name -> the reduced config's overrides, the (data, model) mesh, the
# prompt (B, S), the cache length and the greedy decode steps after it
TP_CASES = {
    # 4 heads and 4 kv heads on 4 model places: each its own head
    "heads_1x4": dict(arch="qwen3-14b", over={"num_kv_heads": 4},
                      mesh=(1, 4), B=2, S=8, cache=12, steps=4),
    # 4 heads and 2 kv heads on 2 model places, the batch over data
    "heads_2x2": dict(arch="qwen3-14b", over={}, mesh=(2, 2), B=2, S=8,
                      cache=12, steps=4),
    # 2 kv heads on 4 places: head-sharded q, head_dim-sharded k, v
    "mixed_1x4": dict(arch="qwen3-14b", over={}, mesh=(1, 4), B=2, S=8,
                      cache=12, steps=4),
    # 6 heads on 4 places, S = 8: context parallel at prefill, then the
    # head_dim reduction at decode
    "cp_1x4": dict(arch="qwen3-14b",
                   over={"num_heads": 6, "num_kv_heads": 2,
                         "attn_impl": "chunked"},
                   mesh=(1, 4), B=2, S=8, cache=12, steps=4),
    # encoder, self-attention and cross-attention (2 kv heads: head_dim)
    "whisper_1x4": dict(arch="whisper-medium", over={}, mesh=(1, 4), B=2,
                        S=8, cache=12, steps=4),
    "vlm_2x2": dict(arch="internvl2-76b", over={}, mesh=(2, 2), B=2, S=8,
                    cache=12, steps=4),
    # tied embeddings: the vocab-sharded embed.T is the head
    "tied_1x4": dict(arch="command-r-35b", over={}, mesh=(1, 4), B=2, S=8,
                     cache=12, steps=4),
    # TP attention beside the expert-parallel route
    "moe_2x2": dict(arch="mixtral-8x22b", over={}, mesh=(2, 2), B=2, S=8,
                    cache=12, steps=4),
    # a model axis of one place: the local MoE route over a split batch
    "moe_4x1": dict(arch="mixtral-8x22b", over={}, mesh=(4, 1), B=4, S=8,
                    cache=12, steps=4),
}


# name -> (arch, overrides, mesh, x shape, dtype): one MLP block under the
# rules, its columns cut over the model axis and the partials summed
MLP_CASES = {
    "swiglu_bf16": ("qwen3-14b", {}, (1, 4), (2, 16), "bfloat16"),
    "gelu_bias_bf16": ("whisper-medium", {}, (2, 2), (2, 16), "bfloat16"),
    "swiglu_f32": ("qwen3-14b", {}, (2, 2), (2, 16), "float32"),
}


def run_mlp(case, p: dict, x: np.ndarray, mesh) -> np.ndarray:
    """``layers.apply_mlp`` on this place's rows and column block."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (
        activation_rules,
        batch_rows,
        mesh_rules,
        shard_params,
    )
    from repro_torch.models.layers import apply_mlp

    arch, over, _, _, dt = case
    cfg = get_config(arch).reduced(**over)
    tdt = getattr(torch, dt)
    mine = shard_params(cfg, {"mlp": moe_params(p, tdt)}, mesh)["mlp"]
    rules = activation_rules(cfg, mesh, x.shape[0])
    rows = batch_rows(mesh, rules, x.shape[0])
    with mesh_rules(cfg, mesh, x.shape[0]):
        y = apply_mlp(mine, torch.from_numpy(x[rows]).to(tdt), cfg.mlp,
                      dtype=tdt)
    return y.float().numpy()


def tp_cases(rank: int, world: int, group, data_path: str) -> dict:
    """Every case of ``tests/test_torch_dist_tp.py`` on this rank: each over
    a ``DeviceMesh`` of the 4 ranks, and on rank 0 the in-process
    emulation of every place (``launch.mesh.emulate_mesh``)."""
    import pickle

    from repro_torch.launch.mesh import emulate_mesh

    with open(data_path, "rb") as f:
        data = pickle.load(f)
    out = {}
    meshes = {}
    for name, case in TP_CASES.items():
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = _device_mesh(shape)
        args = (data["params"][name], data["tokens"][name])
        frames = data["frames"].get(name)
        got = run_steps(case, *args, meshes[shape], frames=frames)
        out.update({f"{name}/{k}": v for k, v in got.items()})
        if rank == 0:
            sizes = dict(zip(MESH_AXES, shape))
            emu = emulate_mesh(sizes, lambda m, c=case, a=args, f=frames:
                               run_steps(c, *a, m, frames=f))
            for r, e in enumerate(emu):
                out.update({f"emu{r}/{name}/{k}": v for k, v in e.items()})
    for name, case in MLP_CASES.items():
        shape = case[2]
        if shape not in meshes:
            meshes[shape] = _device_mesh(shape)
        args = (data["mlp"][name], data["x"][name])
        out[f"mlp/{name}"] = run_mlp(case, *args, meshes[shape])
        if rank == 0:
            emu = emulate_mesh(dict(zip(MESH_AXES, shape)),
                               lambda m, c=case, a=args: run_mlp(c, *a, m))
            for r, e in enumerate(emu):
                out[f"emu{r}/mlp/{name}"] = e
    return out


# ------------------------------------------- MLA TP, recurrent, eval
# name -> the reduced config's overrides, the (data, model) mesh, the
# batch B, the prompt S, the cache length and the greedy decode steps
# after it.  MLA: a prefill, then decode (``run_steps``).  The recurrent
# families: the prefill step's loss on (tokens, labels), then decode from
# zero states over the prompt (teacher forced) and the greedy steps.
REST_CASES = {
    # 4 heads, r = 32, dr = 8 on 4 model places: a head, 8 and 2 a place
    "mla_1x4": dict(arch="deepseek-v2-236b", over={}, mesh=(1, 4), B=2,
                    S=8, cache=12, steps=4),
    "mla_2x2": dict(arch="deepseek-v2-236b", over={}, mesh=(2, 2), B=2,
                    S=8, cache=12, steps=4),
    # G = 1 group of 3 mLSTM blocks: n_m = 3 does not divide data, so the
    # m state is whole on every place
    "xlstm_1x4": dict(arch="xlstm-350m", over={"num_layers": 4},
                      mesh=(1, 4), B=4, S=6, cache=10, steps=4),
    "xlstm_2x2": dict(arch="xlstm-350m", over={"num_layers": 4},
                      mesh=(2, 2), B=4, S=6, cache=10, steps=4),
    # G = 2 groups of 2 mLSTM blocks: n_m = 2 divides data, so a place
    # holds one block's m for every row of the global batch
    "xlstm_g3_1x4": dict(arch="xlstm-350m",
                         over={"xlstm_group": 3, "num_layers": 6},
                         mesh=(1, 4), B=4, S=6, cache=10, steps=4),
    "xlstm_g3_2x2": dict(arch="xlstm-350m",
                         over={"xlstm_group": 3, "num_layers": 6},
                         mesh=(2, 2), B=4, S=6, cache=10, steps=4),
    # 8 SSM heads, N = 16, the shared attention's 4/2 heads
    "hybrid_1x4": dict(arch="zamba2-2.7b", over={}, mesh=(1, 4), B=2, S=6,
                       cache=10, steps=4),
    "hybrid_2x2": dict(arch="zamba2-2.7b", over={}, mesh=(2, 2), B=4, S=6,
                       cache=10, steps=4),
}
# name -> the eval step's (arch, overrides, mesh, (B, S))
EVAL_CASES = {
    "dense": ("qwen3-14b", {}, (2, 2), (4, 8)),
    "moe": ("deepseek-v2-236b", {}, (2, 2), (4, 8)),
    "recurrent": ("zamba2-2.7b", {}, (2, 2), (4, 8)),
}


def labels_of(tokens: np.ndarray) -> np.ndarray:
    """Next-token labels of a prompt, the last position unlabelled."""
    lab = np.roll(tokens, -1, axis=1).astype(np.int32)
    lab[:, -1] = -1
    return lab


def run_recurrent(case: dict, params: dict, tokens: np.ndarray,
                  mesh) -> dict:
    """The recurrent families over ``mesh``: the prefill step's loss, then
    ``Model.init_cache`` under the rules (the place's block of zero
    states) and the serve step over the prompt and ``steps`` greedy
    tokens.  The place's rows of every step's logits, its block of the
    final states, the global tokens, and the bytes gathered (over a
    process group; 0 in an emulated mesh) by the loss and by each step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.mesh import GATHERED, reset_gathered
    from repro_torch.launch.sharding import (
        activation_rules,
        batch_rows,
        mesh_rules,
        shard_params,
    )
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves_with_path

    cfg = get_config(case["arch"]).reduced(**case["over"])
    full = model_params_from_numpy(cfg, params, device="cpu")
    mine = shard_params(cfg, full, mesh)
    model, prefill = make_prefill_step(cfg, "cpu", mesh=mesh)
    _, serve = make_serve_step(cfg, "cpu", mesh=mesh)
    emulated = not hasattr(mesh, "get_group")
    B = tokens.shape[0]
    reset_gathered()
    loss = prefill(mine, {"tokens": tokens, "labels": labels_of(tokens)})
    out = {"loss": loss.numpy(),
           "loss_gathered": np.int64(0 if emulated else GATHERED["bytes"])}
    rows = batch_rows(mesh, activation_rules(cfg, mesh, B), B)
    with mesh_rules(cfg, mesh, B):
        cache = model.init_cache(len(range(B)[rows]), case["cache"])
    tok, toks = None, []
    for i in range(case["S"] + case["steps"]):
        feed = torch.from_numpy(tokens[:, i]) if i < case["S"] else tok
        reset_gathered()
        tok, lg, cache = serve(mine, {"token": feed[:, None], "pos": i,
                                      "cache": cache})
        out[f"step{i}/logits"] = lg.float().numpy()
        out[f"step{i}/gathered"] = np.int64(0 if emulated
                                            else GATHERED["bytes"])
        toks.append(tok.numpy())
    out["tokens"] = np.stack(toks)
    for path, leaf in tree_leaves_with_path(cache):
        out["cache/" + "/".join(map(str, path))] = leaf.float().numpy()
    return out


def run_mla(case: dict, params: dict, tokens: np.ndarray, mesh) -> dict:
    """``run_steps``, with the bytes each decode step gathers (over a
    process group; 0 in an emulated mesh)."""
    seen = []
    out = run_steps(case, params, tokens, mesh, step_gathered=seen)
    out["decode_gathered"] = np.asarray(seen, np.int64)
    return out


def run_eval(case, params: dict, tokens: np.ndarray, mesh) -> dict:
    """``make_eval_step(mesh=)``'s loss and label count."""
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.sharding import shard_params
    from repro_torch.launch.steps import make_eval_step

    arch, over, _, _ = case
    cfg = get_config(arch).reduced(**over)
    mine = shard_params(cfg, model_params_from_numpy(cfg, params,
                                                     device="cpu"), mesh)
    _, step = make_eval_step(cfg, "cpu", mesh=mesh)
    m = step(mine, {"tokens": tokens, "labels": labels_of(tokens)})
    return {k: v.numpy() for k, v in m.items()}


def rest_cases(rank: int, world: int, group, data_path: str) -> dict:
    """Every case of ``tests/test_torch_dist_rest.py`` on this rank: each
    over a ``DeviceMesh`` of the 4 ranks, and on rank 0 the in-process
    emulation of every place (``launch.mesh.emulate_mesh``)."""
    import pickle

    from repro_torch.launch.mesh import emulate_mesh

    with open(data_path, "rb") as f:
        data = pickle.load(f)
    out, meshes = {}, {}

    def one(name, fn, case, shape, args):
        if shape not in meshes:
            meshes[shape] = _device_mesh(shape)
        got = fn(case, *args, meshes[shape])
        out.update({f"{name}/{k}": v for k, v in got.items()})
        if rank == 0:
            emu = emulate_mesh(dict(zip(MESH_AXES, shape)),
                               lambda m: fn(case, *args, m))
            for r, e in enumerate(emu):
                out.update({f"emu{r}/{name}/{k}": v for k, v in e.items()})

    for name, case in REST_CASES.items():
        fn = run_mla if case["arch"] == "deepseek-v2-236b" else run_recurrent
        one(name, fn, case, case["mesh"],
            (data["params"][name], data["tokens"][name]))
    for name, case in EVAL_CASES.items():
        one(f"eval/{name}", run_eval, case, case[2],
            (data["eval_params"][name], data["eval_tokens"][name]))
    return out
