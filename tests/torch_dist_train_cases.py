"""The train step over a (data x model) mesh: the cases of
``tests/test_torch_dist_train.py``, ``tests/test_torch_dist_train_rec.py``
and ``tests/test_torch_dist_fsdp.py``,
the rank program both run (``train_cases``, started by
``torch_dist_ranks.run_ranks``), the JAX script both run in one subprocess
on 4 forced host devices, and the checks both make.  pytest does not
collect this module; a spawned rank imports it by name, so it imports
neither ``jax`` nor ``repro`` at the top."""
from __future__ import annotations

import json
import pickle
import types

import numpy as np

WORLD = 4
STEPS = 2
MESH_AXES = ("data", "model")
B, S = 4, 8
TOL = 1e-5
# bf16 moments (deepseek-v2-236b's and internvl2-76b's reduced policy):
# one bf16 step, as tests/test_torch_train.py holds them
BF16_MOMENT_TOL = 2 ** -8
# the recurrent families' and the VLM's gradients are steeper than
# float32's last bit in JAX itself (tests/torch_lm_family.py): their
# gradient-derived quantities are held within SPREAD_FACTOR times JAX's
# own distance to its steps from weights moved by half an ulp, floored at
# TOL and capped at SPREAD_CAP
SPREAD_FACTOR = 4
SPREAD_CAP = 1e-2
SPREAD_RUNS = 3

# name -> the reduced config's overrides, the (data, model) mesh, and
# whether its checks take JAX's half-ulp spread
CASES = {
    # dense: heads on both axes; every head its own place with 2 kv heads
    # cut by head_dim (k and v gathered to whole heads); one place of the
    # model axis (the batch split 4 ways)
    "qwen_2x2": dict(arch="qwen3-14b", over={}, mesh=(2, 2)),
    "qwen_1x4": dict(arch="qwen3-14b", over={}, mesh=(1, 4)),
    # biases on q, k, v; MHA
    "codeqwen_2x2": dict(arch="codeqwen1.5-7b", over={}, mesh=(2, 2)),
    # 6 heads on 4 places: q and o cut by head_dim, the score reduced
    # over head_dim (naive attention)
    "hd_1x4": dict(arch="qwen3-14b", over={"num_heads": 6,
                                           "num_kv_heads": 2},
                   mesh=(1, 4)),
    # context parallel: the place's query rows, gathered back
    "cp_1x4": dict(arch="qwen3-14b",
                   over={"num_heads": 6, "num_kv_heads": 2,
                         "attn_impl": "chunked"}, mesh=(1, 4)),
    # expert parallelism beside tensor-parallel attention
    "mixtral_2x2": dict(arch="mixtral-8x22b", over={}, mesh=(2, 2)),
    # MLA heads and MoE (a shared expert), bf16 moments
    "deepseek_1x4": dict(arch="deepseek-v2-236b", over={}, mesh=(1, 4)),
    "whisper_2x2": dict(arch="whisper-medium", over={}, mesh=(2, 2)),
    "vlm_2x2": dict(arch="internvl2-76b", over={}, mesh=(2, 2),
                    spread=True),
    # int8 compression with error feedback: the whole leaves' scales.  A
    # gradient a last bit off sends the neighbouring int8 value, which
    # AdamW's first steps turn into a whole step of that element
    # (tests/test_torch_train.py): held within JAX's own spread
    "compress_2x2": dict(arch="qwen3-14b", over={"grad_compress": True},
                         mesh=(2, 2), spread=True),
    # pure data parallelism: the dense family and the MoE's local route
    # over a split batch (its tokens gathered over the batch axes)
    "qwen_4x1": dict(arch="qwen3-14b", over={}, mesh=(4, 1)),
    "mixtral_4x1": dict(arch="mixtral-8x22b", over={}, mesh=(4, 1)),
    # one group of 3 mLSTM blocks and an sLSTM (n_m = 3)
    "xlstm_1x4": dict(arch="xlstm-350m", over={"num_layers": 4},
                      mesh=(1, 4), spread=True),
    "xlstm_2x2": dict(arch="xlstm-350m", over={"num_layers": 4},
                      mesh=(2, 2), spread=True),
    # two groups of 2 mLSTM blocks (n_m = 2)
    "xlstm_g3_1x4": dict(arch="xlstm-350m",
                         over={"xlstm_group": 3, "num_layers": 6},
                         mesh=(1, 4), spread=True),
    "xlstm_g3_2x2": dict(arch="xlstm-350m",
                         over={"xlstm_group": 3, "num_layers": 6},
                         mesh=(2, 2), spread=True),
    # Mamba2 heads and the shared attention
    "hybrid_1x4": dict(arch="zamba2-2.7b", over={}, mesh=(1, 4),
                       spread=True),
    "hybrid_2x2": dict(arch="zamba2-2.7b", over={}, mesh=(2, 2),
                       spread=True),
    # FSDP of the dense weights (fsdp=True: every dim the spec names
    # "data" cut over it, gathered a layer at a time, reduce-scattered in
    # the backward): the tied embed, layernorm and 2 microbatches
    "cmdr_fsdp_2x2": dict(arch="command-r-35b", over={"fsdp": True},
                          mesh=(2, 2)),
    "cmdr_fsdp_4x1": dict(arch="command-r-35b", over={"fsdp": True},
                          mesh=(4, 1)),
    # squared ReLU, an untied lm_head, bf16 moments
    "nemotron_fsdp_2x2": dict(arch="nemotron-4-340b", over={"fsdp": True},
                              mesh=(2, 2)),
    # the experts and the router over data
    "mixtral_fsdp_2x2": dict(arch="mixtral-8x22b", over={"fsdp": True},
                             mesh=(2, 2)),
    # MLA's ranks over data, a shared expert
    "deepseek_fsdp_2x2": dict(arch="deepseek-v2-236b", over={"fsdp": True},
                              mesh=(2, 2)),
    "vlm_fsdp_2x2": dict(arch="internvl2-76b", over={"fsdp": True},
                         mesh=(2, 2), spread=True),
    "xlstm_fsdp_2x2": dict(arch="xlstm-350m",
                           over={"fsdp": True, "num_layers": 4},
                           mesh=(2, 2), spread=True),
    "hybrid_fsdp_2x2": dict(arch="zamba2-2.7b", over={"fsdp": True},
                            mesh=(2, 2), spread=True),
}
DENSE = ("qwen_2x2", "qwen_1x4", "codeqwen_2x2", "hd_1x4", "cp_1x4",
         "mixtral_2x2", "deepseek_1x4", "whisper_2x2", "vlm_2x2",
         "compress_2x2")
RECURRENT = ("qwen_4x1", "mixtral_4x1", "xlstm_1x4", "xlstm_2x2",
             "xlstm_g3_1x4", "xlstm_g3_2x2", "hybrid_1x4", "hybrid_2x2")
FSDP = ("cmdr_fsdp_2x2", "cmdr_fsdp_4x1", "nemotron_fsdp_2x2",
        "mixtral_fsdp_2x2", "deepseek_fsdp_2x2", "vlm_fsdp_2x2",
        "xlstm_fsdp_2x2", "hybrid_fsdp_2x2")

# vectors that init fills with one value (ones, zeros, a constant): drawn
# here so that a place reading another place's slice of them shows
PERTURB = {"A_log": (0.0, 0.5), "dt_bias": (0.0, 0.5),
           "D_skip": (1.0, 0.5), "out_norm": (1.0, 0.3),
           "b_i": (0.0, 0.5), "b_f": (3.0, 0.5), "q_a_norm": (1.0, 0.2),
           "kv_a_norm": (1.0, 0.2), "q_norm": (1.0, 0.2),
           "k_norm": (1.0, 0.2), "bq": (0.0, 0.1), "bk": (0.0, 0.1),
           "bv": (0.0, 0.1)}

JAX_SCRIPT = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.launch.sharding import opt_pspecs, param_pspecs, to_named
from repro.launch.steps import make_train_step
from repro.optim import init_compression, init_opt_state

names, cases, data_path, out_path, runs = json.loads(sys.argv[1])
data = pickle.load(open(data_path, "rb"))
out = {}


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        return a * (1 + 6e-8 * rng.standard_normal(a.shape)).astype(
            np.float32)

    return jax.tree.map(one, tree)


for name in names:
    c = cases[name]
    cfg = get_config(c["arch"]).reduced(**c["over"])
    # Auto axes, as GSPMD partitions
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(
        tuple(c["mesh"])), ("data", "model"))
    _, step, _, opt_cfg = make_train_step(cfg, mesh)
    jstep = jax.jit(step)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in data["batches"][name]]
    starts = [("main", data["params"][name])]
    if c.get("spread"):
        starts += [(f"spread{s}", perturbed(data["params"][name], s))
                   for s in range(runs)]
    out[name] = {}
    for prefix, p0 in starts:
        got = out[name][prefix] = {}
        params = jax.device_put(p0, to_named(
            param_pspecs(cfg, p0, mesh), mesh))
        opt = init_opt_state(params, opt_cfg)
        if cfg.grad_compress:
            opt["comp"] = init_compression(params)
        for i, b in enumerate(batches):
            params, opt, m = jstep(params, opt, b)
            for k, v in m.items():
                got[f"step{i}/{k}"] = float(np.asarray(v, np.float32))
            if i == 0:
                got["m1"], got["v1"] = host(opt["m"]), host(opt["v"])
        got["p2"] = host(params)
pickle.dump(out, open(out_path, "wb"))
print("JAX_DIST_TRAIN_DONE")
"""


def cfg_of(name):
    from repro_torch.configs import get_config

    c = CASES[name]
    return get_config(c["arch"]).reduced(**c["over"])


def stand_in(shape):
    """A mesh of ``shape`` for ``launch.sharding``'s spec functions, no
    ranks."""
    return types.SimpleNamespace(shape=dict(zip(MESH_AXES, shape)),
                                 axis_names=MESH_AXES)


def coords_of(shape, rank: int) -> dict:
    return {"data": rank // shape[1], "model": rank % shape[1]}


# ------------------------------------------------------------ the data
def make_data(names) -> dict:
    """The JAX ``init_state``'s weights of every case (numpy, the
    one-valued vectors perturbed) and its seeded batches.  JAX is
    imported here only (the test process calls this)."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.launch.steps import make_train_step as jax_train

    rng = np.random.default_rng(31)
    params, batches = {}, {}
    for name in names:
        c = CASES[name]
        cfg = jax_config(c["arch"]).reduced(**c["over"])
        _, _, init, _ = jax_train(cfg)
        p, _ = jax.jit(init)(jax.random.PRNGKey(0))
        p = jax.tree.map(np.asarray, p)

        def one(path, leaf):
            name_ = str(getattr(path[-1], "key", ""))
            if name_ not in PERTURB:
                return leaf
            mu, sd = PERTURB[name_]
            return (mu + sd * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)

        params[name] = jax.tree_util.tree_map_with_path(one, p)
        bs = []
        for _ in range(STEPS):
            b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32)}
            b["labels"][0, :3] = -1
            if cfg.family == "encdec":
                b["frames"] = rng.standard_normal(
                    (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            if cfg.family == "vlm":
                b["patches"] = rng.standard_normal(
                    (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
            bs.append(b)
        batches[name] = bs
    return {"params": params, "batches": batches}


def start(tmp, names, jax_procs: int = 1):
    """Write the data, start JAX on 4 forced host devices (in
    ``jax_procs`` subprocesses, the cases dealt among them in turn), run
    the ranks; returns (JAX's arrays, each rank's arrays)."""
    import functools

    import torch_dist_ranks as R

    data_path = tmp / "data.pkl"
    with open(data_path, "wb") as f:
        pickle.dump(make_data(names), f)
    procs = [R.start_jax(JAX_SCRIPT, json.dumps(
        [list(names[i::jax_procs]), CASES, str(data_path),
         str(tmp / f"jax{i}.pkl"), SPREAD_RUNS], default=list),
        devices=WORLD) for i in range(jax_procs)]
    try:
        ranks = R.run_ranks(functools.partial(
            train_cases, names=tuple(names), data_path=str(data_path)),
            WORLD, tmp / "ranks")
    finally:
        for proc in procs:
            R.finish_jax(proc, "JAX_DIST_TRAIN_DONE")
    out = {}
    for i in range(jax_procs):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out, ranks


# ------------------------------------------------------------ a rank
def _device_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=MESH_AXES)


def _flat(out: dict, prefix: str, tree) -> None:
    from repro_torch.tree import tree_leaves_with_path

    for path, leaf in tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(map(str, path))] = \
            leaf.detach().float().numpy().copy()


def run_train(name: str, params_np, batches, mesh) -> dict:
    """``STEPS`` train steps over ``mesh`` from the case's state, cut to
    this place's blocks: each step's metrics and bytes gathered (over a
    process group; 0 in an emulated mesh), the moments after step 1 and
    the blocks after every step."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.mesh import GATHERED, reset_gathered
    from repro_torch.launch.sharding import shard_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_compression, init_opt_state

    cfg = cfg_of(name)
    _, step, _, opt_cfg = make_train_step(cfg, "cpu", mesh=mesh)
    params = shard_params(cfg, model_params_from_numpy(
        cfg, params_np, device="cpu", master=True), mesh)
    opt = init_opt_state(params, opt_cfg)
    if cfg.grad_compress:
        opt["comp"] = init_compression(params)
    emulated = not hasattr(mesh, "get_group")
    out = {}
    for i, b in enumerate(batches):
        reset_gathered()
        params, opt, m = step(params, opt, b)
        for k, v in m.items():
            out[f"step{i}/{k}"] = v.detach().float().numpy()
        for k, v in GATHERED.items():
            out[f"step{i}/gathered_{k}"] = np.int64(0 if emulated else v)
        if i == 0:
            _flat(out, "m1", opt["m"])
            _flat(out, "v1", opt["v"])
        _flat(out, f"p{i + 1}", params)
    return out


def train_cases(rank: int, world: int, group, names, data_path: str) -> dict:
    """The named cases on this rank over a ``DeviceMesh`` of the 4 ranks,
    and on rank 0 the in-process emulation of every place
    (``launch.mesh.emulate_mesh``)."""
    from repro_torch.launch.mesh import emulate_mesh

    with open(data_path, "rb") as f:
        data = pickle.load(f)
    out, meshes = {}, {}
    for name in names:
        shape = CASES[name]["mesh"]
        if shape not in meshes:
            meshes[shape] = _device_mesh(shape)
        args = (data["params"][name], data["batches"][name])
        got = run_train(name, *args, meshes[shape])
        out.update({f"{name}/{k}": v for k, v in got.items()})
        if rank == 0:
            emu = emulate_mesh(dict(zip(MESH_AXES, shape)),
                               lambda m, n=name, a=args: run_train(n, *a, m))
            for r, e in enumerate(emu):
                out.update({f"emu{r}/{name}/{k}": v for k, v in e.items()})
    return out


# ------------------------------------------------------------ the checks
def fields(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def jax_blocks(name: str, tree, prefix: str, rank: int) -> dict:
    """A JAX tree (numpy, its stacked layout) cut to rank ``rank``'s
    blocks, in the port's layout, keyed as ``run_train`` keys them under
    ``prefix``."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.sharding import shard_params
    from repro_torch.tree import tree_leaves_with_path

    cfg = cfg_of(name)
    shape = CASES[name]["mesh"]
    port = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    mine = shard_params(cfg, port, stand_in(shape),
                        coords=coords_of(shape, rank))
    return {prefix + "/" + "/".join(map(str, p)): t.float().numpy()
            for p, t in tree_leaves_with_path(mine)}


def rel_l2(got: dict, want: dict) -> float:
    assert set(got) == set(want), set(got) ^ set(want)
    num = sum(float(((np.asarray(got[k], np.float64)
                      - np.asarray(want[k], np.float64)) ** 2).sum())
              for k in want)
    den = sum(float((np.asarray(want[k], np.float64) ** 2).sum())
              for k in want)
    return float(np.sqrt(num / max(den, 1e-30)))


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def bound(spread: float, tol: float = TOL) -> float:
    return min(max(tol, SPREAD_FACTOR * spread), SPREAD_CAP)


def against_jax(name: str, jax_out: dict, got: dict, rank: int) -> list:
    """Rank ``rank``'s quantities against JAX's: (what, error, bound) a
    row.  The loss and grad_norm of each step, the blocks of m and v after
    step 1 and of the parameters after step 2 (relative L2 over the
    rank's blocks); a spread case's bounds from JAX's own distance to its
    runs from perturbed weights."""
    cfg = cfg_of(name)
    runs = jax_out[name]
    want = runs["main"]
    others = [r for k, r in runs.items() if k != "main"]
    spread = bool(CASES[name].get("spread"))
    rows = []
    for i in range(STEPS):
        for k in ("loss", "grad_norm"):
            key = f"step{i}/{k}"
            own = max((rel(r[key], want[key]) for r in others), default=0.0)
            rows.append((key, rel(got[key], want[key]),
                         bound(own) if spread else TOL))
        assert float(got[f"step{i}/tokens"]) == want[f"step{i}/tokens"]
    for prefix in ("m1", "v1", "p2"):
        tol = (BF16_MOMENT_TOL if prefix != "p2"
               and cfg.opt_dtype == "bfloat16" else TOL)
        ref = jax_blocks(name, want[prefix], prefix, rank)
        mine = {k: v for k, v in got.items() if k.startswith(prefix + "/")}
        own = max((rel_l2(jax_blocks(name, r[prefix], prefix, rank), ref)
                   for r in others), default=0.0)
        rows.append((prefix, rel_l2(mine, ref),
                     bound(own, tol) if spread else tol))
    return rows


def replicas(name: str) -> dict:
    """{leaf path: [groups of ranks that hold the same block]} from
    ``launch.sharding.replica_axes`` over the whole shapes."""
    import torch

    from repro_torch.launch.sharding import replica_axes
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves_with_path

    cfg = cfg_of(name)
    shape = CASES[name]["mesh"]
    shapes = Model(cfg, torch.device("meta")).init(master=True)
    reps = replica_axes(cfg, shapes, stand_in(shape))
    out = {}
    for path, _ in tree_leaves_with_path(shapes):
        rep = reps
        for k in path:
            rep = rep[k]
        cut = [a for a in MESH_AXES if a not in rep]
        groups: dict = {}
        for r in range(WORLD):
            c = coords_of(shape, r)
            groups.setdefault(tuple(c[a] for a in cut), []).append(r)
        out["/".join(map(str, path))] = [g for g in groups.values()
                                         if len(g) > 1]
    return out
