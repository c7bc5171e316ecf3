"""The MoE family over a (data x model) ``DeviceMesh``: the port's
expert-parallel route (``models.moe._routed_sharded``) and the serving
steps over a mesh (``launch.steps``), against the JAX package's
``_routed_shard_map`` and jitted steps under ``logical_axis_rules``.

One 4-rank gloo group (``spawn``, a ``file://`` store under ``tmp_path``,
one intra-op thread a rank) runs every case of
``torch_dist_slices.moe_cases`` once for the module, while JAX runs the
same weights (the JAX model's own, carried across with
``convert.model_params_from_numpy``) and inputs on 4 forced host devices
in a subprocess, with the parameters placed by its ``param_pspecs``.
Cases: the reduced mixtral-8x22b and deepseek-v2-236b with ``fsdp=True``
on mesh (2, 2), a prefill with T_loc >= 64 (the weight path) and one with
T_loc < 64 (the token path), then greedy decode steps (the token path);
mixtral with 2 experts on mesh (1, 4) (hidden-sharded); qwen3-14b on mesh
(4, 1) (a dense family, rows split 4 ways); ``apply_moe(...,
return_aux=True)`` on each branch, float32 and bf16.

Tolerances.  Each rank's rows against JAX: float32 logits and caches
within 1e-5 (absolute and relative), tokens exactly.  ``apply_moe``'s
float32 output within 1e-5 as the local route's test holds it
(``tests/test_torch_moe.py``): the expert products sum in another order
than XLA's dot, so the partials differ in their last bits before any sum
and no sum of them can be bitwise.  In bf16, within one bf16 ulp of JAX's
value, and equal on at least 99% of the outputs: the port adds the
partials in rank order in float32 and rounds once, as XLA's CPU
all-reduce does (bfloat16 adds would leave many outputs an ulp off).
``aux_loss`` within 1e-6, ``expert_counts`` exactly: both the global
batch's.  Each rank against the in-process emulation of the mesh (rank
0's ``emulate_mesh``, the same places in threads): bit for bit, logits,
caches, tokens and ``apply_moe``'s output.  Over a model axis of 2 the
attention, embedding and head are tensor-parallel too, so a rank's cache
is its block (``torch_dist_slices.cache_block``).  With ``fsdp=True`` the
dense blocks are cut over data too and gathered a layer at a time
(command-r-35b's prefill and decode, its tied embedding looked up from
its d_model blocks).  Refusals: none left (a recurrent family, a train
step over a mesh with and without ``fsdp``, a dense family on a model
axis of 2 all run).
"""
import functools
import json
import pickle

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_dist_slices as S

WORLD = 4
TOL = 1e-5

_JAX_SCRIPT = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.launch.sharding import activation_rules, param_pspecs, to_named
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import moe as JMOE
from repro.models.shardctx import logical_axis_rules


def make_mesh(shape):
    # Auto axes, as GSPMD partitions (jax.make_mesh may default to
    # explicit axes, under which the model's gathers need out shardings)
    return jax.sharding.Mesh(np.asarray(jax.devices()).reshape(shape),
                             ("data", "model"))


steps, applies, data_path, out_path = json.loads(sys.argv[1])
data = pickle.load(open(data_path, "rb"))
out = {}
for name, c in steps.items():
    cfg = get_config(c["arch"]).reduced(**c["over"])
    mesh = make_mesh(tuple(c["mesh"]))
    params = data["params"][name]
    params = jax.device_put(params, to_named(
        param_pspecs(cfg, params, mesh), mesh))
    _, pre = make_prefill_step(cfg, mesh)
    _, serve = make_serve_step(cfg, mesh)
    logits, cache = jax.jit(lambda p, t: pre(
        p, {"tokens": t, "cache_seq": c["cache"]}))(
            params, jnp.asarray(data["tokens"][name]))
    out[f"{name}/prefill/logits"] = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    jserve = jax.jit(serve)
    for i in range(c["steps"]):
        tok, lg, cache = jserve(params, {"token": tok[:, None],
                                         "pos": jnp.int32(c["S"] + i),
                                         "cache": cache})
        out[f"{name}/step{i}/logits"] = np.asarray(lg, np.float32)
        toks.append(np.asarray(tok))
    out[f"{name}/tokens"] = np.stack(toks)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp)
        out[f"{name}/cache/{key}"] = np.asarray(leaf, np.float32)
for name, (arch, over, shape, xs, dt) in applies.items():
    cfg = get_config(arch).reduced(**over)
    mesh = make_mesh(tuple(shape))
    dtype = jnp.dtype(dt)

    def f(p, x):
        with logical_axis_rules(mesh, activation_rules(cfg, mesh,
                                                       x.shape[0])):
            return JMOE.apply_moe(p, x.astype(dtype), cfg, dtype=dtype,
                                  return_aux=True)

    y, aux = jax.jit(f)(data["moe"][name], jnp.asarray(data["x"][name]))
    out[f"apply/{name}/out"] = np.asarray(y.astype(jnp.float32))
    out[f"apply/{name}/aux"] = np.asarray(aux["aux_loss"])
    out[f"apply/{name}/counts"] = np.asarray(aux["expert_counts"])
np.savez(out_path, **out)
print("JAX_DIST_MOE_DONE")
"""


def _data() -> dict:
    """The JAX models' weights (numpy) and the seeded inputs of every
    case.  JAX is imported here, not at the top: the ``cuda`` test below
    runs on a card's machine, which has no JAX."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import moe as JMOE
    from repro.models.model import build_model as jax_build

    params, tokens, moe, xs = {}, {}, {}, {}
    rng = np.random.default_rng(5)
    for name, c in S.STEP_CASES.items():
        cfg = jax_config(c["arch"]).reduced(**c["over"])
        jm = jax_build(cfg)
        params[name] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3)))
        tokens[name] = rng.integers(0, cfg.vocab_size, (c["B"], c["S"]),
                                    dtype=np.int32)
    for name, (arch, over, _, shape, _) in S.APPLY_CASES.items():
        cfg = jax_config(arch).reduced(**over)
        moe[name] = jax.tree.map(
            np.asarray, JMOE.init_moe(jax.random.PRNGKey(7), cfg))
        xs[name] = rng.normal(0, 1, shape + (cfg.d_model,)).astype(
            np.float32)
    return {"params": params, "tokens": tokens, "moe": moe, "x": xs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays)."""
    tmp = tmp_path_factory.mktemp("dist_moe")
    data_path = tmp / "data.pkl"
    with open(data_path, "wb") as f:
        pickle.dump(_data(), f)
    jax_proc = R.start_jax(_JAX_SCRIPT, json.dumps(
        [S.STEP_CASES, S.APPLY_CASES, str(data_path), str(tmp / "jax.npz")],
        default=list), devices=WORLD)
    try:
        ranks = R.run_ranks(functools.partial(
            S.moe_cases, data_path=str(data_path)), WORLD, tmp / "ranks")
    finally:
        R.finish_jax(jax_proc, "JAX_DIST_MOE_DONE")
    return dict(np.load(tmp / "jax.npz")), ranks


def _fields(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _rows(case: dict, rank: int) -> slice:
    """The batch rows the rank holds (the batch splits over the data
    axis: the reduced cases' batches divide it)."""
    d, m = case["mesh"]
    b = case["B"] // d
    return slice((rank // m) * b, (rank // m + 1) * b)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


# ------------------------------------------------ the steps against JAX
@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.STEP_CASES))
def test_steps_over_mesh_match_jax(runs, name, rank):
    jax_out, ranks = runs
    case = S.STEP_CASES[name]
    want, got = _fields(jax_out, name), _fields(ranks[rank], name)
    rows = _rows(case, rank)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    keys = [k for k in want if k != "tokens"]
    assert set(keys) == set(got) - {"tokens", "branches",
                                    "prefill/gathered"}, set(got)
    from repro_torch.configs import get_config

    cfg = get_config(case["arch"]).reduced(**case["over"])
    for k in keys:
        w = want[k][rows] if not k.startswith("cache/") else \
            S.cache_block(cfg, k[len("cache/"):], want[k], case["mesh"],
                          rank)
        _close(got[k], w, f"{name} rank {rank} {k}")


def test_steps_take_jax_branches(runs):
    """Every MoE layer call takes the reference's branch: the rule
    T_loc * nd < (E / tp) * (F / nd) at the reduced widths (D 64, F 128,
    E 4) on (2, 2) puts T_loc < 64 on the token path."""
    ranks = runs[1]
    L = 2
    want = {
        "mix_weight": ["expert/weight"] * L + ["expert/token"] * L * 3,
        "mix_token": ["expert/token"] * L * 7,
        "ds_weight": ["expert/weight"] * L + ["expert/token"] * L * 3,
        "ds_token": ["expert/token"] * L * 7,
        "mix_hidden": ["hidden/local-weights"] * L * 5,
        "dense_dp": [],
    }
    for r in range(WORLD):
        for name, w in want.items():
            assert json.loads(str(ranks[r][f"{name}/branches"])) == w, \
                (r, name)


@pytest.mark.parametrize("rank", range(WORLD))
def test_ranks_equal_the_emulation_bit_for_bit(runs, rank):
    ranks = runs[1]
    for name in S.STEP_CASES:
        want = _fields(ranks[0], f"emu{rank}/{name}")
        got = _fields(ranks[rank], name)
        got.pop("branches")
        assert set(got) == set(want), name
        for k in want:
            if k == "prefill/gathered":
                continue     # counted over a process group only
            assert np.array_equal(got[k], want[k]), (name, rank, k)


# ------------------------------------------------ apply_moe
@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.APPLY_CASES))
def test_apply_moe_over_mesh_matches_jax(runs, name, rank):
    jax_out, ranks = runs
    arch, over, shape, xs, dt = S.APPLY_CASES[name]
    want = _fields(jax_out, f"apply/{name}")
    got = _fields(ranks[rank], f"apply/{name}")
    rows = _rows(dict(mesh=shape, B=xs[0]), rank)
    w = want["out"][rows]
    if dt == "float32":
        _close(got["out"], w, f"{name} rank {rank}")
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert (np.abs(got["out"] - w) <= ulp).all(), \
            np.abs(got["out"] - w).max()
        # float32 accumulation, as JAX's psum: bf16 adds fail this
        assert (got["out"] != w).mean() <= 0.01
    assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["counts"].sum() == xs[0] * xs[1] * 2
    emu = _fields(ranks[0], f"apply_emu/{name}")
    assert np.array_equal(got["out"], emu["out"][rows])
    assert np.array_equal(got["aux"], emu["aux"])


def test_apply_moe_branches_and_gathers(runs):
    """The branch each case takes, and the bytes a rank gathers: the
    weight path the data peer's blocks of wg, wu, wd (E/tp x D x F/nd
    each, in the compute dtype) and the model peers' partials; the token
    path the data peer's tokens, ids and weights and the four partials
    of (nd T_loc, D)."""
    ranks = runs[1]
    D, Fd, K = 64, 128, 2
    for r in range(WORLD):
        b = {n: str(ranks[r][f"apply/{n}/branch"]) for n in S.APPLY_CASES}
        assert b == {"weight": "expert/weight", "token": "expert/token",
                     "hidden": "hidden/local-weights",
                     "shared": "expert/token",
                     "token_bf16": "expert/token",
                     "hidden_bf16": "hidden/local-weights"}
        g = {n: int(ranks[r][f"apply/{n}/gathered"]) for n in S.APPLY_CASES}
        assert g["weight"] == 2 * 3 * (2 * D * Fd // 2) * 4 + \
            2 * 80 * D * 4
        T = 16
        assert g["token"] == 2 * (T * D * 4 + T * K * 8 + T * K * 4) + \
            4 * 2 * T * D * 4
        assert g["hidden"] == 4 * 2 * T * D * 4


def test_refusals(runs):
    """Nothing of these refuses any more: a train step of the reduced
    mixtral with ``fsdp=True`` on a mesh whose batch axes span more than
    one place (FSDP of the dense weights, ``tests/test_torch_dist_fsdp.py``
    holds its steps), one with ``fsdp=False``, a dense family on a model
    axis of 2 and a recurrent family's prefill (their steps are
    ``tests/test_torch_dist_train.py``'s, ``tests/test_torch_dist_tp.py``'s
    and ``tests/test_torch_dist_rest.py``'s)."""
    for got in runs[1]:
        assert str(got["err/dense_tp"]) == ""
        assert str(got["err/serve_tp"]) == ""
        assert str(got["err/recurrent"]) == ""
        assert str(got["err/train"]) == ""
        assert str(got["err/train_fsdp"]) == ""


# ------------------------------------------------ the card (skipped here)
def _nccl_one(rank, world, group):
    """Mesh (1, 1) over a real NCCL group of one rank: the rules' local
    route, equal to the no-mesh prefill bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step

    cfg = get_config("mixtral-8x22b").reduced(fsdp=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=S.MESH_AXES)
    model, prefill = make_prefill_step(cfg, dev)
    _, on_mesh = make_prefill_step(cfg, dev, mesh=mesh)
    params = model.init(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    a = prefill(params, {"tokens": tokens})
    b = on_mesh(params, {"tokens": tokens})
    return {"logits": a[0].cpu().numpy(), "mesh_logits": b[0].cpu().numpy(),
            "k": a[1]["k"].cpu().numpy(), "mesh_k": b[1]["k"].cpu().numpy()}


@pytest.mark.cuda
def test_nccl_mesh_of_one_equals_no_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; NCCL has no CPU mode")
    out = R.run_ranks(_nccl_one, 1, tmp_path, backend="nccl")[0]
    assert np.array_equal(out["logits"], out["mesh_logits"])
    assert np.array_equal(out["k"], out["mesh_k"])
