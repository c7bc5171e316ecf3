"""MLA tensor parallelism, the recurrent families (xlstm, hybrid) and the
eval step over a (data x model) ``DeviceMesh``: the port's steps
(``launch.steps`` with ``mesh=``) on the blocks of
``launch.sharding.shard_params``, against the JAX package's jitted
``make_prefill_step``, ``make_serve_step`` and ``make_eval_step`` under
``logical_axis_rules``.

One 4-rank gloo group (``spawn``, a ``file://`` store under ``tmp_path``,
one intra-op thread a rank) runs every case of
``torch_dist_slices.rest_cases`` once for the module, while JAX runs the
same weights (the JAX model's own, carried across with
``convert.model_params_from_numpy``; the per-head and per-channel
vectors that init fills with one value perturbed, so that a wrong slice
shows) and inputs on 4 forced host devices in one subprocess, the
parameters placed by its ``param_pspecs`` and the states by its
``cache_specs``.  Cases (``torch_dist_slices.REST_CASES``, reduced
configs, float32): deepseek-v2-236b on (1, 4) and (2, 2), a prefill then
greedy decode (the heads of ``wq_b``, ``wk_b``, ``wv_b``, ``wo`` and the
latent cache cut over r and dr); xlstm-350m at 4 layers (one group, n_m =
3: the mLSTM ``m`` state whole on every place) and at ``xlstm_group=3``,
6 layers (n_m = 2, which divides the data axis of (2, 2): a place holds
one block's ``m`` for every row), each on (1, 4) and (2, 2); zamba2-2.7b
on (1, 4) and (2, 2) (the SSM heads, the conv windows of B and C cut on
N); the recurrent cases run the prefill step's loss over the global
batch, then decode from zero states over the prompt and greedy steps.
``make_eval_step(mesh=)`` on (2, 2) for a dense, an MoE (MLA) and a
recurrent config (``EVAL_CASES``).

Tolerances.  Each rank's rows of the logits, the losses and its block of
MLA's latent cache within 1e-5 of JAX (absolute and relative); its block
of each recurrent state within 1e-5 relative and 1e-5 of the leaf's
largest magnitude absolute (the note above ``_PERTURB`` says why); tokens and label counts
exactly.  Each rank against the in-process emulation of the mesh (rank
0's ``emulate_mesh``): bit for bit.
"""
import functools
import json
import pickle

import numpy as np
import pytest

import torch_dist_ranks as R
import torch_dist_slices as S

WORLD = 4
TOL = 1e-5

_JAX_SCRIPT = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.launch.sharding import cache_specs, param_pspecs, to_named
from repro.launch.steps import (make_eval_step, make_prefill_step,
                                make_serve_step)

cases, evals, data_path, out_path = json.loads(sys.argv[1])
data = pickle.load(open(data_path, "rb"))
out = {}


def labels_of(t):
    lab = np.roll(t, -1, axis=1).astype(np.int32)
    lab[:, -1] = -1
    return lab


def place(cfg, params, shape):
    # Auto axes, as GSPMD partitions
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(tuple(shape)),
                             ("data", "model"))
    return mesh, jax.device_put(params, to_named(
        param_pspecs(cfg, params, mesh), mesh))


for name, c in cases.items():
    cfg = get_config(c["arch"]).reduced(**c["over"])
    mesh, params = place(cfg, data["params"][name], c["mesh"])
    model, pre = make_prefill_step(cfg, mesh)
    _, serve = make_serve_step(cfg, mesh)
    jserve = jax.jit(serve)
    tokens = data["tokens"][name]
    toks = []
    if cfg.family in ("xlstm", "hybrid"):
        loss = jax.jit(pre)(params, {"tokens": jnp.asarray(tokens),
                                     "labels": jnp.asarray(labels_of(tokens))})
        out[f"{name}/loss"] = np.asarray(loss, np.float32)
        cache = model.init_cache(c["B"], c["cache"])
        cache = jax.device_put(cache, to_named(cache_specs(cfg, cache, mesh),
                                               mesh))
        tok = None
        for i in range(c["S"] + c["steps"]):
            feed = jnp.asarray(tokens[:, i]) if i < c["S"] else tok
            tok, lg, cache = jserve(params, {"token": feed[:, None],
                                             "pos": jnp.int32(i),
                                             "cache": cache})
            out[f"{name}/step{i}/logits"] = np.asarray(lg, np.float32)
            toks.append(np.asarray(tok))
    else:
        logits, cache = jax.jit(lambda p, b: pre(
            p, dict(b, cache_seq=c["cache"])))(
                params, {"tokens": jnp.asarray(tokens)})
        out[f"{name}/prefill/logits"] = np.asarray(logits, np.float32)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
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
for name, (arch, over, shape, _) in evals.items():
    cfg = get_config(arch).reduced(**over)
    mesh, params = place(cfg, data["eval_params"][name], shape)
    _, step = make_eval_step(cfg, mesh)
    t = data["eval_tokens"][name]
    m = jax.jit(step)(params, {"tokens": jnp.asarray(t),
                               "labels": jnp.asarray(labels_of(t))})
    for k, v in m.items():
        out[f"eval/{name}/{k}"] = np.asarray(v, np.float32)
np.savez(out_path, **out)
print("JAX_DIST_REST_DONE")
"""

# Why a recurrent state is held to its leaf's largest magnitude: over the
# S + steps = 10 decode steps of these cases the port WITHOUT a mesh
# already parts from JAX by up to 2.8e-5 on single elements of the
# mLSTM C (|C| up to about 5) and 2.3e-5 on the hybrid's attention cache,
# past an element-wise 1e-5; the logits stay within 2.4e-7.  The states
# accumulate every step's last-bit differences; the mesh adds none
# (every rank equals the emulation bit for bit).

# vectors that init fills with one value (ones, zeros, a constant): drawn
# here so that a place reading another place's slice of them shows
_PERTURB = {"A_log": (0.0, 0.5), "dt_bias": (0.0, 0.5),
            "D_skip": (1.0, 0.5), "out_norm": (1.0, 0.3),
            "b_i": (0.0, 0.5), "b_f": (3.0, 0.5), "q_a_norm": (1.0, 0.2),
            "kv_a_norm": (1.0, 0.2)}


def _jax_params(arch, over, rng):
    import jax

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model as jax_build

    cfg = jax_config(arch).reduced(**over)
    params = jax.tree.map(np.asarray, jax.jit(jax_build(cfg).init)(
        jax.random.PRNGKey(4)))

    def one(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name not in _PERTURB:
            return leaf
        mu, sd = _PERTURB[name]
        return (mu + sd * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    return cfg, jax.tree_util.tree_map_with_path(one, params)


def _data() -> dict:
    """The JAX models' weights (numpy) and the seeded tokens of every case.
    JAX is imported here, not at the top (the rank programs import this
    module's neighbour, never JAX)."""
    rng = np.random.default_rng(13)
    params, tokens, eparams, etokens = {}, {}, {}, {}
    for name, c in S.REST_CASES.items():
        cfg, params[name] = _jax_params(c["arch"], c["over"], rng)
        tokens[name] = rng.integers(0, cfg.vocab_size, (c["B"], c["S"]),
                                    dtype=np.int32)
    for name, (arch, over, _, (B, Sq)) in S.EVAL_CASES.items():
        cfg, eparams[name] = _jax_params(arch, over, rng)
        etokens[name] = rng.integers(0, cfg.vocab_size, (B, Sq),
                                     dtype=np.int32)
    return {"params": params, "tokens": tokens, "eval_params": eparams,
            "eval_tokens": etokens}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays)."""
    tmp = tmp_path_factory.mktemp("dist_rest")
    data_path = tmp / "data.pkl"
    with open(data_path, "wb") as f:
        pickle.dump(_data(), f)
    jax_proc = R.start_jax(_JAX_SCRIPT, json.dumps(
        [S.REST_CASES, S.EVAL_CASES, str(data_path), str(tmp / "jax.npz")],
        default=list), devices=WORLD)
    try:
        ranks = R.run_ranks(functools.partial(
            S.rest_cases, data_path=str(data_path)), WORLD, tmp / "ranks")
    finally:
        R.finish_jax(jax_proc, "JAX_DIST_REST_DONE")
    return dict(np.load(tmp / "jax.npz")), ranks


def _fields(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _cfg(name):
    from repro_torch.configs import get_config

    c = S.REST_CASES[name]
    return get_config(c["arch"]).reduced(**c["over"])


_COUNTS = ("gathered", "loss_gathered", "decode_gathered",
           "prefill/gathered")


# ------------------------------------------------ the steps against JAX
@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.REST_CASES))
def test_steps_over_mesh_match_jax(runs, name, rank):
    """The rank's rows of every logit, the global loss, its block of the
    final caches or states (``cache_specs``' block of JAX's), and the
    global tokens, against JAX's."""
    jax_out, ranks = runs
    case = S.REST_CASES[name]
    want, got = _fields(jax_out, name), _fields(ranks[rank], name)
    d, m = case["mesh"]
    b = case["B"] // d
    rows = slice((rank // m) * b, (rank // m + 1) * b)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert set(want) == {k for k in got if not k.endswith(_COUNTS)}, \
        set(got) ^ set(want)
    cfg = _cfg(name)
    for k in want:
        if k == "tokens":
            continue
        if k.startswith("cache/"):
            w = S.cache_block(cfg, k[len("cache/"):], want[k], case["mesh"],
                              rank)
        elif k == "loss":
            w = want[k]
        else:
            w = want[k][rows]
        assert got[k].shape == w.shape, (name, k, got[k].shape, w.shape)
        atol = TOL
        if k.startswith("cache/") and case["arch"] != "deepseek-v2-236b":
            # a recurrent state after S + steps steps: within 1e-5 of its
            # leaf's largest magnitude (the note above _PERTURB)
            atol = TOL * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=TOL,
                                   err_msg=f"{name} rank {rank} {k}")


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.EVAL_CASES))
def test_eval_over_mesh_matches_jax(runs, name, rank):
    """``make_eval_step(mesh=)``: the global batch's loss within 1e-5 and
    its label count exactly, the same bits on every rank."""
    jax_out, ranks = runs
    got = _fields(ranks[rank], f"eval/{name}")
    want = _fields(jax_out, f"eval/{name}")
    assert set(got) == set(want) == {"loss", "tokens"}
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    assert float(got["tokens"]) == float(want["tokens"])
    assert np.array_equal(got["loss"], ranks[0][f"eval/{name}/loss"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_ranks_equal_the_emulation_bit_for_bit(runs, rank):
    ranks = runs[1]
    names = list(S.REST_CASES) + [f"eval/{n}" for n in S.EVAL_CASES]
    for name in names:
        want = _fields(ranks[0], f"emu{rank}/{name}")
        got = _fields(ranks[rank], name)
        assert set(got) == set(want) and want, name
        for k in want:
            if k.endswith(_COUNTS):
                continue     # counted over a process group only
            assert np.array_equal(got[k], want[k]), (name, rank, k)


def test_states_hold_the_rank_block(runs):
    """The blocks a rank keeps: MLA's latent cache cut over r and dr; the
    mLSTM C by the value dim, n and the sLSTM states by the batch rows,
    the m state whole where n_m = 3 does not divide the data axis and cut
    by blocks where n_m = 2 does (every row of the global batch either
    way); Mamba2's SSM state by heads and its conv windows by channels
    (x's H P and B's and C's N)."""
    ranks = runs[1]
    want = {
        "mla_1x4": {"c_kv": (2, 2, 12, 8), "k_rope": (2, 2, 12, 2)},
        "mla_2x2": {"c_kv": (2, 1, 12, 16), "k_rope": (2, 1, 12, 4)},
        "xlstm_1x4": {"m/0": (1, 3, 4, 4, 4, 16), "m/1": (1, 3, 4, 4, 16),
                      "m/2": (1, 3, 4, 4), "s/0": (1, 4, 4, 16)},
        "xlstm_2x2": {"m/0": (1, 3, 2, 4, 8, 16), "m/1": (1, 3, 2, 4, 16),
                      "m/2": (1, 3, 4, 4), "s/3": (1, 2, 4, 16)},
        "xlstm_g3_2x2": {"m/0": (2, 2, 2, 4, 8, 16), "m/2": (2, 1, 4, 4),
                         "s/1": (2, 2, 4, 16)},
        "hybrid_1x4": {"ssm": (2, 2, 2, 2, 16, 16),
                       "conv/x": (2, 2, 2, 4, 32), "conv/B": (2, 2, 2, 4, 4),
                       "conv/C": (2, 2, 2, 4, 4),
                       "attn/k": (2, 2, 10, 2, 4)},
        "hybrid_2x2": {"ssm": (2, 2, 2, 4, 16, 16),
                       "conv/x": (2, 2, 2, 4, 64), "conv/B": (2, 2, 2, 4, 8),
                       "attn/k": (2, 2, 10, 1, 16)},
    }
    for r in range(WORLD):
        for name, leaves in want.items():
            for leaf, shape in leaves.items():
                got = ranks[r][f"{name}/cache/{leaf}"].shape
                assert got == shape, (r, name, leaf, got, shape)


def test_gathered_bytes(runs):
    """A decode step of MLA over a cut latent gathers the cache's written
    prefix back to whole (``layers._mla_window``): each step gathers
    L x B_loc x (r + dr) float32 more than the one before, one slot more
    of every layer's latent; the prefill gathers none of it.  A recurrent
    step gathers the same bytes at every position (states, not a growing
    cache)."""
    ranks = runs[1]
    L, r, dr = 2, 32, 8
    for name, b_loc in (("mla_1x4", 2), ("mla_2x2", 1)):
        for got in ranks:
            steps = got[f"{name}/decode_gathered"]
            assert len(steps) == S.REST_CASES[name]["steps"]
            assert (np.diff(steps) == L * b_loc * (r + dr) * 4).all(), steps
    for name, case in S.REST_CASES.items():
        if case["arch"] == "deepseek-v2-236b":
            continue
        for got in ranks:
            per = {int(got[f"{name}/step{i}/gathered"])
                   for i in range(case["S"] + case["steps"])}
            assert len(per) == 1 and per.pop() > 0, (name, per)
