"""Dense tensor parallelism and context-parallel attention over a (data x
model) ``DeviceMesh``: the port's serving steps (``launch.steps`` with
``mesh=``) on the blocks of ``launch.sharding.shard_params``, against the
JAX package's jitted ``make_prefill_step`` / ``make_serve_step`` under
``logical_axis_rules``, and the flash kernel's query offset.

One 4-rank gloo group (``spawn``, a ``file://`` store under ``tmp_path``,
one intra-op thread a rank) runs every case of
``torch_dist_slices.tp_cases`` once for the module, while JAX runs the same
weights (the JAX model's own, carried across with
``convert.model_params_from_numpy``) and inputs on 4 forced host devices
in one subprocess, with the parameters placed by its ``param_pspecs``.
Cases (``torch_dist_slices.TP_CASES``, reduced configs): qwen3-14b with
heads and kv heads both cut on mesh (1, 4) and (2, 2); kv heads that do
not divide 4 (head-sharded q, head_dim-sharded k and v); 6 heads on 4
places with a prompt of 8 (context parallel at prefill, then the head_dim
reduction at decode); whisper-medium on (1, 4) (encoder, self- and
cross-attention); internvl2-76b on (2, 2); command-r-35b on (1, 4) (tied
embeddings, the vocab-sharded head); mixtral-8x22b on (2, 2) (TP
attention beside the expert-parallel route) and on (4, 1) (the local MoE
route over a batch split 4 ways).  ``layers.apply_mlp`` under the rules
(``torch_dist_slices.MLP_CASES``): the SwiGLU and the biased gelu MLP in
bfloat16 and the SwiGLU in float32, its columns cut over the model axis,
against JAX's jitted ``apply_mlp`` on weights placed by ``param_pspecs``.

Tolerances.  Each rank's rows against JAX: float32 logits and its block of
the caches within 1e-5 (absolute and relative), tokens exactly; the
float32 MLP within 1e-5.  In bfloat16 (the MLP cases) within one bf16 ulp
of JAX's value and equal on at least 99% of the outputs: the port adds the
bf16 partials in rank order in float32 and rounds once, as XLA's CPU
all-reduce does (``tests/test_torch_dist_moe.py`` holds ``apply_moe`` so).
Each rank against the
in-process emulation of the mesh (rank 0's ``emulate_mesh``, the same
places in threads): bit for bit, logits, caches and tokens.  The flash
kernel's plain version with ``q_offset`` against JAX's ``attention``
(``repro/models/layers.py``) at the same explicit query positions: within
1e-5 in float32; with ``q_offset = 0``, exactly its output without the
argument.
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
from repro.models import layers as JL
from repro.models.shardctx import logical_axis_rules

steps, mlps, data_path, out_path = json.loads(sys.argv[1])
data = pickle.load(open(data_path, "rb"))
out = {}
for name, c in steps.items():
    cfg = get_config(c["arch"]).reduced(**c["over"])
    # Auto axes, as GSPMD partitions
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()).reshape(tuple(c["mesh"])),
        ("data", "model"))
    params = data["params"][name]
    params = jax.device_put(params, to_named(
        param_pspecs(cfg, params, mesh), mesh))
    _, pre = make_prefill_step(cfg, mesh)
    _, serve = make_serve_step(cfg, mesh)
    batch = {"tokens": jnp.asarray(data["tokens"][name])}
    if name in data["frames"]:
        batch["frames"] = jnp.asarray(data["frames"][name])
    logits, cache = jax.jit(lambda p, b: pre(
        p, dict(b, cache_seq=c["cache"])))(params, batch)
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
for name, (arch, over, shape, xs, dt) in mlps.items():
    cfg = get_config(arch).reduced(**over)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(tuple(shape)),
                             ("data", "model"))
    dtype = jnp.dtype(dt)
    p = data["mlp"][name]
    p = jax.device_put(p, to_named(param_pspecs(cfg, {"mlp": p}, mesh),
                                   mesh)["mlp"])

    def f(p, x):
        with logical_axis_rules(mesh, activation_rules(cfg, mesh,
                                                       x.shape[0])):
            return JL.apply_mlp(p, x.astype(dtype), cfg.mlp, dtype=dtype)

    y = jax.jit(f)(p, jnp.asarray(data["x"][name]))
    out[f"mlp/{name}"] = np.asarray(y.astype(jnp.float32))
np.savez(out_path, **out)
print("JAX_DIST_TP_DONE")
"""


def _data() -> dict:
    """The JAX models' weights (numpy) and the seeded inputs of every case.
    JAX is imported here, not at the top (the rank programs import this
    module's neighbour, never JAX)."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import layers as JL
    from repro.models.model import build_model as jax_build

    params, tokens, frames, mlp, xs = {}, {}, {}, {}, {}
    rng = np.random.default_rng(11)
    for name, c in S.TP_CASES.items():
        cfg = jax_config(c["arch"]).reduced(**c["over"])
        params[name] = jax.tree.map(
            np.asarray, jax.jit(jax_build(cfg).init)(jax.random.PRNGKey(4)))
        tokens[name] = rng.integers(0, cfg.vocab_size, (c["B"], c["S"]),
                                    dtype=np.int32)
        if cfg.family == "encdec":
            frames[name] = rng.normal(
                0, 1, (c["B"], cfg.encoder_seq, cfg.d_model)).astype(
                    np.float32)
    for name, (arch, over, _, shape, _) in S.MLP_CASES.items():
        cfg = jax_config(arch).reduced(**over)
        p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(9), cfg))
        for b in ("bi", "bd"):      # zeros at init: make them count
            if b in p:
                p[b] = rng.normal(0, 0.5, p[b].shape).astype(np.float32)
        mlp[name] = p
        xs[name] = rng.normal(0, 1, shape + (cfg.d_model,)).astype(
            np.float32)
    return {"params": params, "tokens": tokens, "frames": frames,
            "mlp": mlp, "x": xs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays)."""
    tmp = tmp_path_factory.mktemp("dist_tp")
    data_path = tmp / "data.pkl"
    with open(data_path, "wb") as f:
        pickle.dump(_data(), f)
    jax_proc = R.start_jax(_JAX_SCRIPT, json.dumps(
        [S.TP_CASES, S.MLP_CASES, str(data_path), str(tmp / "jax.npz")],
        default=list), devices=WORLD)
    try:
        ranks = R.run_ranks(functools.partial(
            S.tp_cases, data_path=str(data_path)), WORLD, tmp / "ranks")
    finally:
        R.finish_jax(jax_proc, "JAX_DIST_TP_DONE")
    return dict(np.load(tmp / "jax.npz")), ranks


def _fields(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _cfg(name):
    from repro_torch.configs import get_config

    c = S.TP_CASES[name]
    return get_config(c["arch"]).reduced(**c["over"])


# ------------------------------------------------ the steps against JAX
@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.TP_CASES))
def test_steps_over_mesh_match_jax(runs, name, rank):
    jax_out, ranks = runs
    case = S.TP_CASES[name]
    want, got = _fields(jax_out, name), _fields(ranks[rank], name)
    d, m = case["mesh"]
    b = case["B"] // d
    rows = slice((rank // m) * b, (rank // m + 1) * b)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    keys = [k for k in want if k != "tokens"]
    assert set(keys) == set(got) - {"tokens", "prefill/gathered"}, set(got)
    cfg = _cfg(name)
    for k in keys:
        if k.startswith("cache/"):
            w = S.cache_block(cfg, k[len("cache/"):], want[k], case["mesh"],
                              rank)
        else:
            w = want[k][rows]
        assert got[k].shape == w.shape, (name, k, got[k].shape, w.shape)
        np.testing.assert_allclose(got[k], w, atol=TOL, rtol=TOL,
                                   err_msg=f"{name} rank {rank} {k}")


@pytest.mark.parametrize("rank", range(WORLD))
def test_ranks_equal_the_emulation_bit_for_bit(runs, rank):
    ranks = runs[1]
    for name in S.TP_CASES:
        want = _fields(ranks[0], f"emu{rank}/{name}")
        got = _fields(ranks[rank], name)
        assert set(got) == set(want), name
        for k in want:
            if k == "prefill/gathered":
                continue     # counted over a process group only
            assert np.array_equal(got[k], want[k]), (name, rank, k)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(S.MLP_CASES))
def test_mlp_over_mesh_matches_jax(runs, name, rank):
    """The column-cut MLP's rows against JAX's, and against rank 0's
    emulation bit for bit."""
    jax_out, ranks = runs
    arch, over, shape, xs, dt = S.MLP_CASES[name]
    d, m = shape
    b = xs[0] // d
    w = jax_out[f"mlp/{name}"][(rank // m) * b:(rank // m + 1) * b]
    got = ranks[rank][f"mlp/{name}"]
    assert got.shape == w.shape
    if dt == "float32":
        np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert (np.abs(got - w) <= ulp).all(), np.abs(got - w).max()
        assert (got != w).mean() <= 0.01, (got != w).mean()
    assert np.array_equal(got, ranks[0][f"emu{rank}/mlp/{name}"])


def test_caches_hold_the_rank_block(runs):
    """The caches' shapes: the rank's kv heads where they divide the model
    axis, else its head_dim slice (``cache_specs``); whisper's cross
    cache too."""
    ranks = runs[1]
    L, hd = 2, 16
    want = {"heads_1x4": (L, 2, 12, 1, hd), "heads_2x2": (L, 1, 12, 1, hd),
            "mixed_1x4": (L, 2, 12, 2, hd // 4),
            "cp_1x4": (L, 2, 12, 2, hd // 4),
            "moe_2x2": (L, 1, 12, 1, hd), "moe_4x1": (L, 1, 12, 2, hd)}
    for r in range(WORLD):
        for name, shape in want.items():
            assert ranks[r][f"{name}/cache/k"].shape == shape, (r, name)
        assert ranks[r]["whisper_1x4/cache/cross/0"].shape == \
            (L, 2, 16, 2, hd // 4)


def test_prefill_gathers_what_the_layout_needs(runs):
    """The bytes a rank gathers in one prefill (``launch.mesh.GATHERED``):
    head-sharded attention and column-cut MLPs need the embedding's and
    each layer's two partial sums over the model axis ((B, S, D) from each
    of the 4 places) and the last position's logits (4 blocks of V/4);
    context parallel adds each layer's gathers of q, k and v to whole
    heads and of the output rows, and the head_dim reduction none at
    prefill."""
    ranks = runs[1]
    B, Sq, D, V, L, f4 = 2, 8, 64, 256, 2, 4
    sums = (1 + 2 * L) * 4 * B * Sq * D * f4
    logits = 4 * B * (V // 4) * f4
    for r in range(WORLD):
        assert int(ranks[r]["heads_1x4/prefill/gathered"]) == sums + logits
        H, KV, hd = 6, 2, 16
        cp = L * (B * Sq * (H + 2 * KV) * hd * f4      # q, k, v to whole
                  + B * Sq * H * hd * f4)              # the output rows
        assert int(ranks[r]["cp_1x4/prefill/gathered"]) == sums + logits + cp


# ------------------------------------------------ the flash query offset
def _jax_attention(q, k, v, q_pos, causal, window):
    import jax.numpy as jnp

    from repro.models.layers import attention

    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    out = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    q_positions=jnp.broadcast_to(jnp.asarray(q_pos), (B, Sq)),
                    k_positions=jnp.broadcast_to(jnp.arange(Skv), (B, Skv)),
                    causal=causal, window=window, impl="naive",
                    dtype=jnp.float32)
    return np.asarray(out)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 6)])
@pytest.mark.parametrize("offset", [0, 8, 16, 29])
def test_flash_q_offset_matches_jax_attention(causal, window, offset):
    """Rows of a query slice at ``q_offset`` against every key: the plain
    version (what the kernel is held to on the card) against JAX's
    attention at explicit positions offset .. offset + Sq - 1, GQA 6/2."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    rng = np.random.default_rng(offset)
    B, Sq, Skv, H, KV, D = 2, 8, 32, 6, 2, 16
    q = rng.normal(0, 1, (B, Sq, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, q_offset=offset).numpy()
    want = _jax_attention(q, k, v, np.arange(offset, offset + Sq), causal,
                          window)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_flash_q_offset_zero_is_the_default_and_slices_agree():
    """``q_offset=0`` gives the bits of the call without it (the wrapper on
    the CPU and the plain version), and a slice of the rows at its offset
    gives the whole prompt's rows."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 16, generator=g)
    k = torch.randn(2, 24, 2, 16, generator=g)
    v = torch.randn(2, 24, 2, 16, generator=g)
    for causal, window in ((True, None), (True, 7), (False, None)):
        base = flash_attention_ref(q, k, v, causal=causal, window=window)
        assert torch.equal(flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=0), base)
        assert torch.equal(flash_attention(
            q, k, v, causal=causal, window=window, q_offset=0), base)
        for r in range(3):
            part = flash_attention(q[:, 8 * r:8 * r + 8], k, v,
                                   causal=causal, window=window,
                                   q_offset=8 * r)
            torch.testing.assert_close(part, base[:, 8 * r:8 * r + 8],
                                       atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)


# ------------------------------------------------ the card (skipped here)
def _nccl_one(rank, world, group):
    """qwen3-14b reduced on mesh (1, 1) over a real NCCL group of one rank:
    equal to the no-mesh prefill and serve step bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import shard_params
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_config("qwen3-14b").reduced(dtype="bfloat16")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=S.MESH_AXES)
    model, prefill = make_prefill_step(cfg, dev)
    _, on_mesh = make_prefill_step(cfg, dev, mesh=mesh)
    _, serve0 = make_serve_step(cfg, dev)
    _, serve = make_serve_step(cfg, dev, mesh=mesh)
    params = model.init(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    a = prefill(params, {"tokens": tokens, "cache_seq": 20})
    b = on_mesh(shard_params(cfg, params, mesh),
                {"tokens": tokens, "cache_seq": 20})
    out = {"logits": a[0].float().cpu().numpy(),
           "mesh_logits": b[0].float().cpu().numpy(),
           "k": a[1]["k"].float().cpu().numpy(),
           "mesh_k": b[1]["k"].float().cpu().numpy()}
    # a decode step each, which writes slot 16 of its cache in place
    tok = torch.argmax(b[0], dim=-1).to(torch.int32)[:, None]
    for name, step, p, cache in (("", serve0, params, a[1]),
                                 ("mesh_", serve, shard_params(
                                     cfg, params, mesh), b[1])):
        nxt, lg, _ = step(p, {"token": tok, "pos": 16, "cache": cache})
        out[name + "next"] = nxt.cpu().numpy()
        out[name + "step_logits"] = lg.float().cpu().numpy()
    return out


@pytest.mark.cuda
def test_nccl_mesh_of_one_equals_no_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; NCCL has no CPU mode")
    out = R.run_ranks(_nccl_one, 1, tmp_path, backend="nccl")[0]
    assert np.array_equal(out["logits"], out["mesh_logits"])
    assert np.array_equal(out["k"], out["mesh_k"])
    assert np.array_equal(out["step_logits"], out["mesh_step_logits"])
    assert np.array_equal(out["next"], out["mesh_next"])
