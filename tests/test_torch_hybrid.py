"""The port's Mamba2 hybrid family (zamba2-2.7b) against the JAX package's.

The JAX package's reduced zamba2-2.7b (float32: 2 groups of 2 Mamba2
blocks and the one weight-tied attention layer, d_model 64, 8 SSM heads of
16, state 16, conv 4; attention 4 heads of 16 over 2 KV heads) goes
through both packages with the same weights: the JAX model's own, carried
across by ``convert.model_params_from_numpy`` (shared checks in
``torch_lm_family.py``).  Inputs are made from a seed with numpy.
Tolerances: 1e-5 for the blocks, the loss, the gradients and a train step
(float32, sums in another order); 1e-4 for 8 decode steps' logits and
every state leaf (relative L2); greedy tokens exactly.  The gradients and the train step
are held within 4 times JAX's own spread where that exceeds 1e-5, and the
bfloat16 cases within a fraction of JAX's own bf16 distance from float32:
a quarter for the blocks, half for the reduced model (see
``torch_lm_family.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_family as FAM
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import ssm as TS
from repro_torch.models.model import build_model

ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def pair():
    return FAM.make_pair(ARCH)


def test_config_equals_jax_field_for_field():
    FAM.config_equal(ARCH)
    cfg, red = get_config(ARCH), get_config(ARCH).reduced()
    assert (cfg.family, cfg.num_layers, cfg.hybrid_group, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.ssm_state,
            cfg.ssm_headdim, TS.ssm_dims(cfg)) == (
        "hybrid", 54, 6, 2560, 32, 32, 80, 64, 64, (5120, 80, 64, 64))
    assert (red.num_layers, red.hybrid_group, red.d_model, red.ssm_state,
            red.ssm_headdim, red.dtype) == (6, 3, 64, 16, 16, "float32")


def test_convert_keeps_every_leaf_and_the_float32_leaves(pair):
    """{"mamba": (G, n_m, ...), "shared_attn": one layer} becomes per-group
    lists and one layer dict; at bf16 compute w_dt, dt_bias, A_log,
    D_skip and out_norm stay float32."""
    bf = FAM.convert_keeps_every_leaf(pair)
    tp = pair[3]
    assert len(tp["stack"]["mamba"]) == 2
    assert all(len(g) == 2 for g in tp["stack"]["mamba"])
    assert set(tp["stack"]["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}
    cell = bf["stack"]["mamba"][1][0]["cell"]
    assert FAM.bf16_leaves(cell) == {"wz", "wx", "wB", "wC", "wo", "conv_x",
                                     "conv_B", "conv_C"}


# ------------------------------------------------------------------ blocks
def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(0, 1, shape)).astype(
        np.float32)


def test_causal_conv_and_segsum():
    x, w = _x((2, 11, 6), 0), _x((4, 6), 1)
    FAM.close(TS._causal_conv(FAM.t(x), FAM.t(w)),
              JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    a = -np.abs(_x((2, 3, 9), 2))
    got, want = TS._segsum(FAM.t(a)), np.asarray(JS._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    FAM.close(got.numpy()[fin], want[fin])


def test_ssd_chunked_and_its_final_state():
    """L = 32 in 4 chunks of 8: y and the final state."""
    B, L, H, P, N = 2, 32, 3, 4, 5
    x, B_, C_ = _x((B, L, H, P), 3), _x((B, L, N), 4), _x((B, L, N), 5)
    log_a = -np.abs(_x((B, L, H), 6, 0.3))
    want = jax.jit(lambda *a: JS.ssd_chunked(*a, 8))(
        *map(jnp.asarray, (x, log_a, B_, C_)))
    got = TS.ssd_chunked(*map(FAM.t, (x, log_a, B_, C_)), 8)
    FAM.close(got[0], want[0])
    FAM.close(got[1], want[1])


def _cell(seed=0):
    """A reduced Mamba2 cell from JAX's init, its vectors drawn away from
    their constants so that a missing one shows, as JAX and port float32
    tensors."""
    cfg = FAM.configs(ARCH)[0]
    p = jax.tree.map(np.asarray, jax.jit(lambda k: JS.init_mamba2(k, cfg))(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("dt_bias", "A_log", "D_skip", "out_norm"):
        p[k] = p[k] + rng.normal(0, 0.3, p[k].shape).astype(np.float32)
    return cfg, p, {k: FAM.t(v) for k, v in p.items()}


@pytest.mark.parametrize("L,chunk", [(16, 8), (48, 32)],
                         ids=["two-chunks", "halved-to-16"])
def test_mamba2_block_parallel(L, chunk):
    """The chunked form at L = 16 (chunk 8) and at L = 48, where a chunk
    of 32 is halved to 16: the output and the final state."""
    cfg, jp, tp = _cell()
    x = _x((2, L, cfg.d_model), 7)
    want = jax.jit(lambda p, x: JS.mamba2_block(
        p, x, cfg, chunk=chunk, dtype=jnp.float32))(jp, jnp.asarray(x))
    got = TS.mamba2_block(tp, FAM.t(x), cfg, chunk=chunk, dtype=torch.float32)
    FAM.close(got[0], want[0])
    FAM.close(got[1], want[1])
    assert got[2] is None and want[2] is None


def test_mamba2_block_decode_with_the_conv_window():
    """One token from a given SSM state and conv window: the output, the
    new state and the rolled window."""
    cfg, jp, tp = _cell(1)
    _, H, P, N = TS.ssm_dims(cfg)
    ks, B = cfg.ssm_conv, 2
    st = _x((B, H, P, N), 8)
    conv = {"x": _x((B, ks, H * P), 9), "B": _x((B, ks, N), 10),
            "C": _x((B, ks, N), 11)}
    x = _x((B, 1, cfg.d_model), 12)
    want = jax.jit(lambda p, x, s, c: JS.mamba2_block(
        p, x, cfg, state=s, conv_cache=c, dtype=jnp.float32))(
            jp, jnp.asarray(x), jnp.asarray(st),
            {k: jnp.asarray(v) for k, v in conv.items()})
    got = TS.mamba2_block(tp, FAM.t(x), cfg, state=FAM.t(st),
                          conv_cache={k: FAM.t(v) for k, v in conv.items()},
                          dtype=torch.float32)
    FAM.close(got[0], want[0])
    FAM.close(got[1], want[1])
    for k in conv:
        FAM.close(got[2][k], want[2][k])
    np.testing.assert_array_equal(got[2]["x"][:, :-1].numpy(),
                                  conv["x"][:, 1:])


@pytest.mark.parametrize("L", [16, 1], ids=["parallel", "decode"])
def test_bf16_blocks_round_as_jax(L):
    """At bf16 ``mamba2_block``'s chunked form (L = 16, chunk 8) and its
    decode step from a given bf16 SSM state and conv window: the output
    and the returned state and window within a quarter of JAX's own bf16
    distance from its float32 run (``bf16_block_matches``): the state is
    held and returned in the compute dtype, as the reference holds it."""
    cfg, jp, tp = _cell(2)
    _, H, P, N = TS.ssm_dims(cfg)
    ks, B = cfg.ssm_conv, 2
    kw, st = ({"chunk": 8}, {}) if L > 1 else ({}, {
        "state": _x((B, H, P, N), 16),
        "conv_cache": {"x": _x((B, ks, H * P), 17), "B": _x((B, ks, N), 18),
                       "C": _x((B, ks, N), 19)}})

    def jfn(p, x, dtype, **s):
        s = jax.tree.map(lambda a: jnp.asarray(a, dtype), s)
        return jax.jit(lambda p, x, s: JS.mamba2_block(
            p, x, cfg, dtype=dtype, **kw, **s))(p, x, s)

    def tfn(p, x, dtype, **s):
        s = {k: ({c: FAM.t(a).to(dtype) for c, a in v.items()}
                 if isinstance(v, dict) else FAM.t(v).to(dtype))
             for k, v in s.items()}
        return TS.mamba2_block(p, x, cfg, dtype=dtype, **kw, **s)

    rows = FAM.bf16_block_matches(jfn, tfn, jp, tp,
                                  _x((B, L, cfg.d_model), 20), **st)
    assert len(rows) == (2 if L > 1 else 5)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def grads(pair):
    return FAM.loss_and_grads(pair, FAM.batch(pair[2].cfg, seed=7),
                              spread=True)


def test_loss_and_grads_match_jax(grads):
    FAM.grads_match(grads)
    assert float(grads["tmet"]["tokens"]) == 61.0


def test_loss_and_grads_chunked_under_remat(pair):
    """The SSD over 4 chunks of 4 (attn_chunk 4; ``_segsum``'s -inf above
    the diagonal in the backward pass) with remat "full": the loss and
    every gradient leaf against JAX's, all finite."""
    pair = FAM.make_pair(ARCH, jp=pair[1], attn_chunk=4, remat="full")
    r = FAM.loss_and_grads(pair, FAM.batch(pair[2].cfg, seed=8), spread=True)
    assert all(bool(torch.isfinite(g).all())
               for g in FAM.tree_leaves(r["tg"]))
    FAM.grads_match(r)


def test_decode_logits_and_states_over_8_steps(pair):
    """Each group's shared attention writes its own KV slice."""
    st = FAM.decode_8_steps(pair)
    G, n_m, B, H, P, N = 2, 2, 2, 8, 16, 16
    assert tuple(st["ssm"].shape) == (G, n_m, B, H, P, N)
    assert tuple(st["attn"]["k"].shape) == (G, B, 10, 2, 16)
    k = st["attn"]["k"]
    assert bool(k[:, :, :8].any(-1).all()) and not bool(k[:, :, 8:].any())
    assert not torch.equal(k[0], k[1])


def test_decode_matches_the_parallel_form(pair):
    """Teacher forcing: 8 decode steps' logits against the parallel form's
    (``_backbone`` and ``_logits``) over the same tokens."""
    _, _, tm, tp = pair
    toks = FAM.prompt(tm.cfg, 2, 8, 9)
    with torch.no_grad():
        x = tm._embed(tp, FAM.t(toks))
        pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
        x, _, aux = tm._backbone(tp, x, pos)
        want = tm._logits(tp, x)
    assert float(aux) == 0.0
    cache = tm.init_cache(2, 8)
    for s in range(8):
        got, cache = tm.decode_step(tp, {"token": FAM.t(toks[:, s:s + 1]),
                                         "pos": s, "cache": cache})
        FAM.close(got, want[:, s], FAM.DECODE_TOL)


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_tokens_match_jax_decode_loop(pair, prefetch):
    FAM.engine_tokens(pair, prefetch)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step(mb):
    FAM.train_step_matches(ARCH, mb, spread=True)


def test_prefill_refuses_and_the_prefill_step_returns_the_loss(pair):
    jm, jp, tm, tp = pair
    b = FAM.batch(tm.cfg, B=2, seed=10)
    with pytest.raises(NotImplementedError, match="recurrent families"):
        jm.prefill(jp, {"tokens": jnp.asarray(b["tokens"])})
    with pytest.raises(NotImplementedError, match="recurrent families"):
        tm.prefill(tp, {"tokens": FAM.t(b["tokens"])})
    want = jax_make_prefill_step(jm.cfg)[1](
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_prefill_step(tm.cfg, "cpu")[1](tp, b)
    assert got.shape == () and FAM.rel(got, want) <= FAM.TOL


def test_bf16_decode_and_loss(pair):
    """bfloat16 compute, the SSM state and conv window held in bf16 as the
    reference holds them: the loss, 8 decode steps' logits and every state
    leaf (``bf16_matches``)."""
    st = FAM.bf16_matches(ARCH, pair[1])
    assert st["ssm"].dtype == st["conv"]["x"].dtype == \
        st["attn"]["k"].dtype == torch.bfloat16


def test_serve_and_train_mains_on_the_cpu(tmp_path, capsys):
    out = S.main(["--arch", ARCH, "--reduce", "--device", "cpu"])
    assert out.shape == (4, 16) and (out >= 0).all() and (out < 256).all()
    hist = T.main(["--arch", ARCH, "--reduce", "--steps", "2", "--batch",
                   "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
                   "--log-every", "1"], device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert f"arch={ARCH}" in capsys.readouterr().out


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_cuda_decode_matches_the_cpu(pair):
    """On the card 8 decode steps' logits agree with the CPU's within 1e-4
    (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, tm, tp = pair
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gm = build_model(tm.cfg, dev)
    gp = FAM.tree_map(lambda x: x.to(dev), tp)
    toks = FAM.prompt(tm.cfg, 2, 8, 2)
    cc, gc = tm.init_cache(2, 8), gm.init_cache(2, 8)
    for s in range(8):
        tok = FAM.t(toks[:, s:s + 1])
        want, cc = tm.decode_step(tp, {"token": tok, "pos": s, "cache": cc})
        got, gc = gm.decode_step(gp, {"token": tok.to(dev), "pos": s,
                                      "cache": gc})
        FAM.close(got.cpu(), want, FAM.DECODE_TOL)
