"""The port's xLSTM family (xlstm-350m) against the JAX package's.

The JAX package's reduced xlstm-350m (float32: 2 groups of 3 mLSTM blocks
and 1 sLSTM block, d_model 64, 4 heads of 16) goes through both packages
with the same weights: the JAX model's own, carried across by
``convert.model_params_from_numpy`` (shared checks in
``torch_lm_family.py``).  Inputs are made from a seed with numpy.
Tolerances: 1e-5 for the blocks, the loss, the gradients and a train step
(float32, sums in another order); 1e-4 for 8 decode steps' logits and
every state leaf (relative L2); greedy tokens exactly.  The gradients and the train
step are held within 4 times JAX's own spread where that exceeds 1e-5,
and the bfloat16 cases within a fraction of JAX's own bf16 distance
from float32: a quarter for the blocks, half for the reduced model (see
``torch_lm_family.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_family as FAM
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import xlstm as JX
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import xlstm as TX
from repro_torch.models.model import build_model

ARCH = "xlstm-350m"


@pytest.fixture(scope="module")
def pair():
    return FAM.make_pair(ARCH)


def test_config_equals_jax_field_for_field():
    FAM.config_equal(ARCH)
    from repro_torch.configs import get_config
    cfg, red = get_config(ARCH), get_config(ARCH).reduced()
    assert (cfg.family, cfg.num_layers, cfg.xlstm_group, cfg.d_model,
            cfg.num_heads, cfg.head_dim, cfg.padded_vocab,
            cfg.attn_chunk) == ("xlstm", 24, 8, 1024, 4, 256, 50432, 1024)
    assert (red.num_layers, red.xlstm_group, red.d_model, red.num_heads,
            red.head_dim, red.dtype) == (8, 4, 64, 4, 16, "float32")


def test_convert_keeps_every_leaf_and_the_float32_cells(pair):
    """The reference's stacked {"mlstm": (G, n_m, ...), "slstm": (G, ...)}
    becomes per-group lists; at bf16 compute only the projections the
    reference casts are stored in bf16, the gates, the sLSTM's input and
    recurrent projections and the norms stay float32."""
    bf = FAM.convert_keeps_every_leaf(pair)
    tp = pair[3]
    assert len(tp["stack"]["mlstm"]) == 2
    assert all(len(g) == 3 for g in tp["stack"]["mlstm"])
    assert len(tp["stack"]["slstm"]) == 2
    m, s = bf["stack"]["mlstm"][1][2]["cell"], bf["stack"]["slstm"][0]["cell"]
    assert FAM.bf16_leaves(m) == {"wq", "wk", "wv", "wz", "wo"}
    assert FAM.bf16_leaves(s) == {"wo"}
    assert m["w_i"].dtype == m["w_f"].dtype == s["r_z"].dtype == \
        s["w_o"].dtype == torch.float32


# ------------------------------------------------------------------ blocks
def _cell(kind, seed=0, bias=True):
    """A reduced cell's parameters from JAX's init (biases and norm scales
    drawn away from their constants so that a missing one shows), as JAX
    and as port float32 tensors."""
    cfg = FAM.configs(ARCH)[0]
    init = JX.init_mlstm if kind == "m" else JX.init_slstm
    p = jax.tree.map(np.asarray, jax.jit(lambda k: init(k, cfg))(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    if bias:
        p = {k: (v + rng.normal(0, 0.3, v.shape).astype(np.float32)
                 if k.startswith("b_") or k == "out_norm" else v)
             for k, v in p.items()}
    return cfg, p, {k: FAM.t(v) for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("L,chunk", [(12, 4), (10, 4)],
                         ids=["three-chunks", "one-chunk"])
def test_mlstm_parallel_form(L, chunk):
    """The parallel form at L = 12, chunk 4 (three query chunks) and at
    L = 10, chunk 4 (not a multiple: one L x L chunk)."""
    cfg, jp, tp = _cell("m")
    x = _x((2, L, cfg.d_model), 1)
    want, wst = jax.jit(lambda p, x: JX.mlstm_block(
        p, x, cfg, chunk=chunk, dtype=jnp.float32))(jp, jnp.asarray(x))
    got, gst = TX.mlstm_block(tp, FAM.t(x), cfg, chunk=chunk,
                              dtype=torch.float32)
    assert wst is None and gst is None
    FAM.close(got, want)


def test_mlstm_chunks_under_autograd_match_one_chunk():
    """Under autograd each chunk is recomputed in the backward pass: the
    three-chunk output and its input gradient equal the one-chunk form's
    within 1e-5 (the same function chunked)."""
    cfg, _, tp = _cell("m")
    x = FAM.t(_x((2, 12, cfg.d_model), 2)).requires_grad_(True)
    outs = []
    for chunk in (4, 12):
        x.grad = None
        y, _ = TX.mlstm_block(tp, x, cfg, chunk=chunk, dtype=torch.float32)
        (y * y).sum().backward()
        outs.append((y.detach(), x.grad.clone()))
    FAM.close(outs[0][0], outs[1][0])
    FAM.close(outs[0][1], outs[1][1])


def test_mlstm_recurrent_step_from_a_state():
    cfg, jp, tp = _cell("m")
    B, H, dh = 2, cfg.num_heads, cfg.head_dim
    rng = np.random.default_rng(3)
    st = (rng.normal(0, 1, (B, H, dh, dh)).astype(np.float32),
          rng.normal(0, 1, (B, H, dh)).astype(np.float32),
          rng.normal(0, 1, (B, H)).astype(np.float32))
    x = _x((B, 1, cfg.d_model), 4)
    want, wst = jax.jit(lambda p, x, s: JX.mlstm_block(
        p, x, cfg, state=s, dtype=jnp.float32))(
            jp, jnp.asarray(x), tuple(map(jnp.asarray, st)))
    got, gst = TX.mlstm_block(tp, FAM.t(x), cfg,
                              state=tuple(map(FAM.t, st)),
                              dtype=torch.float32)
    FAM.close(got, want)
    for g, w in zip(gst, wst):
        FAM.close(g, w)


@pytest.mark.parametrize("given", [False, True], ids=["zero", "given"])
def test_slstm_block(given):
    """The scan over L = 6 from zeros (n at ones) and from a given state:
    the output and the final (c, n, h, m)."""
    cfg, jp, tp = _cell("s")
    B, H, dh = 2, cfg.num_heads, cfg.head_dim
    x = _x((B, 6, cfg.d_model), 5)
    st = None
    if given:
        rng = np.random.default_rng(6)
        st = (rng.normal(0, 1, (B, H, dh)).astype(np.float32),
              rng.uniform(0.5, 2, (B, H, dh)).astype(np.float32),
              rng.normal(0, 1, (B, H, dh)).astype(np.float32),
              rng.normal(0, 1, (B, H, dh)).astype(np.float32))
    want, wst = jax.jit(lambda p, x, s: JX.slstm_block(
        p, x, cfg, dtype=jnp.float32, state=s))(
            jp, jnp.asarray(x),
            None if st is None else tuple(map(jnp.asarray, st)))
    got, gst = TX.slstm_block(
        tp, FAM.t(x), cfg, dtype=torch.float32,
        state=None if st is None else tuple(map(FAM.t, st)))
    FAM.close(got, want)
    for g, w in zip(gst, wst):
        FAM.close(g, w)


@pytest.mark.parametrize("form", ["parallel", "step", "slstm"])
def test_bf16_blocks_round_as_jax(form):
    """At bf16 the mLSTM's parallel form (L = 12, chunk 4), its recurrent
    step from a given state, and the sLSTM over L = 6: the output and
    every returned state within a quarter of JAX's own bf16 distance from
    its float32 run (``bf16_block_matches``; a port in float32 would sit
    at the whole distance)."""
    kind = "s" if form == "slstm" else "m"
    cfg, jp, tp = _cell(kind)
    B, H, dh = 2, cfg.num_heads, cfg.head_dim
    L, kw = {"parallel": (12, {"chunk": 4}), "step": (1, {}),
             "slstm": (6, {})}[form]
    state = {}
    if form == "step":
        rng = np.random.default_rng(13)
        state = {"state": (rng.normal(0, 1, (B, H, dh, dh)),
                           rng.normal(0, 1, (B, H, dh)),
                           rng.normal(0, 1, (B, H)))}
        state = {"state": tuple(a.astype(np.float32)
                                for a in state["state"])}
    jblock = JX.slstm_block if kind == "s" else JX.mlstm_block
    tblock = TX.slstm_block if kind == "s" else TX.mlstm_block

    def jfn(p, x, dtype, **st):
        return jax.jit(lambda p, x, st: jblock(p, x, cfg, dtype=dtype,
                                               **kw, **st))(p, x, st)

    def tfn(p, x, dtype, **st):
        return tblock(p, x, cfg, dtype=dtype, **kw, **st)

    FAM.bf16_block_matches(jfn, tfn, jp, tp, _x((B, L, cfg.d_model), 14),
                           **state)


def test_silu_stepwise_rounds_as_jax():
    """``silu_stepwise`` equals ``jax.nn.silu`` bit for bit at bf16 (JAX's
    sigmoid rounds each operation of 1 / (1 + exp(-x)); inputs stay out
    of -87.3 > x > -88.7, where that sigmoid is subnormal and XLA flushes
    it to 0, and exp(-x) overflows at -100 and -200), where
    ``F.silu`` parts from it by an ulp in many entries; its gradient is
    JAX's within 1e-6 at float32 and finite where exp(-x) overflows."""
    from repro_torch.models.layers import silu_stepwise

    x = np.concatenate([_x((4096,), 15) * 4,
                        np.float32([-200, -100, -80, 0, 88.5, 100])])
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.silu)(xb), np.float32)
    tb = FAM.t(np.asarray(xb, np.float32)).bfloat16()
    np.testing.assert_array_equal(silu_stepwise(tb).float().numpy(), want)
    assert (torch.nn.functional.silu(tb).float().numpy() != want).mean() \
        > 0.1
    xt = FAM.t(x).requires_grad_(True)
    silu_stepwise(xt).sum().backward()
    jg = np.asarray(jax.grad(lambda v: jax.nn.silu(v).sum())(jnp.asarray(x)))
    assert bool(torch.isfinite(xt.grad).all())
    FAM.close(xt.grad, jg, 1e-6)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def grads(pair):
    return FAM.loss_and_grads(pair, FAM.batch(pair[2].cfg, seed=7),
                              spread=True)


def test_loss_and_grads_match_jax(grads):
    FAM.grads_match(grads)
    assert float(grads["tmet"]["tokens"]) == 61.0


def test_loss_and_grads_chunked_under_remat(pair):
    """The mLSTM's parallel form over 4 chunks of 4 (attn_chunk 4) with
    remat "full" (each group recomputed in the backward pass): the loss
    and every gradient leaf against JAX's."""
    pair = FAM.make_pair(ARCH, jp=pair[1], attn_chunk=4, remat="full")
    FAM.grads_match(FAM.loss_and_grads(pair, FAM.batch(pair[2].cfg, seed=8),
                                       spread=True))


def test_decode_logits_and_states_over_8_steps(pair):
    st = FAM.decode_8_steps(pair)
    G, n_m, B, H, dh = 2, 3, 2, 4, 16
    assert tuple(st["m"][0].shape) == (G, n_m, B, H, dh, dh)
    assert all(x.dtype == torch.float32 for x in st["m"] + st["s"])


def test_decode_matches_the_parallel_form(pair):
    """Teacher forcing: the logits of 8 decode steps equal the parallel
    form's (``_backbone`` and ``_logits``) over the same tokens."""
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
    """As the reference: ``prefill`` raises for a recurrent family, and
    ``make_prefill_step`` runs the parallel forward pass and returns its
    loss."""
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
    """bfloat16 compute (bf16 projections, float32 states): the loss, 8
    decode steps' logits and every state leaf (``bf16_matches``)."""
    st = FAM.bf16_matches(ARCH, pair[1])
    assert all(x.dtype == torch.float32 for x in st["m"] + st["s"])


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
    """On the card 8 decode steps' logits and states agree with the CPU's
    within 1e-4 (TF32 off)."""
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
