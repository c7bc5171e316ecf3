"""The port's encoder-decoder family (whisper-medium) against the JAX
package's.

The JAX package's reduced whisper-medium (float32, ``naive`` attention: 2
encoder and 2 decoder layers, d_model 64, 4 query heads over 2 KV heads,
head dim 16, 16 frames) goes through both packages with the same weights:
the JAX model's own, carried across by ``convert.model_params_from_numpy``.
Tokens and frames are made from a seed with numpy (frames ``normal(0,
0.1)``, as ``tests/test_models.py`` makes them).  Tolerances, those of
``tests/test_torch_models.py``: 1e-5 for the layers, the encoder, the
cross k/v, the prefill and the loss and gradients (float32, sums in
another order), 1e-4 for decode over 8 steps (the differences compound
through the cache), greedy tokens exactly, ``sinusoidal_positions`` bit
for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import decode_loop as jax_decode_loop
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import layers as JL
from repro.models.model import build_model as jax_build
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.optim import global_norm
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-medium"
TOL = 1e-5
DECODE_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(cfg, B, S_, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        0, 0.1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _np(tree):
    """A port parameter tree as numpy in the JAX layout: the per-layer
    lists ``stack`` and ``enc`` stacked on a leading layer axis."""
    def host(t):
        return t.detach().float().cpu().numpy()
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, list):
            layers = [tree_map(host, layer) for layer in sub]
            out[name] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
        else:
            out[name] = tree_map(host, sub)
    return out


# ------------------------------------------------------------------ config
def test_whisper_config_equals_jax_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    red = get_config(ARCH).reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(
        jax_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers,
            cfg.encoder_seq) == ("encdec", 24, 24, 1500)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab) == (1024, 16, 16, 64, 4096, 51968)
    assert (red.num_layers, red.encoder_layers, red.d_model, red.num_heads,
            red.num_kv_heads, red.head_dim, red.encoder_seq, red.dtype,
            red.attn_impl) == (2, 2, 64, 4, 2, 16, 16, "float32", "naive")


def test_build_model_builds_whisper_and_needs_the_card(monkeypatch):
    cfg = get_config(ARCH)
    model = build_model(cfg, "cpu")
    assert model.cfg is cfg and model.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(cfg)


@pytest.mark.parametrize("seq,d_model", [(16, 64), (1500, 1024)])
def test_sinusoidal_positions_bit_equal(seq, d_model):
    want = np.asarray(JL.sinusoidal_positions(seq, d_model))
    got = TL.sinusoidal_positions(seq, d_model)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    on = TL.sinusoidal_on(seq, d_model, torch.device("cpu"))
    np.testing.assert_array_equal(on.numpy(), want)
    # one table per (d_model, device): shorter asks are views of it, a
    # longer one makes it anew, and its rows stay the reference's
    short = TL.sinusoidal_on(seq // 2, d_model, torch.device("cpu"))
    assert short.data_ptr() == on.data_ptr()
    np.testing.assert_array_equal(short.numpy(), want[:seq // 2])
    longer = TL.sinusoidal_on(seq + 3, d_model, torch.device("cpu"))
    np.testing.assert_array_equal(
        longer.numpy(), np.asarray(JL.sinusoidal_positions(seq + 3, d_model)))
    assert TL.sinusoidal_on(seq, d_model, torch.device("cpu")).data_ptr() \
        == longer.data_ptr()


# ------------------------------------------------------------------ pair
@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    whisper-medium, the weights the JAX model's own, every bias drawn away
    from 0 and every norm scale away from 1 so that a missing one shows."""
    jcfg = jax_config(ARCH).reduced()
    jm = jax_build(jcfg)
    rng = np.random.default_rng(11)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if name.endswith("['scale']"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name.split("[")[-1].strip("']").startswith("b"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    jp = jax.tree_util.tree_map_with_path(
        perturb, jm.init(jax.random.PRNGKey(0)))
    tcfg = get_config(ARCH).reduced()
    tp = model_params_from_numpy(tcfg, jp, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    return jm, jp, build_model(tcfg, "cpu"), tp


def test_convert_keeps_every_leaf(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert tm.param_count(tp) == n_jax
    assert sorted(tp) == sorted(jp) == ["embed", "enc", "enc_norm",
                                        "final_norm", "lm_head", "stack"]
    assert len(tp["enc"]) == cfg.encoder_layers == 2
    assert len(tp["stack"]) == cfg.num_layers == 2
    assert sorted(tp["enc"][0]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(tp["stack"][0]) == ["attn", "ln1", "ln2", "ln_x", "mlp",
                                      "xattn"]
    assert sorted(tp["enc_norm"]) == ["bias", "scale"]
    np.testing.assert_array_equal(tp["enc"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jp["enc"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(tp["stack"][1]["xattn"]["wk"].numpy(),
                                  np.asarray(jp["stack"]["xattn"]["wk"][1]))
    np.testing.assert_array_equal(tp["stack"][0]["ln_x"]["bias"].numpy(),
                                  np.asarray(jp["stack"]["ln_x"]["bias"][0]))
    np.testing.assert_array_equal(tp["enc_norm"]["scale"].numpy(),
                                  np.asarray(jp["enc_norm"]["scale"]))
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    served = model_params_from_numpy(bf, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    assert served["stack"][0]["xattn"]["wo"].dtype == torch.bfloat16
    assert served["stack"][0]["xattn"]["bq"].dtype == torch.float32
    assert served["enc_norm"]["scale"].dtype == torch.float32
    assert served["enc"][0]["mlp"]["wi"].dtype == torch.bfloat16
    # the port's own init: the same leaves, shapes and dtypes
    own = build_model(bf, "cpu").init(0)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), served)
    with pytest.raises(ValueError, match="'enc'"):
        model_params_from_numpy(dataclasses.replace(cfg, encoder_layers=3),
                                jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("flash", [True, False])
def test_encode_matches_jax(pair, flash):
    """The encoder (sinusoidal positions, bidirectional stack, enc_norm);
    ``flash`` runs the flash kernel's plain version non-causally."""
    jm, jp, tm, tp = pair
    frames = _frames(tm.cfg, 2, 1)
    want = jax.jit(jm._encode)(jp, jnp.asarray(frames))
    before = LAUNCHES["flash_attention"]
    got = tm._encode(tp, _t(frames), flash=flash)
    assert LAUNCHES["flash_attention"] == before   # the CPU: plain version
    assert tuple(got.shape) == want.shape == (2, 16, 64)
    _close(got, want)


def test_cross_kv_matches_jax(pair):
    """Every decoder layer's cross (k, v) with biases, (L, B, Se, KV, hd)."""
    jm, jp, tm, tp = pair
    enc = np.random.default_rng(2).normal(0, 1, (2, 16, 64)).astype(
        np.float32)
    wk, wv = jax.jit(jm._cross_kv)(jp, jnp.asarray(enc))
    gk, gv = tm._cross_kv(tp, _t(enc))
    assert tuple(gk.shape) == wk.shape == (2, 2, 16, 2, 16)
    _close(gk, wk)
    _close(gv, wv)


# ------------------------------------------------------------------ block
def _attn_params(cfg, seed):
    """``init_attention``'s leaves of the JAX package with biases drawn:
    (JAX dict, port dict)."""
    jp = jax.tree.map(np.asarray,
                      JL.init_attention(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        jp[name] = rng.normal(0, 0.2, jp[name].shape).astype(np.float32)
    return ({n: jnp.asarray(a) for n, a in jp.items()},
            {n: _t(a) for n, a in jp.items()})


@pytest.mark.parametrize("route,impl,chunk", [("flash", "naive", 1024),
                                              ("plain", "naive", 1024),
                                              ("plain", "chunked", 4)])
def test_attention_block_cross(route, impl, chunk):
    """Cross-attention: q projected with bq (no rope, no qk-norm on k), k
    and v taken as given, 12 queries over all 20 encoder keys, no cache
    written; on the plain routes (naive, and chunked in 3 query chunks)
    and the flash route (the kernel's plain version on the CPU)."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced(attn_impl=impl, attn_chunk=chunk)
    jp, tp = _attn_params(jcfg, 3)
    rng = np.random.default_rng(4)
    B, Sq, Se = 2, 12, 20
    x = rng.normal(0, 1, (B, Sq, jcfg.d_model)).astype(np.float32)
    k = rng.normal(0, 1, (B, Se, jcfg.num_kv_heads, jcfg.head_dim)).astype(
        np.float32)
    v = rng.normal(0, 1, k.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    want, cache = JL.attention_block(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
        cross_kv=(jnp.asarray(k), jnp.asarray(v)), causal=False,
        dtype=jnp.float32)
    got = TL.attention_block(tp, _t(x), tcfg, _t(pos),
                             cross_kv=(_t(k), _t(v)), dtype=torch.float32,
                             flash=route == "flash")
    assert cache is None and tuple(got.shape) == (B, Sq, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("flash", [True, False])
def test_attention_block_non_causal(flash):
    """The encoder's bidirectional self-attention (``causal=False``, no
    cache), flash and plain, against the reference's."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    jp, tp = _attn_params(jcfg, 5)
    B, Se = 2, 16
    x = np.random.default_rng(6).normal(0, 1, (B, Se, jcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(Se), (B, Se)).astype(np.int32)
    want, _ = JL.attention_block(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 causal=False, dtype=jnp.float32)
    causal, _ = JL.attention_block(jp, jnp.asarray(x), jcfg,
                                   jnp.asarray(pos), dtype=jnp.float32)
    got = TL.attention_block(tp, _t(x), tcfg, _t(pos), causal=False,
                             dtype=torch.float32, flash=flash)
    _close(got, want)
    assert np.abs(np.asarray(causal) - got.numpy()).max() > 1e-2


def test_flash_cross_attention_is_never_causal(monkeypatch):
    """A guard against ``causal=True`` leaking into cross-attention: the
    kernel left-aligns query positions, so at Sq < Skv a causal call
    masks every key past the query's index.  The wrapper's non-causal
    call equals the naive route and its causal call does not; the cross
    route hands the wrapper ``causal=False`` and equals the plain route."""
    rng = np.random.default_rng(7)
    B, Sq, Skv, H, KV, D = 2, 6, 20, 4, 2, 16
    q = _t(rng.normal(0, 1, (B, Sq, H, D)).astype(np.float32))
    k = _t(rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32))
    v = _t(rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32))
    naive = TL.attention(q, k, v, q_positions=torch.arange(Sq).expand(B, Sq),
                         k_positions=torch.arange(Skv).expand(B, Skv),
                         causal=False, impl="naive", dtype=torch.float32)
    _close(flash_attention(q, k, v, causal=False), naive)
    assert (flash_attention(q, k, v, causal=True) - naive).abs().max() > 1e-2
    seen = []
    real = TL.flash_attention
    monkeypatch.setattr(TL, "flash_attention", lambda *a, **kw: (
        seen.append(kw["causal"]), real(*a, **kw))[1])
    cfg = get_config(ARCH).reduced()
    _, tp = _attn_params(jax_config(ARCH).reduced(), 8)
    x = _t(rng.normal(0, 1, (B, Sq, cfg.d_model)).astype(np.float32))
    pos = torch.arange(Sq, dtype=torch.int32).expand(B, Sq)
    kw = dict(cross_kv=(k, v), dtype=torch.float32)
    got = TL.attention_block(tp, x, cfg, pos, flash=True, **kw)
    assert seen == [False]
    _close(got, TL.attention_block(tp, x, cfg, pos, **kw))


# ------------------------------------------------------------------ model
def test_init_cache_is_self_and_cross_and_takes_no_ring(pair):
    jm, _, tm, _ = pair
    for ring in (False, True):
        want = jm.init_cache(2, 10, ring=ring)
        got = tm.init_cache(2, 10, ring=ring)
        assert sorted(got) == sorted(want) == ["cross", "self"]
        assert got["cross"] is None and want["cross"] is None
        assert sorted(got["self"]) == ["k", "v"]
        for name in ("k", "v"):
            assert tuple(got["self"][name].shape) == want["self"][name].shape
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder's"):
        tm.decode_step(pair[3], {"token": tok, "pos": 0, "cache": got})


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_logits_and_both_caches(pair, flash):
    """Prefill at S=8 into 12 slots: last-position logits, the self cache
    and the cross cache; ``flash`` runs the kernel's plain version for the
    encoder, the decoder's self-attention and the cross-attention."""
    jm, jp, tm, tp = pair
    B, S_, cache_seq = 2, 8, 12
    toks, frames = _prompt(tm.cfg, B, S_, 1), _frames(tm.cfg, B, 2)
    want, wcache = jax.jit(lambda p, t, f: jm.prefill(
        p, {"tokens": t, "frames": f, "cache_seq": cache_seq}))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks), "frames": _t(frames),
                                  "cache_seq": cache_seq}, flash=flash)
    assert got.shape == (B, tm.cfg.padded_vocab)
    _close(got, want)
    for name in ("k", "v"):
        assert tuple(gcache["self"][name].shape) == wcache["self"][name].shape
        _close(gcache["self"][name], wcache["self"][name])
    for g, w in zip(gcache["cross"], wcache["cross"]):
        assert tuple(g.shape) == w.shape == (2, B, 16, 2, 16)
        _close(g, w)


def test_decode_logits_over_8_steps_from_jax_cross_kv(pair):
    """``tests/test_models.py``'s decode: the cross cache the JAX
    encoder's and ``_cross_kv``'s, carried across; 8 steps from an empty
    self cache, each step's logits, then the self cache."""
    jm, jp, tm, tp = pair
    B, steps = 2, 8
    toks, frames = _prompt(tm.cfg, B, steps, 3), _frames(tm.cfg, B, 4)
    jc = jm.init_cache(B, 10)
    jc["cross"] = jm._cross_kv(jp, jm._encode(jp, jnp.asarray(frames)))
    tc = tm.init_cache(B, 10)
    tc["cross"] = tuple(_t(a) for a in jc["cross"])
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        want, jc = step(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                             "pos": jnp.asarray(t, jnp.int32), "cache": jc})
        got, tc = tm.decode_step(tp, {"token": _t(toks[:, t:t + 1]),
                                      "pos": t, "cache": tc})
        _close(got, want, DECODE_TOL)
    for name in ("k", "v"):
        _close(tc["self"][name], jc["self"][name], DECODE_TOL)


@pytest.mark.parametrize("flash", [True, False])
def test_decode_matches_teacher_forcing(pair, flash):
    """Decode steps over a prompt's tail from a 4-token prefill's cache
    (its cross the prefill's) end at the 8-token prefill's last-position
    logits and write its self cache; so do 8 steps from an empty self
    cache with the encoder's cross k/v."""
    _, _, tm, tp = pair
    B, S_, P0 = 2, 8, 4
    toks, frames = _t(_prompt(tm.cfg, B, S_, 5)), _t(_frames(tm.cfg, B, 6))
    full, fcache = tm.prefill(tp, {"tokens": toks, "frames": frames,
                                   "cache_seq": S_}, flash=flash)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :P0], "frames": frames,
                               "cache_seq": S_}, flash=flash)
    for t in range(P0, S_):
        logits, cache = tm.decode_step(tp, {"token": toks[:, t:t + 1],
                                            "pos": t, "cache": cache})
    torch.testing.assert_close(logits, full, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cache["self"][name], fcache["self"][name],
                                   atol=DECODE_TOL, rtol=DECODE_TOL)
    cache = tm.init_cache(B, S_)
    cache["cross"] = tm._cross_kv(tp, tm._encode(tp, frames))
    for t in range(S_):
        logits, cache = tm.decode_step(tp, {"token": toks[:, t:t + 1],
                                            "pos": t, "cache": cache})
    torch.testing.assert_close(logits, full, atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_prefill_step_carries_frames_and_launches_nothing_on_the_cpu(pair):
    _, _, tm, tp = pair
    _, prefill = make_prefill_step(tm.cfg, "cpu")
    before = LAUNCHES["flash_attention"]
    logits, cache = prefill(tp, {"tokens": _prompt(tm.cfg, 1, 6, 7),
                                 "frames": _frames(tm.cfg, 1, 8),
                                 "cache_seq": 8})
    assert LAUNCHES["flash_attention"] == before
    assert bool(torch.isfinite(logits).all())
    assert tuple(cache["self"]["k"].shape) == (2, 1, 8, 2, 16)
    assert tuple(cache["cross"][0].shape) == (2, 1, 16, 2, 16)


# ------------------------------------------------------------------ train
@pytest.fixture(scope="module")
def grads_pair(pair):
    """The loss, metrics and gradients of one batch (tokens, labels with 3
    masked, frames) in both packages from the same float32 weights."""
    jm, jp, tm, _ = pair
    tp = model_params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=True)
    rng = np.random.default_rng(9)
    labels = rng.integers(0, tm.cfg.vocab_size, (4, 16)).astype(np.int32)
    labels[0, :3] = -1
    b = {"tokens": _prompt(tm.cfg, 4, 16, 10), "labels": labels,
         "frames": _frames(tm.cfg, 4, 11)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss, tmet = tm.loss_fn(tp, {k: _t(v) for k, v in b.items()})
    loss.backward()
    tg = tree_map(lambda p: p.grad, tp)
    return dict(jl=jl, jmet=jmet, jg=jg, tl=loss.detach(), tmet=tmet, tg=tg,
                tp=tp, batch=b)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_loss_fn_matches_jax(grads_pair):
    r = grads_pair
    assert _rel(r["tl"], r["jl"]) <= TOL
    assert float(r["tmet"]["tokens"]) == float(r["jmet"]["tokens"]) == 61.0


def test_grads_match_jax_leaf_by_leaf(grads_pair):
    """Every gradient leaf within 1e-5 relative L2, the encoder's (which
    only the cross-attention reaches) among them.  A key bias's exact
    gradient is zero (it shifts every score of a query row by the same
    amount, which the softmax cancels), so both packages' are rounding
    noise, each held to 1e-6 of the global gradient norm instead."""
    got = _np(grads_pair["tg"])
    want = jax.tree.map(np.asarray, grads_pair["jg"])
    norm = float(JA.global_norm(grads_pair["jg"]))
    gl, wl = (jax.tree.leaves_with_path(t) for t in (got, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        name = jax.tree_util.keystr(path)
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if name.endswith("['bk']"):
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-6 * norm
            continue
        rel = np.sqrt(((g - w) ** 2).sum() / max((w ** 2).sum(), 1e-30))
        assert rel <= TOL, (name, rel)
    assert float(np.abs(got["enc"]["attn"]["wq"]).max()) > 0


def test_grad_norm_matches_jax(grads_pair):
    assert _rel(global_norm(grads_pair["tg"]),
                JA.global_norm(grads_pair["jg"])) <= TOL


def test_remat_carries_cross_kv_through_the_checkpoint(pair, grads_pair):
    """``remat="full"``: each decoder layer recomputed in the backward
    pass with its cross (k, v) a checkpoint input; the encoder's gradients
    are the ones without remat, bit for bit."""
    tcfg = dataclasses.replace(pair[2].cfg, remat="full")
    tm = build_model(tcfg, "cpu")
    tp = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                  grads_pair["tp"])
    loss, _ = tm.loss_fn(tp, {k: _t(v) for k, v in grads_pair["batch"].items()})
    loss.backward()
    assert torch.equal(loss.detach(), grads_pair["tl"])
    for got, want in zip(tree_leaves(tree_map(lambda p: p.grad, tp)),
                         tree_leaves(grads_pair["tg"])):
        assert torch.equal(got, want)


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_tokens_match_jax_decode_loop(pair, prefetch):
    """Greedy tokens of the port's ``decode_loop_engine`` (and its
    ``decode_loop``) equal JAX's ``decode_loop``, whose ``_init_cache``
    gives a zero cross cache of ``encoder_seq`` slots (a 12-token prompt,
    6 new tokens)."""
    jm, jp, tm, tp = pair
    jm_, jstep = jax_make_serve_step(jm.cfg)
    prompt = _prompt(tm.cfg, 2, 12, 12)
    ref = jax_decode_loop(jm_, jax.jit(jstep), jp, prompt, gen=6,
                          cache_seq=18)
    model, step = make_serve_step(tm.cfg, "cpu")
    cache = S._init_cache(model, 2, 18)
    assert tuple(cache["cross"][0].shape) == (2, 2, 16, 2, 16)
    assert not bool(cache["cross"][0].any())
    own = S.decode_loop(model, step, tp, prompt, gen=6, cache_seq=18)
    out, summary = S.decode_loop_engine(model, step, tp, prompt, gen=6,
                                        cache_seq=18, prefetch=prefetch)
    np.testing.assert_array_equal(out, own)
    np.testing.assert_array_equal(out, ref)
    assert summary["requests"] == 11 + 6


def test_serve_main_runs_whisper_on_the_cpu(capsys):
    out = S.main(["--arch", ARCH, "--reduce", "--device", "cpu"])
    assert out.shape == (4, 16)
    assert (out >= 0).all() and (out < 256).all()
    assert "arch=whisper-medium" in capsys.readouterr().out


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefill_launches_the_kernel_for_every_role(pair, cuda_device):
    """On the card the reduced prefill launches the kernel Le + 2 Ld
    times (encoder, decoder self-attention, cross-attention) and agrees
    with the CPU within 1e-4."""
    _, _, tm, tp = pair
    _, prefill = make_prefill_step(tm.cfg, cuda_device)
    batch = {"tokens": _prompt(tm.cfg, 2, 8, 13),
             "frames": _frames(tm.cfg, 2, 14), "cache_seq": 12}
    torch.backends.cuda.matmul.allow_tf32 = False
    before = LAUNCHES["flash_attention"]
    got, cache = prefill(tree_map(lambda t: t.to(cuda_device), tp), batch)
    assert LAUNCHES["flash_attention"] - before == 2 + 2 * 2
    want, wcache = make_prefill_step(tm.cfg, "cpu")[1](tp, batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["cross"][0].cpu(), wcache["cross"][0],
                               atol=1e-4, rtol=1e-4)
