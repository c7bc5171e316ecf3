"""The port's dense LM stack against the JAX package's.

The JAX package's reduced dense configurations (float32, ``naive``
attention) go through both packages with the same weights: the JAX
model's own, carried across by ``convert.model_params_from_numpy``.  The
inputs are made from a seed with numpy.  Tolerances: 1e-5 for the layers
and the prefill (float32, sums in another order), 1e-4 for decode logits
over 8 steps (the differences compound through the cache), 2e-2 for the
bfloat16 case (bf16 rounding at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

ARCHS = ["qwen3-14b", "codeqwen1.5-7b", "command-r-35b", "nemotron-4-340b",
         "mixtral-8x22b", "deepseek-v2-236b"]
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_port_registry_holds_the_dense_configs_field_for_field():
    others = ["whisper-medium", "internvl2-76b", "xlstm-350m", "zamba2-2.7b"]
    assert list_configs() == sorted(ARCHS + others)
    for name in ARCHS + others:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jax_config(name).reduced())
    assert get_config("qwen3-14b").padded_vocab == 152064


@pytest.mark.parametrize("arch", list_configs())
def test_build_model_builds_every_registered_family(arch, monkeypatch):
    """Every registered configuration, of every family, made from the JAX
    package's fields, builds on the CPU (full and reduced), and asks for
    the card by default: without one, "cuda" is refused."""
    cfg = ModelConfig(**dataclasses.asdict(jax_config(arch)))
    for c in (cfg, cfg.reduced()):
        model = build_model(c, "cpu")
        assert model.cfg is c and model.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(cfg, "cuda")


def test_build_model_builds_mixtral():
    cfg = get_config("mixtral-8x22b")
    model = build_model(cfg, "cpu")
    assert model.cfg is cfg and model.device == torch.device("cpu")
    assert cfg.family == "moe" and not cfg.mla


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(get_config("qwen3-14b").reduced())


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind,bias", [("rmsnorm", False),
                                       ("layernorm", False),
                                       ("layernorm", True)])
def test_apply_norm(kind, bias):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 32).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(0, 0.1, 32).astype(np.float32)
    want = JL.apply_norm({n: jnp.asarray(a) for n, a in p.items()},
                         jnp.asarray(x), kind)
    got = TL.apply_norm({n: _t(a) for n, a in p.items()}, _t(x), kind)
    _close(got, want)


def test_rms_head_norm_and_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 4, 16)).astype(np.float32)
    scale = rng.normal(1, 0.1, 16).astype(np.float32)
    _close(TL.rms_head_norm(_t(scale), _t(x)),
           JL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(TL.apply_rope(_t(x), _t(pos), theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(2)
    D, F = 24, 40
    p = {"wg": rng.normal(0, 0.2, (D, F)), "wu": rng.normal(0, 0.2, (D, F)),
         "wd": rng.normal(0, 0.2, (F, D))} if kind == "swiglu" else {
        "wi": rng.normal(0, 0.2, (D, F)), "wd": rng.normal(0, 0.2, (F, D)),
        "bi": rng.normal(0, 0.1, F), "bd": rng.normal(0, 0.1, D)}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.normal(0, 1, (2, 3, D)).astype(np.float32)
    want = JL.apply_mlp({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), kind, dtype=jnp.float32)
    got = TL.apply_mlp({n: _t(a) for n, a in p.items()}, _t(x), kind,
                       dtype=torch.float32)
    _close(got, want)


@pytest.mark.parametrize("impl,chunk", [("naive", 1024), ("chunked", 16),
                                        ("chunked", 24)])
@pytest.mark.parametrize("causal,window,pushed", [(True, None, False),
                                                  (True, 8, False),
                                                  (False, None, False),
                                                  (True, None, True)])
def test_attention(impl, chunk, causal, window, pushed):
    """GQA attention, naive and chunked (chunk < S; 24 does not divide 64
    and halves to 8, below 64: the naive fallback), with and without the
    decode cache's 2**30 push of unwritten slots."""
    rng = np.random.default_rng(3)
    B, S, Skv, H, KV, D = 2, 64, 80, 4, 2, 16
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, KV, D)).astype(np.float32)
    qp = np.broadcast_to(np.arange(S) + 4, (B, S)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32)
    if pushed:
        kp = np.where(kp < S + 4, kp, 2**30).astype(np.int32)
    kw = dict(causal=causal, window=window, impl=impl, chunk=chunk)
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_positions=jnp.asarray(qp),
                        k_positions=jnp.asarray(kp), dtype=jnp.float32, **kw)
    got = TL.attention(_t(q), _t(k), _t(v), q_positions=_t(qp),
                       k_positions=_t(kp), dtype=torch.float32, **kw)
    _close(got, want)


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params) of one reduced
    config, the weights the JAX model's own."""
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(request.param).reduced()
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jm, jp, build_model(tcfg, "cpu"), tp


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_convert_keeps_every_leaf(pair):
    jm, jp, tm, tp = pair
    L = tm.cfg.num_layers
    assert len(tp["stack"]) == L
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jp))
    assert tm.param_count(tp) == n_jax
    wq = "wq_a" if tm.cfg.mla else "wq"
    np.testing.assert_array_equal(
        tp["stack"][L - 1]["attn"][wq].numpy(),
        np.asarray(jp["stack"]["attn"][wq][L - 1]))
    assert tp["stack"][0]["ln1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_logits_and_cache(pair, flash):
    """Prefill: last-position logits and every cache leaf; ``flash`` runs
    the flash kernel's plain version on the CPU, else the naive route."""
    jm, jp, tm, tp = pair
    B, S, cache_seq = 2, 8, 12
    toks = _prompt(tm.cfg, B, S, 1)
    want, wcache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp, jnp.asarray(toks))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks), "cache_seq": cache_seq},
                             flash=flash)
    assert got.shape == (B, tm.cfg.padded_vocab)
    _close(got, want)
    assert sorted(gcache) == sorted(wcache)
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape
        _close(gcache[name], wcache[name])


def test_decode_logits_over_8_steps(pair):
    jm, jp, tm, tp = pair
    B, steps = 2, 8
    toks = _prompt(tm.cfg, B, steps, 2)
    step = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(B, 10), tm.init_cache(B, 10)
    for t in range(steps):
        want, jc = step(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                             "pos": jnp.asarray(t, jnp.int32), "cache": jc})
        got, tc = tm.decode_step(tp, {"token": _t(toks[:, t:t + 1]),
                                      "pos": t, "cache": tc})
        _close(got, want, 1e-4)
    for name in jc:
        _close(tc[name], jc[name], 1e-4)


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_chunked_qwen3(flash):
    """bfloat16 with chunked attention (chunk 8 < S = 16): prefill and 4
    decode steps within 2e-2.  The chunked route rounds probabilities to
    bf16 before the PV product as the reference does, so its cache is held
    to the reference's too; the flash route keeps them float32 (the TPU
    kernel's contract), which moves single cache entries of later layers
    by a bf16 step or two, so only its logits are compared."""
    over = dict(dtype="bfloat16", attn_impl="chunked", attn_chunk=8)
    jcfg = jax_config("qwen3-14b").reduced(**over)
    tcfg = get_config("qwen3-14b").reduced(**over)
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    B, S, cache_seq = 2, 16, 20
    toks = _prompt(tcfg, B, S, 4)
    want, wcache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp, jnp.asarray(toks))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks), "cache_seq": cache_seq},
                             flash=flash)
    _close(got.float(), want, 2e-2)
    if not flash:
        _close(gcache["k"].float(), wcache["k"], 2e-2)
        _close(gcache["v"].float(), wcache["v"], 2e-2)
    step = jax.jit(jm.decode_step)
    for t in range(S, S + 4):
        tok = toks[:, t - S:t - S + 1]
        want, wcache = step(jp, {"token": jnp.asarray(tok),
                                 "pos": jnp.asarray(t, jnp.int32),
                                 "cache": wcache})
        got, gcache = tm.decode_step(tp, {"token": _t(tok), "pos": t,
                                          "cache": gcache})
        _close(got.float(), want, 2e-2)
