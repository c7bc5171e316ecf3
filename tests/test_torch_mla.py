"""The port's multi-head latent attention (deepseek-v2-236b) against the
JAX package's.

The JAX package's reduced deepseek-v2-236b (float32: d_model 64, 4 heads,
q/k head dim 16 + 8 rotary, v head dim 16, kv_lora 32, q_lora 48, 4
experts top-2 and a shared expert) goes through both packages with the
same weights: the JAX model's own, carried across by
``convert.model_params_from_numpy``.  Inputs are made from a seed with
numpy.  Tolerances: ``mla_block``'s output and the latent caches 1e-5
(float32, sums in another order; the flash route rebuilds per-head k and
v where the reference's cache route scores against the latent, another
order of the same products), the flash kernel's plain version 1e-5,
prefill logits 1e-5, decode logits 1e-4 (differences compound through
the cache), greedy tokens exactly.
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
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_attention import (
    LAUNCHES, flash_attention, flash_attention_ref, uses_tensor_cores)
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

ARCH = "deepseek-v2-236b"
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ config
def test_deepseek_config_equals_jax_field_for_field():
    for over in ({}, dict(attn_impl="chunked", attn_chunk=4)):
        assert dataclasses.asdict(get_config(ARCH)) == \
            dataclasses.asdict(jax_config(ARCH))
        assert dataclasses.asdict(get_config(ARCH).reduced(**over)) == \
            dataclasses.asdict(jax_config(ARCH).reduced(**over))
    cfg = get_config(ARCH)
    assert cfg.family == "moe" and cfg.mla
    assert (cfg.head_dim + cfg.rope_head_dim, cfg.v_head_dim) == (192, 128)


def test_build_model_builds_deepseek_on_the_cpu():
    cfg = get_config(ARCH)
    model = build_model(cfg, "cpu")
    assert model.cfg is cfg and model.device == torch.device("cpu")


# ------------------------------------------------------------------ block
def _mla_params(cfg, seed):
    """``init_mla``'s leaves of the JAX package, the norm scales drawn
    away from 1 so that a missing scale shows: (numpy dict, port dict)."""
    jp = jax.tree.map(np.asarray, JL.init_mla(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("q_a_norm", "kv_a_norm"):
        jp[name] = rng.normal(1, 0.2, jp[name].shape).astype(np.float32)
    return jp, {n: _t(a) for n, a in jp.items()}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl,chunk", [("naive", 1024), ("chunked", 8)])
def test_mla_block_without_cache(impl, chunk):
    """The training route: per-head k and v rebuilt from the latent and
    handed to ``attention`` (naive, and chunked with 2 chunks of 8)."""
    jcfg = jax_config(ARCH).reduced(attn_impl=impl, attn_chunk=chunk)
    tcfg = get_config(ARCH).reduced(attn_impl=impl, attn_chunk=chunk)
    jp, tp = _mla_params(jcfg, 0)
    B, S = 2, 16
    x = _x(jcfg, B, S, 1)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want, wcache = JL.mla_block({n: jnp.asarray(a) for n, a in jp.items()},
                                jnp.asarray(x), jcfg, jnp.asarray(pos),
                                dtype=jnp.float32)
    got = TL.mla_block(tp, _t(x), tcfg, _t(pos), dtype=torch.float32)
    assert wcache is None and tuple(got.shape) == (B, S, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("route,impl,chunk", [
    ("flash", "naive", 1024),
    ("plain", "naive", 1024),
    ("plain", "chunked", 4),     # 3 query chunks
    ("plain", "chunked", 5),     # chunks of 5, 5 and 2
])
def test_mla_block_with_cache(route, impl, chunk):
    """The cache route at S=12 into 16 slots against the reference's
    absorbed form: the output and both latent caches; then one decode
    token at slot 12 on the plain route."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced(attn_impl=impl, attn_chunk=chunk)
    jp, tp = _mla_params(jcfg, 2)
    jpj = {n: jnp.asarray(a) for n, a in jp.items()}
    B, S, Smax = 2, 12, 16
    x = _x(jcfg, B, S + 1, 3)
    pos = np.broadcast_to(np.arange(S + 1), (B, S + 1)).astype(np.int32)
    jcache = {"c_kv": jnp.zeros((B, Smax, jcfg.kv_lora_rank)),
              "k_rope": jnp.zeros((B, Smax, jcfg.rope_head_dim))}
    tcache = {"c_kv": torch.zeros(B, Smax, tcfg.kv_lora_rank),
              "k_rope": torch.zeros(B, Smax, tcfg.rope_head_dim)}
    want, jcache = JL.mla_block(jpj, jnp.asarray(x[:, :S]), jcfg,
                                jnp.asarray(pos[:, :S]), cache=jcache,
                                cache_len=0, dtype=jnp.float32)
    before = LAUNCHES["flash_attention"]
    got = TL.mla_block(tp, _t(x[:, :S]), tcfg, _t(pos[:, :S]), cache=tcache,
                       cache_len=0, dtype=torch.float32,
                       flash=route == "flash")
    assert LAUNCHES["flash_attention"] == before   # the CPU: plain version
    _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(tcache[name], jcache[name])
    want, jcache = JL.mla_block(jpj, jnp.asarray(x[:, S:]), jcfg,
                                jnp.asarray(pos[:, S:]), cache=jcache,
                                cache_len=S, dtype=jnp.float32)
    got = TL.mla_block(tp, _t(x[:, S:]), tcfg, _t(pos[:, S:]), cache=tcache,
                       cache_len=S, dtype=torch.float32)
    _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(tcache[name], jcache[name])


def test_mla_flash_route_needs_slot_0():
    cfg = get_config(ARCH).reduced()
    _, tp = _mla_params(jax_config(ARCH).reduced(), 0)
    cache = {"c_kv": torch.zeros(1, 8, cfg.kv_lora_rank),
             "k_rope": torch.zeros(1, 8, cfg.rope_head_dim)}
    x = torch.zeros(1, 2, cfg.d_model)
    pos = torch.arange(2, 4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="cache_len == 0"):
        TL.mla_block(tp, x, cfg, pos, cache=cache, cache_len=2,
                     dtype=torch.float32, flash=True)


def test_mla_qkv_writes_the_rotary_key_out_for_every_head():
    """The flash route's inputs: q (B,S,H,dn+dr), k (B,S,H,dn+dr) whose
    rotary columns are k_rope for every head, v (B,S,H,dv); all three
    contiguous (the kernel's TMA takes no zero stride)."""
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    _, tp = _mla_params(jcfg, 4)
    B, S = 2, 5
    x = _t(_x(cfg, B, S, 5))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = TL.mla_projection(tp, x, cfg, pos,
                                                     torch.float32)
    q, k, v = TL.mla_qkv(tp, q_nope, q_rope, c_kv, k_rope, torch.float32)
    H, dn, dr, dv = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim, \
        cfg.v_head_dim
    assert tuple(q.shape) == tuple(k.shape) == (B, S, H, dn + dr)
    assert tuple(v.shape) == (B, S, H, dv)
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    for h in range(H):
        assert torch.equal(k[:, :, h, dn:], k_rope)
    assert torch.equal(q[..., :dn], q_nope)


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dqk,dv", [(24, 16), (192, 128)])
def test_flash_ref_takes_v_at_its_own_head_dim(dqk, dv, causal):
    """``flash_attention_ref`` (what the wrapper runs on the CPU) at Dv <
    Dqk against JAX ``layers.attention(impl="naive")``, whose ``_sdpa``
    takes a v narrower than q and k; scale 1/sqrt(Dqk).  The Pallas kernel
    has one head dim and cannot be this reference."""
    rng = np.random.default_rng(dqk + dv + causal)
    B, S, H = 2, 20, 4
    q = rng.normal(0, 1, (B, S, H, dqk)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, H, dqk)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, H, dv)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_positions=jnp.asarray(pos),
                        k_positions=jnp.asarray(pos), causal=causal,
                        impl="naive", dtype=jnp.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert tuple(got.shape) == (B, S, H, dv)
    _close(got, want)
    _close(flash_attention_ref(_t(q), _t(k), _t(v), causal=causal), want)


def test_flash_wrapper_routes_and_refuses_head_dims():
    """The tensor-core route takes (192, 128) beside (64, 64) and
    (128, 128); a v wider than q and k is refused."""
    def bf(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16)

    assert uses_tensor_cores(bf(1, 8, 2, 192), bf(1, 8, 2, 192),
                             bf(1, 8, 2, 128))
    assert not uses_tensor_cores(bf(1, 8, 2, 192), bf(1, 8, 2, 192),
                                 bf(1, 8, 2, 192))
    assert not uses_tensor_cores(bf(1, 8, 2, 128), bf(1, 8, 2, 128),
                                 bf(1, 8, 2, 64))
    with pytest.raises(ValueError, match="match"):
        flash_attention(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                        torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="match"):
        flash_attention(torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 16),
                        torch.zeros(1, 8, 2, 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,dqk,dv", [(torch.bfloat16, 192, 128),
                                          (torch.float32, 192, 128),
                                          (torch.float32, 24, 16)])
def test_cuda_kernel_at_dv_below_dqk(cuda_device, dtype, dqk, dv, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(dqk + dv)
    q = torch.randn(2, 300, 4, dqk, generator=g).to(cuda_device, dtype)
    k = torch.randn(2, 300, 4, dqk, generator=g).to(cuda_device, dtype)
    v = torch.randn(2, 300, 4, dv, generator=g).to(cuda_device, dtype)
    assert uses_tensor_cores(q, k, v) == (dtype == torch.bfloat16)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    deepseek-v2-236b, chunked attention with a chunk of 4 (the port's
    cache route loops over query chunks; the reference's has no chunks),
    the weights the JAX model's own."""
    over = dict(attn_impl="chunked", attn_chunk=4)
    jcfg = jax_config(ARCH).reduced(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH).reduced(**over)
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jm, jp, build_model(tcfg, "cpu"), tp


def test_convert_carries_the_mla_leaves(pair):
    jm, jp, tm, tp = pair
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert tm.param_count(tp) == n_jax
    names = ("wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wk_b", "wv_b",
             "wo")
    assert sorted(tp["stack"][0]["attn"]) == sorted(names)
    for name in names:
        np.testing.assert_array_equal(
            tp["stack"][1]["attn"][name].numpy(),
            np.asarray(jp["stack"]["attn"][name][1]))
    bf = dataclasses.replace(tm.cfg, dtype="bfloat16")
    served = model_params_from_numpy(bf, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    master = model_params_from_numpy(bf, jax.tree.map(np.asarray, jp),
                                     device="cpu", master=True)
    for name in names:
        want = torch.float32 if name.endswith("norm") else torch.bfloat16
        assert served["stack"][0]["attn"][name].dtype == want, name
        assert master["stack"][0]["attn"][name].dtype == torch.float32
    # the port's own init: the same leaves, shapes and dtypes
    own = build_model(bf, "cpu").init(0)["stack"][0]["attn"]
    for name in names:
        assert own[name].shape == served["stack"][0]["attn"][name].shape
        assert own[name].dtype == served["stack"][0]["attn"][name].dtype


def test_init_cache_is_the_latent_and_takes_no_ring(pair):
    jm, _, tm, _ = pair
    for ring in (False, True):
        want = jm.init_cache(2, 10, ring=ring)
        got = tm.init_cache(2, 10, ring=ring)
        assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
        for name in want:
            assert tuple(got[name].shape) == want[name].shape
            assert not bool(got[name].any())
    cfg = tm.cfg
    assert tuple(got["c_kv"].shape) == (cfg.num_layers, 2, 10,
                                        cfg.kv_lora_rank)


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_logits_and_latent_cache(pair, flash):
    """Prefill at S=12 into 16 slots: last-position logits and both latent
    caches; ``flash`` runs the flash kernel's plain version at (Dqk, Dv) =
    (24, 16) on the CPU, else the absorbed route over 3 query chunks."""
    jm, jp, tm, tp = pair
    B, S, cache_seq = 2, 12, 16
    toks = _prompt(tm.cfg, B, S, 1)
    want, wcache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp, jnp.asarray(toks))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks), "cache_seq": cache_seq},
                             flash=flash)
    assert got.shape == (B, tm.cfg.padded_vocab)
    _close(got, want)
    assert sorted(gcache) == sorted(wcache) == ["c_kv", "k_rope"]
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape
        _close(gcache[name], wcache[name])


def test_decode_logits_over_8_steps(pair):
    """An 8-token prefill on the flash route, then 8 decode steps: each
    step's logits, then the latent caches."""
    jm, jp, tm, tp = pair
    B, P, steps, cache_seq = 2, 8, 8, 16
    toks = _prompt(tm.cfg, B, P + steps, 2)
    _, jc = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp,
                                                   jnp.asarray(toks[:, :P]))
    _, tc = tm.prefill(tp, {"tokens": _t(toks[:, :P]), "cache_seq": cache_seq})
    step = jax.jit(jm.decode_step)
    for t in range(P, P + steps):
        want, jc = step(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                             "pos": jnp.asarray(t, jnp.int32), "cache": jc})
        got, tc = tm.decode_step(tp, {"token": _t(toks[:, t:t + 1]),
                                      "pos": t, "cache": tc})
        _close(got, want, 1e-4)
    for name in jc:
        _close(tc[name], jc[name], 1e-4)


@pytest.mark.parametrize("flash", [True, False])
def test_decode_matches_teacher_forcing(pair, flash):
    """``tests/test_models.py::test_decode_matches_teacher_forcing``'s
    deepseek case in the port: 8 decode steps from an empty cache end at
    the prefill's last-position logits, and write its latent caches
    (float32, 1e-4)."""
    _, _, tm, tp = pair
    B, S = 2, 8
    toks = _t(_prompt(tm.cfg, B, S, 6))
    full, pcache = tm.prefill(tp, {"tokens": toks, "cache_seq": S},
                              flash=flash)
    cache = tm.init_cache(B, S)
    for t in range(S):
        logits, cache = tm.decode_step(tp, {"token": toks[:, t:t + 1],
                                            "pos": t, "cache": cache})
    torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
    for name in ("c_kv", "k_rope"):
        torch.testing.assert_close(cache[name], pcache[name], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_tokens_match_jax_decode_loop(pair, prefetch):
    """Greedy tokens of the port's ``decode_loop_engine`` (and its
    ``decode_loop``) equal JAX's ``decode_loop`` on the reduced deepseek
    (a 12-token prompt, 6 new tokens)."""
    jm, jp, tm, tp = pair
    jm_, jstep = jax_make_serve_step(jm.cfg)
    prompt = _prompt(tm.cfg, 2, 12, 3)
    ref = jax_decode_loop(jm_, jax.jit(jstep), jp, prompt, gen=6,
                          cache_seq=18)
    model, step = make_serve_step(tm.cfg, "cpu")
    own = S.decode_loop(model, step, tp, prompt, gen=6, cache_seq=18)
    out, summary = S.decode_loop_engine(model, step, tp, prompt, gen=6,
                                        cache_seq=18, prefetch=prefetch)
    np.testing.assert_array_equal(out, own)
    np.testing.assert_array_equal(out, ref)
    assert summary["requests"] == 11 + 6


def test_prefill_step_launches_nothing_on_the_cpu(pair):
    _, _, tm, tp = pair
    _, prefill = make_prefill_step(tm.cfg, "cpu")
    before = LAUNCHES["flash_attention"]
    logits, cache = prefill(tp, {"tokens": _t(_prompt(tm.cfg, 1, 6, 7)),
                                 "cache_seq": 8})
    assert LAUNCHES["flash_attention"] == before
    assert bool(torch.isfinite(logits).all())
    assert sorted(cache) == ["c_kv", "k_rope"]


@pytest.mark.parametrize("layers", [[], ["--layers", "1"]])
def test_serve_main_runs_deepseek_on_the_cpu(capsys, monkeypatch, layers):
    """The CLI, and its ``--layers`` depth cut (the model it builds has
    that many layers)."""
    built = []
    real = S.make_serve_step
    monkeypatch.setattr(S, "make_serve_step", lambda cfg, dev: built.append(
        cfg) or real(cfg, dev))
    out = S.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--gen", "3"] + layers)
    assert built[0].num_layers == (int(layers[1]) if layers else 2)
    assert out.shape == (2, 3)
    assert (out >= 0).all() and (out < 256).all()
    assert "arch=deepseek-v2-236b" in capsys.readouterr().out
