"""The port's MoE family (mixtral-8x22b) and SWA ring cache against the JAX
package's.

The JAX package's reduced mixtral-8x22b (float32, ``naive`` attention) goes
through both packages with the same weights: the JAX model's own, carried
across by ``convert.model_params_from_numpy``.  Inputs are made from a
seed with numpy.  Tolerances: ``apply_moe``'s output 1e-5 and its
``aux_loss`` 1e-6 (float32, sums in another order), its ``expert_counts``
exactly, bfloat16 2e-2 (bf16 rounding at other places); the prefill's
logits and caches 1e-5, decode logits 1e-4 over 8 steps (differences
compound through the cache); the ring cache within 2e-3 of a full cache
(the reference test's bound) and within 1e-4 of JAX's ring, its ``kpos``
exactly; greedy tokens and routing counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.moe_placement import alltoall_traffic as j_alltoall_traffic
from repro.core.moe_placement import \
    build_expert_placement as j_build_expert_placement
from repro.launch.serve import decode_loop as jax_decode_loop
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import moe as JMOE
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import model_params_from_numpy
from repro_torch.core.moe_placement import (
    alltoall_traffic,
    build_expert_placement,
)
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models.model import build_model

ARCH = "mixtral-8x22b"
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _port_moe(p, cfg):
    """The port's MoE parameters from the reference's (numpy): matrices in
    the compute dtype, the router float32."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for name, a in p.items():
        if isinstance(a, dict):
            out[name] = {n: _t(np.asarray(b, np.float32)).to(dt)
                         for n, b in a.items()}
        else:
            out[name] = _t(np.asarray(a, np.float32)).to(
                torch.float32 if name == "router" else dt)
    return out


# ------------------------------------------------------------------ config
def test_mixtral_config_equals_jax_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(jax_config(ARCH).reduced())


@pytest.mark.parametrize("over", [{}, dict(moe_capacity_factor=0.5),
                                  dict(num_experts=16, num_experts_per_tok=4)])
def test_capacity_matches_jax(over):
    for cfgs in ((get_config(ARCH), jax_config(ARCH)),
                 (get_config(ARCH).reduced(**over),
                  jax_config(ARCH).reduced(**over))):
        for tokens in list(range(1, 600, 7)) + [4, 8, 4096, 16_384, 65_536]:
            assert TMOE.capacity(cfgs[0], tokens) == \
                JMOE.capacity(cfgs[1], tokens), tokens
    assert TMOE.capacity(get_config(ARCH), 16_384) == 5120
    assert TMOE.capacity(get_config(ARCH), 4) == 8


# ------------------------------------------------------------------ apply_moe
MOE_CASES = {
    "plain": ({}, TOL),
    "drops": (dict(moe_capacity_factor=0.5), TOL),   # C = 8 of 16 a expert
    "shared": (dict(num_shared_experts=1), TOL),
    "tied": ({}, TOL),
    "bf16": (dict(dtype="bfloat16"), 2e-2),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case):
    """Out, ``aux_loss`` and ``expert_counts`` against JAX's ``apply_moe``
    on the same weights and input: forced capacity drops, a shared
    expert, tied router columns (the lower expert wins a tie, as in
    ``jax.lax.top_k``) and bfloat16."""
    over, tol = MOE_CASES[case]
    jcfg = jax_config(ARCH).reduced(**over)
    tcfg = get_config(ARCH).reduced(**over)
    jp = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(7), jcfg))
    if case == "tied":   # experts 1 and 2 route alike: a tie at the K boundary
        jp["router"] = np.array(jp["router"])
        jp["router"][:, 2] = jp["router"][:, 1]
    tp = _port_moe(jp, tcfg)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 16, tcfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(jcfg.dtype), getattr(torch, tcfg.dtype)
    want, winfo = JMOE.apply_moe(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(x).astype(jdt), jcfg, dtype=jdt,
                                 return_aux=True)
    got, ginfo = TMOE.apply_moe(tp, _t(x).to(tdt), tcfg, dtype=tdt,
                                return_aux=True)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got.float(), np.asarray(want, np.float32), tol)
    assert abs(float(ginfo["aux_loss"]) - float(winfo["aux_loss"])) <= 1e-6
    assert ginfo["expert_counts"].dtype == torch.int32
    np.testing.assert_array_equal(ginfo["expert_counts"].numpy(),
                                  np.asarray(winfo["expert_counts"]))
    T = x.shape[0] * x.shape[1]
    if case == "drops":
        assert int(ginfo["expert_counts"].max()) > TMOE.capacity(tcfg, T)
    if case == "tied":
        xt = _t(x).reshape(T, -1)
        probs, _, top_e = TMOE._route(tp, xt, tcfg)
        _, _, j_top_e = JMOE._route(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x).reshape(T, -1), jcfg)
        assert torch.equal(probs[:, 1], probs[:, 2])
        np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top_e))
        # some token's second choice is the tie: expert 1 taken, 2 left
        assert bool(((top_e[:, 1] == 1) & (top_e[:, 0] != 2)).any())
        assert not bool(((top_e[:, 1] == 2) & (top_e[:, 0] != 1)).any())


def test_init_moe_keeps_the_router_float32():
    cfg = get_config(ARCH).reduced(dtype="bfloat16", num_shared_experts=1)
    p = build_model(cfg, "cpu").init(0)
    moe = p["stack"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].dtype == moe["shared"]["wd"].dtype == torch.bfloat16
    assert tuple(moe["wd"].shape) == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    assert "mlp" not in p["stack"][0]


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    mixtral with a window of 8, the weights the JAX model's own."""
    jcfg = jax_config(ARCH).reduced(swa_window=8)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH).reduced(swa_window=8)
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jm, jp, build_model(tcfg, "cpu"), tp


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_convert_carries_the_moe_leaves(pair):
    jm, jp, tm, tp = pair
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert tm.param_count(tp) == n_jax
    for name in ("router", "wg", "wu", "wd"):
        np.testing.assert_array_equal(
            tp["stack"][1]["moe"][name].numpy(),
            np.asarray(jp["stack"]["moe"][name][1]))
    assert tp["stack"][0]["moe"]["router"].dtype == torch.float32
    bf = dataclasses.replace(tm.cfg, dtype="bfloat16")
    served = model_params_from_numpy(bf, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    master = model_params_from_numpy(bf, jax.tree.map(np.asarray, jp),
                                     device="cpu", master=True)
    assert served["stack"][0]["moe"]["wg"].dtype == torch.bfloat16
    assert served["stack"][0]["moe"]["router"].dtype == torch.float32
    assert master["stack"][0]["moe"]["wg"].dtype == torch.float32


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_logits_and_cache(pair, flash):
    """Prefill at S = 20 with a window of 8: last-position logits and every
    cache leaf; ``flash`` runs the flash kernel's plain version on the
    CPU, else the naive route."""
    jm, jp, tm, tp = pair
    B, S, cache_seq = 2, 20, 24
    toks = _prompt(tm.cfg, B, S, 1)
    want, wcache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp, jnp.asarray(toks))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks), "cache_seq": cache_seq},
                             flash=flash)
    assert got.shape == (B, tm.cfg.padded_vocab)
    _close(got, want)
    assert sorted(gcache) == sorted(wcache) == ["k", "v"]
    for name in wcache:
        _close(gcache[name], wcache[name])


def test_decode_logits_over_8_steps_past_the_window(pair):
    """A 16-token prefill, then 8 decode steps (positions 16-23, the window
    of 8 masking most of the cache): each step's logits, then the caches."""
    jm, jp, tm, tp = pair
    B, P, steps, cache_seq = 2, 16, 8, 24
    toks = _prompt(tm.cfg, B, P + steps, 2)
    _, jc = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t, "cache_seq": cache_seq}))(jp,
                                                   jnp.asarray(toks[:, :P]))
    _, tc = tm.prefill(tp, {"tokens": _t(toks[:, :P]), "cache_seq": cache_seq},
                       flash=False)
    step = jax.jit(jm.decode_step)
    for t in range(P, P + steps):
        want, jc = step(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                             "pos": jnp.asarray(t, jnp.int32), "cache": jc})
        got, tc = tm.decode_step(tp, {"token": _t(toks[:, t:t + 1]),
                                      "pos": t, "cache": tc})
        _close(got, want, 1e-4)
    for name in jc:
        _close(tc[name], jc[name], 1e-4)


def test_swa_ring_buffer_decode(pair):
    """``tests/test_models.py::test_swa_ring_buffer_decode`` in the port: 24
    steps through a ring of W = 8 slots and a 64-slot full cache, finite
    and within 2e-3 of each other; and the port's ring against JAX's ring
    within 1e-4, its ``kpos`` equal."""
    jm, jp, tm, tp = pair
    B, W = 1, 8
    ring, full = tm.init_cache(B, W, ring=True), tm.init_cache(B, 64)
    assert ring["kpos"].dtype == torch.int32
    assert tuple(ring["kpos"].shape) == (tm.cfg.num_layers, W)
    assert bool((ring["kpos"] == -(2**30)).all())
    jring = jm.init_cache(B, W, ring=True)
    step = jax.jit(jm.decode_step)
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, size=24)
    for t, tok in enumerate(toks):
        tk = torch.full((B, 1), int(tok), dtype=torch.int32)
        lr, ring = tm.decode_step(tp, {"token": tk, "pos": t, "cache": ring})
        lf, full = tm.decode_step(tp, {"token": tk, "pos": t, "cache": full})
        want, jring = step(jp, {"token": jnp.full((B, 1), int(tok), jnp.int32),
                                "pos": jnp.asarray(t, jnp.int32),
                                "cache": jring})
        assert bool(torch.isfinite(lr).all())
        _close(lr, lf, 2e-3)
        _close(lr, want, 1e-4)
    np.testing.assert_array_equal(ring["kpos"].numpy(),
                                  np.asarray(jring["kpos"]))
    for name in ("k", "v"):
        _close(ring[name], jring[name], 1e-4)


def test_ring_cache_takes_one_token_a_call(pair):
    """The reference reaches its ring branch one token at a time; a longer
    write would have its slot clamped by ``dynamic_update_slice``.  The
    port refuses it, and the flash route, with ValueError."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    ring = tm.init_cache(2, 8, ring=True)
    layer = {name: c[0] for name, c in ring.items()}
    x = torch.zeros((2, 3, cfg.d_model))
    pos = torch.arange(3, dtype=torch.int32).expand(2, 3)
    p = tp["stack"][0]["attn"]
    with pytest.raises(ValueError, match="one token a call"):
        TL.attention_block(p, x, cfg, pos, kv_cache=layer, cache_len=0,
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="flash route"):
        TL.attention_block(p, x[:, :1], cfg, pos[:, :1], kv_cache=layer,
                           cache_len=0, dtype=torch.float32, flash=True)


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_tokens_match_jax_decode_loop(pair, prefetch):
    """Greedy tokens of the port's ``decode_loop_engine`` (and its
    ``decode_loop``) equal JAX's ``decode_loop`` on the reduced mixtral
    (window 8, a 12-token prompt, 6 new tokens: the window bites)."""
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


def test_serve_main_runs_mixtral_on_the_cpu(capsys):
    out = S.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 3)
    assert "arch=mixtral-8x22b" in capsys.readouterr().out


# ------------------------------------------------------------------ routing
def _routing_counts_both(jcfg, tcfg):
    """``examples/moe_placement.py``'s flow in both packages: layer 0's
    routing counts over 32 token groups of 6 domains."""
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    jmoe = jax.tree.map(lambda a: a[0], jp["stack"])["moe"]
    tmoe = tp["stack"][0]["moe"]
    rng = np.random.default_rng(0)
    domains = rng.normal(0, 1, (6, tcfg.d_model)) * 2.5
    jc, tc = [], []
    for g in range(32):
        x = (domains[g % 6] + rng.normal(0, 0.25, (1, 16, tcfg.d_model))
             ).astype(np.float32)
        _, ja = JMOE.apply_moe(jmoe, jnp.asarray(x), jcfg, dtype=jnp.float32,
                               return_aux=True)
        _, ta = TMOE.apply_moe(tmoe, _t(x), tcfg, dtype=torch.float32,
                               return_aux=True)
        jc.append(np.asarray(ja["expert_counts"]))
        tc.append(ta["expert_counts"].numpy())
    return np.stack(jc), np.stack(tc)


@pytest.mark.parametrize("backend", ["host", "device_scan"])
def test_moe_placement_flow_matches_jax(backend):
    """The routing counts of ``examples/moe_placement.py`` at the reduced
    mixtral with 16 experts and top-4 are equal, and so is
    ``build_expert_placement`` of them at k = 4 and its all-to-all
    traffic (the port's device_scan also refines on its device route)."""
    over = dict(num_experts=16, num_experts_per_tok=4)
    jcounts, tcounts = _routing_counts_both(jax_config(ARCH).reduced(**over),
                                            get_config(ARCH).reduced(**over))
    np.testing.assert_array_equal(tcounts, jcounts)
    assert tcounts.shape == (32, 16) and (tcounts.sum(1) == 16 * 4).all()
    refine = "device" if backend == "device_scan" else "host"
    got = build_expert_placement(tcounts, 4, backend=backend, device="cpu",
                                 refine_backend=refine)
    want = j_build_expert_placement(jcounts, 4, backend=backend)
    for f in dataclasses.fields(want):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name
    assert alltoall_traffic(tcounts, got) == j_alltoall_traffic(jcounts, want)


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b",
                                  "xlstm-350m", "zamba2-2.7b"])
def test_convert_refuses_what_build_model_refuses(arch):
    """``convert`` refuses exactly the families ``build_model`` refuses:
    whisper-medium's encoder-decoder, ported, is refused by neither (what
    it carries across, tests/test_torch_encdec.py checks)."""
    cfg = ModelConfig(**dataclasses.asdict(jax_config(arch).reduced()))
    try:
        build_model(cfg, "cpu")
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            model_params_from_numpy(cfg, {"stack": {}}, device="cpu")
        return
    jm = jax_build(jax_config(arch).reduced())
    model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
        device="cpu")


# ---------------------------------------------------- the ordered backward
def _dispatch_slots(seed, T, E, K):
    """A routing's sorted token ids ``st`` as ``_pack_compute_combine``
    makes them: every token K times, grouped by expert."""
    rng = np.random.default_rng(seed)
    top_e = torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                       for _ in range(T)]))
    order = torch.argsort(top_e.reshape(-1), stable=True)
    return (torch.arange(T * K) // K)[order]


@pytest.mark.parametrize("T,E,K", [(32, 8, 2), (40, 16, 6), (7, 4, 1)])
def test_slot_gather_backward_equals_the_index_backward(T, E, K):
    """``_SlotGather``'s ordered backward against the default backward of
    ``xt[st]`` (an ``index_put_`` accumulation), float32, within 1e-6
    relative and absolute; the forward is the same gather."""
    st = _dispatch_slots(T, T, E, K)
    rng = np.random.default_rng(T + K)
    x = _t(rng.normal(0, 1, (T, 24)).astype(np.float32))
    g = _t(rng.normal(0, 1, (T * K, 24)).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = TMOE._gather_slots(a, st, K)
    yb = b[st]
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    with torch.no_grad():   # no autograd function when nothing needs it
        assert torch.equal(TMOE._gather_slots(a, st, K), yb)


def test_apply_moe_grads_use_the_ordered_backward():
    """The reduced mixtral's MoE layer: the input's gradient with the
    ordered gather equals, within 1e-6, the one with the default index
    backward put back in its place."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    tp = _port_moe(jax.tree.map(np.asarray,
                                JMOE.init_moe(jax.random.PRNGKey(3), jcfg)),
                   tcfg)
    x0 = _t(np.random.default_rng(4).normal(0, 1, (2, 16, tcfg.d_model))
            .astype(np.float32))
    grads = []
    for gather in (TMOE._gather_slots, lambda xt, st, K: xt[st]):
        x = x0.clone().requires_grad_()
        saved, TMOE._gather_slots = TMOE._gather_slots, gather
        try:
            TMOE.apply_moe(tp, x, tcfg, dtype=torch.float32).square().sum() \
                .backward()
        finally:
            TMOE._gather_slots = saved
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
