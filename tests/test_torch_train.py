"""The port's LM training path against the JAX package's.

The JAX package's reduced dense configurations (float32, ``naive``
attention, no remat) go through both packages from the same state: the JAX
``init_state``'s own, carried across by ``convert.train_state_from_numpy``.
Batches are made from a seed with numpy.  Tolerances (float32, sums in
another order): the loss and ``grad_norm`` within 1e-5 relative, each
gradient leaf within 1e-5 relative L2, the parameters after 3 train steps
within 1e-5 relative L2 over the tree, ``apply_updates`` and
``compress_grads`` each leaf within 1e-5 relative L2; bf16 moments (the
nemotron-4-340b policy) within one bf16 step, 2**-8 relative L2 (an
element on a rounding boundary may round the other way); a bfloat16
compute config's loss and parameters within 2e-2 (bf16 rounding at other
places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMData as JData
from repro.launch.steps import make_eval_step as j_make_eval
from repro.launch.steps import make_train_step as j_make_train
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.serving import prefetch_batches as j_prefetch
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, train_state_from_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as T
from repro_torch.launch.steps import make_eval_step, make_train_step
from repro_torch.models.model import build_model
from repro_torch.models.shardctx import bf16_grad_barrier
from repro_torch.optim import (
    AdamWConfig,
    apply_updates,
    compress_grads,
    global_norm,
    init_compression,
    init_opt_state,
)
from repro_torch.runtime import SimulatedFailure
from repro_torch.serving import prefetch_batches, stage_batch
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["qwen3-14b", "codeqwen1.5-7b", "command-r-35b", "nemotron-4-340b"]
# the MoE family: its loss carries the auxiliary term (``grads_pair``);
# deepseek-v2-236b's attention is MLA (the no-cache route: per-head k and v
# rebuilt from the latent)
MOE_ARCHS = ["mixtral-8x22b", "deepseek-v2-236b"]
TOL = 1e-5
BF16_TOL = 2e-2


def _np(tree):
    """A port tree as numpy in the JAX layout: the per-layer list of
    ``stack`` dicts stacked on a leading layer axis."""
    def host(t):
        return t.detach().float().cpu().numpy() if isinstance(
            t, torch.Tensor) else np.asarray(t)
    out = {k: v for k, v in tree.items() if k != "stack"}
    out = jax.tree.map(host, out)
    if "stack" in tree:
        layers = [tree_map(host, layer) for layer in tree["stack"]]
        out["stack"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return out


def _rel_l2(got, want):
    g = [np.asarray(x, np.float64) for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    num = sum(((a - b) ** 2).sum() for a, b in zip(g, w))
    den = sum((b ** 2).sum() for b in w)
    return float(np.sqrt(num / max(den, 1e-30)))


def _leafwise(got, want, tol):
    gl, wl = jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert _rel_l2(g, w) <= tol, (jax.tree_util.keystr(path),
                                      _rel_l2(g, w))


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _batch(cfg, B=4, S=16, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if masked:
        labels[0, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


def _state(arch, **over):
    """(JAX cfg, JAX step, JAX params, JAX opt, port cfg, port step, port
    params, port opt) from the JAX ``init_state``'s weights."""
    jc, tc = jax_config(arch).reduced(**over), get_config(arch).reduced(**over)
    _, jstep, jinit, _ = j_make_train(jc)
    _, tstep, _, _ = make_train_step(tc, "cpu")
    jp, jo = jinit(jax.random.PRNGKey(0))
    tp, to = train_state_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jo), device="cpu")
    return jc, jax.jit(jstep), jp, jo, tc, tstep, tp, to


def _port_grads(model, params, batch):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.loss_fn(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = tree_map(lambda p: p.grad, params)
    for p in tree_leaves(params):
        p.requires_grad_(False)
        p.grad = None
    return loss.detach(), metrics, grads


@pytest.fixture(scope="module", params=ARCHS + MOE_ARCHS)
def grads_pair(request):
    """The loss, metrics and gradients of one reduced config and batch in
    both packages."""
    jc = jax_config(request.param).reduced()
    tc = get_config(request.param).reduced()
    jm = j_make_train(jc)[0]
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tc, "cpu")
    tp = model_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=True)
    b = _batch(tc, seed=5)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tmet, tg = _port_grads(tm, tp, b)
    return dict(jl=jl, jmet=jmet, jg=jg, tl=tl, tmet=tmet, tg=tg)


def test_loss_fn_matches_jax(grads_pair):
    r = grads_pair
    assert _rel(r["tl"], r["jl"]) <= TOL
    assert _rel(r["tmet"]["loss"], r["jmet"]["loss"]) <= TOL
    assert float(r["tmet"]["tokens"]) == float(r["jmet"]["tokens"]) == 61.0


def test_grads_match_jax_leaf_by_leaf(grads_pair):
    _leafwise(_np(grads_pair["tg"]), jax.tree.map(np.asarray,
                                                  grads_pair["jg"]), TOL)


def test_grad_norm_matches_jax(grads_pair):
    assert _rel(global_norm(grads_pair["tg"]),
                JA.global_norm(grads_pair["jg"])) <= TOL


def test_loss_fn_masks_every_label_and_divides_by_one():
    """All labels < 0: zero tokens, loss 0 (the max(Σ mask, 1) divisor)."""
    tc = get_config("qwen3-14b").reduced()
    tm = build_model(tc, "cpu")
    tp = tm.init(0, master=True)
    b = _batch(tc)
    b["labels"][:] = -1
    loss, m = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(loss) == 0.0 and float(m["tokens"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb", [1, 2])
def test_params_after_3_train_steps(arch, mb):
    """3 ``train_step``s at ``microbatches`` 1 and 2 (gradient accumulation
    into ``.grad``): every step's loss and grad_norm, then the parameters
    and both moments over the tree."""
    jc, jstep, jp, jo, tc, tstep, tp, to = _state(arch, microbatches=mb)
    for s in range(3):
        b = _batch(tc, seed=10 + s)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        assert _rel(tm["loss"], jm["loss"]) <= TOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= TOL
        assert float(tm["tokens"]) == float(jm["tokens"])
    assert _rel_l2(_np(tp), jax.tree.map(np.asarray, jp)) <= TOL
    # bf16 moments (nemotron-4-340b) may round the other way by a bf16 step
    mtol = TOL if tc.opt_dtype == "float32" else 2 ** -8
    for key in ("m", "v"):
        assert _rel_l2(_np(to[key]), jax.tree.map(
            lambda a: np.asarray(a, np.float32), jo[key])) <= mtol
    assert int(to["step"]) == int(jo["step"]) == 3
    assert to["step"].dtype == torch.int32


@pytest.mark.parametrize("arch,mb", [
    ("mixtral-8x22b", 1), ("mixtral-8x22b", 2),
    ("deepseek-v2-236b", 1), ("deepseek-v2-236b", 2)],
    ids=["1", "2", "deepseek-v2-236b-1", "deepseek-v2-236b-2"])
def test_moe_params_after_3_train_steps(arch, mb):
    """mixtral-8x22b and deepseek-v2-236b (MLA; bf16 moments, the config's
    ``opt_dtype``) with the MoE auxiliary term in the loss: 3
    ``train_step``s at ``microbatches`` 1 and 2, every step's loss and
    grad_norm, then the parameters over the tree, as for the dense configs.
    The moments are held one step at a time, against JAX's step from the
    port's own state (bf16 moments within one bf16 step, 2**-8 relative
    L2, as for the dense configs):
    the two runs' moments drift apart by more than their parameters (1.8e-5
    relative L2 at microbatches 2), because the MoE loss's gradient is
    steep there, in both packages alike (from step 0's two states, 3.6e-7
    apart, each package's step-1 gradient moves by 4.3e-5, while the two
    packages agree within 4e-7 at either state)."""
    jc, jstep, jp, jo, tc, tstep, tp, to = _state(arch, microbatches=mb)
    mtol = TOL if tc.opt_dtype == "float32" else 2 ** -8
    for s in range(3):
        b = _batch(tc, seed=10 + s)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        # copies: _np's arrays share the port's buffers, which tstep updates
        # in place while JAX may still be reading them
        state = jax.tree.map(np.array, (_np(tp), {
            "m": _np(to["m"]), "v": _np(to["v"]), "step": to["step"].numpy()}))
        want_p, want_o, _ = jstep(*state, jb)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, b)
        assert _rel(tm["loss"], jm["loss"]) <= TOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= TOL
        assert float(tm["tokens"]) == float(jm["tokens"])
        assert _rel_l2(_np(tp), jax.tree.map(np.asarray, want_p)) <= TOL
        for key in ("m", "v"):
            assert _rel_l2(_np(to[key]), jax.tree.map(
                lambda a: np.asarray(a, np.float32), want_o[key])) <= mtol
    assert _rel_l2(_np(tp), jax.tree.map(np.asarray, jp)) <= TOL
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_leaf_by_leaf(moment_dtype):
    """One AdamW update from the same parameters, gradients and moments at
    step 4 (bias correction in float32), clipping on: each leaf of the
    parameters and moments against JAX.  bf16 moments (the
    nemotron-4-340b policy) stay bf16 and agree within one bf16 step."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 3, 4)}}
    mk = lambda s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    p = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    g = jax.tree.map(lambda a: 3 * mk(a.shape), p)
    m = jax.tree.map(lambda a: 0.1 * mk(a.shape), p)
    v = jax.tree.map(lambda a: np.abs(0.1 * mk(a.shape)), p)
    cfg_j = JA.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    cfg_t = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    md = jnp.dtype(moment_dtype)
    js = {"m": jax.tree.map(lambda a: jnp.asarray(a, md), m),
          "v": jax.tree.map(lambda a: jnp.asarray(a, md), v),
          "step": jnp.asarray(3, jnp.int32)}
    tdt = getattr(torch, moment_dtype)
    t = lambda a, dt=torch.float32: torch.from_numpy(a.copy()).to(dt)  # noqa: E731
    ts = {"m": tree_map(lambda a: t(a, tdt), m),
          "v": tree_map(lambda a: t(a, tdt), v),
          "step": torch.tensor(3, dtype=torch.int32)}
    jp2, js2, jmet = jax.jit(lambda *a: JA.apply_updates(*a, cfg_j))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), js)
    tp2, ts2, tmet = apply_updates(tree_map(t, p), tree_map(t, g), ts, cfg_t)
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= TOL
    assert float(tmet["grad_norm"]) > cfg_t.clip_norm   # the clip applies
    assert int(ts2["step"]) == 4 and ts2["step"].dtype == torch.int32
    _leafwise(_np(tp2), jax.tree.map(np.asarray, jp2), TOL)
    mtol = TOL if moment_dtype == "float32" else 2 ** -8
    for key in ("m", "v"):
        assert all(x.dtype == tdt for x in tree_leaves(ts2[key]))
        _leafwise(_np(ts2[key]), jax.tree.map(
            lambda a: np.asarray(a, np.float32), js2[key]), mtol)


def test_init_opt_state_moment_policy():
    tc = get_config("nemotron-4-340b").reduced()
    assert tc.opt_dtype == "bfloat16"
    params = build_model(tc, "cpu").init(0, master=True)
    st = init_opt_state(params, AdamWConfig(moment_dtype=tc.opt_dtype))
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for x in tree_leaves(st["m"]) + tree_leaves(st["v"]))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"x": rng.normal(0, 2, (30, 20)).astype(np.float32),
            "y": [rng.normal(0, 1, 7).astype(np.float32),
                  rng.normal(0, 1, (2, 2)).astype(np.float32)]}
    assert _rel(global_norm(tree_map(torch.from_numpy, tree)),
                JA.global_norm(jax.tree.map(jnp.asarray, tree))) <= TOL


def test_compress_grads_matches_jax_over_steps():
    """int8 quantisation with error feedback, 3 rounds: each leaf's wire
    value and error-feedback buffer against JAX."""
    rng = np.random.default_rng(4)
    shapes = {"w": (16, 8), "b": (8,), "z": (3,)}
    ef_j = JC.init_compression({k: jnp.zeros(s) for k, s in shapes.items()})
    ef_t = init_compression({k: torch.zeros(s) for k, s in shapes.items()})
    for r in range(3):
        g = {k: rng.normal(0, 10 ** r, s).astype(np.float32)
             for k, s in shapes.items()}
        g["z"][:] = 0.0        # an all-zero leaf: the 1e-12 scale floor
        wj, ef_j = jax.jit(JC.compress_grads)(
            {k: jnp.asarray(a) for k, a in g.items()}, ef_j)
        wt, ef_t = compress_grads({k: torch.from_numpy(a)
                                   for k, a in g.items()}, ef_t)
        _leafwise(_np(wt), jax.tree.map(np.asarray, wj), TOL)
        _leafwise(_np(ef_t["ef"]), jax.tree.map(np.asarray, ef_j["ef"]), TOL)


def test_train_step_with_grad_compress():
    """``grad_compress`` (no config turns it on) through a config override,
    3 steps.  The quantiser rounds, so a gradient that differs from JAX's
    in its last bit may send the neighbouring int8 value, and AdamW's first
    steps turn that into a full ``lr`` step of that element: the runs are
    held to each other one step at a time.  Each step, the port's
    ``train_step`` against JAX's ``compress_grads`` + ``apply_updates`` on
    the port's own state and gradients (parameters, moments and error
    feedback within 1e-5), and its loss against JAX's ``train_step`` on the
    same state."""
    jc, jstep, jp, jo, tc, tstep, tp, to = _state(
        "qwen3-14b", grad_compress=True, microbatches=1)
    assert "comp" in to and tc.grad_compress
    opt_j = JA.AdamWConfig(moment_dtype=jc.opt_dtype)

    @jax.jit
    def j_update(params, opt, grads):
        wire, comp = JC.compress_grads(grads, opt["comp"])
        new_p, new_o, _ = JA.apply_updates(params, wire, opt, opt_j)
        new_o["comp"] = comp
        return new_p, new_o

    tm = build_model(tc, "cpu")
    for s in range(3):
        b = _batch(tc, seed=20 + s)
        jstate = (_np(tp), {"m": _np(to["m"]), "v": _np(to["v"]),
                            "step": np.asarray(to["step"]),
                            "comp": {"ef": _np(to["comp"]["ef"])}})
        _, _, grads = _port_grads(tm, tp, b)
        want_p, want_o = j_update(*jstate, _np(grads))
        _, _, jm = jstep(*jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = tstep(tp, to, b)
        assert _rel(tmet["loss"], jm["loss"]) <= TOL
        assert _rel_l2(_np(tp), jax.tree.map(np.asarray, want_p)) <= TOL
        for key in ("m", "v"):
            assert _rel_l2(_np(to[key]), jax.tree.map(
                np.asarray, want_o[key])) <= TOL
        assert _rel_l2(_np(to["comp"]["ef"]), jax.tree.map(
            np.asarray, want_o["comp"]["ef"])) <= TOL


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_remat_and_chunked_attention_grads(remat, impl):
    """``cfg.remat`` ∈ {none, full, dots} and chunked attention (chunk 8 <
    S = 16, each chunk recomputed in the backward pass): the gradients of
    every policy against JAX's under the same policy."""
    over = dict(remat=remat, attn_impl=impl, attn_chunk=8)
    jc = jax_config("qwen3-14b").reduced(**over)
    tc = get_config("qwen3-14b").reduced(**over)
    jm = j_make_train(jc)[0]
    jp = jm.init(jax.random.PRNGKey(2))
    tm = build_model(tc, "cpu")
    tp = model_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=True)
    b = _batch(tc, seed=6)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, _, tg = _port_grads(tm, tp, b)
    assert _rel(tl, jl) <= TOL
    _leafwise(_np(tg), jax.tree.map(np.asarray, jg), TOL)


def test_remat_policies_give_the_port_the_same_bits():
    """Recomputation changes what is kept, not the arithmetic: the three
    policies' gradients are bitwise equal in the port."""
    out = []
    for remat in ("none", "full", "dots"):
        tc = get_config("qwen3-14b").reduced(remat=remat, attn_impl="chunked",
                                             attn_chunk=8)
        tm = build_model(tc, "cpu")
        tp = tm.init(3, master=True)
        out.append(_np(_port_grads(tm, tp, _batch(tc, seed=8))[2]))
    for other in out[1:]:
        for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(a, b)


def test_bf16_train_steps_close_to_jax():
    """bfloat16 compute over float32 masters (the bf16 gradient barrier
    after each residual add and the final norm on the path): 2 steps, the
    losses and the parameters within 2e-2."""
    over = dict(dtype="bfloat16", attn_impl="chunked", attn_chunk=8,
                remat="full", microbatches=2)
    jc, jstep, jp, jo, tc, tstep, tp, to = _state("qwen3-14b", **over)
    assert tp["stack"][0]["attn"]["wq"].dtype == torch.float32
    for s in range(2):
        b = _batch(tc, seed=30 + s)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        assert _rel(tm["loss"], jm["loss"]) <= BF16_TOL
    assert _rel_l2(_np(tp), jax.tree.map(np.asarray, jp)) <= BF16_TOL


def test_bf16_grad_barrier_retypes_cotangent():
    """Mirrors tests/test_models.py: the barrier is the identity in the
    forward pass, its cotangent is bf16, and fp32 passes through."""
    def f(x, w):
        h = bf16_grad_barrier(x)
        return torch.sum(torch.square((h @ w).float()))

    x = torch.ones((4, 8), dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones((8, 4), dtype=torch.bfloat16)
    f(x, w).backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(bf16_grad_barrier(x), x)
    x32 = torch.ones((4, 8), dtype=torch.float32, requires_grad=True)
    assert bf16_grad_barrier(x32).dtype == torch.float32
    assert bf16_grad_barrier(x32) is x32
    from repro.models.shardctx import bf16_grad_barrier as jb
    jg = jax.grad(lambda a, b: jnp.sum(jnp.square(
        (jb(a) @ b).astype(jnp.float32))))(jnp.ones((4, 8), jnp.bfloat16),
                                           jnp.ones((8, 4), jnp.bfloat16))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(jg, np.float32))


def test_master_params_and_the_serving_cast():
    """``init(master=True)`` and ``model_params_from_numpy(master=True)``
    keep float32 matrices; serving keeps its stored bf16 cast."""
    tc = get_config("qwen3-14b").reduced(dtype="bfloat16")
    tm = build_model(tc, "cpu")
    serve, master = tm.init(0), tm.init(0, master=True)
    assert serve["embed"].dtype == torch.bfloat16
    assert serve["stack"][0]["mlp"]["wg"].dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in tree_leaves(master))
    assert serve["stack"][0]["ln1"]["scale"].dtype == torch.float32
    jp = jax.tree.map(np.asarray, j_make_train(
        jax_config("qwen3-14b").reduced(dtype="bfloat16"))[0].init(
            jax.random.PRNGKey(0)))
    conv = model_params_from_numpy(tc, jp, device="cpu", master=True)
    assert all(x.dtype == torch.float32 for x in tree_leaves(conv))
    np.testing.assert_array_equal(conv["embed"].numpy(), jp["embed"])
    cast = model_params_from_numpy(tc, jp, device="cpu")
    assert cast["embed"].dtype == torch.bfloat16
    # the same prefill logits from the masters (cast at each product) and
    # from the stored cast
    toks = {"tokens": torch.from_numpy(_batch(tc)["tokens"])}
    with torch.no_grad():
        a, _ = tm.prefill(conv, toks, flash=False)
        b, _ = tm.prefill(cast, toks, flash=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-14b", "command-r-35b"])
def test_eval_step_matches_jax(arch):
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    jm, jeval = j_make_eval(jc)
    jp = jm.init(jax.random.PRNGKey(4))
    _, teval = make_eval_step(tc, "cpu")
    tp = model_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=True)
    b = _batch(tc, seed=9)
    want = jax.jit(jeval)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = teval(tp, b)
    assert _rel(got["loss"], want["loss"]) <= TOL
    assert float(got["tokens"]) == float(want["tokens"])


def test_synthetic_lm_data_equals_jax():
    """Mirrors tests/test_fault.py's data test: deterministic in (seed,
    step), and the same tokens as the JAX package's."""
    d1, d2 = SyntheticLMData(1000, 4, 32, seed=9), SyntheticLMData(
        1000, 4, 32, seed=9)
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d1.batch_at(17)["tokens"],
                              d1.batch_at(18)["tokens"])
    jd = JData(1000, 4, 32, seed=9)
    for step in (0, 17, 123):
        want, got = jd.batch_at(step), d1.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(next(iter(d1))["labels"],
                                  jd.batch_at(0)["labels"])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_batches_keeps_order_and_depth(depth):
    """The staged batches come out in order, with ``depth`` more staged
    ahead of the one the caller gets (and no more); the same sequence of
    stage calls as the JAX package's."""
    def run(prefetch):
        log = []

        def stage(x):
            log.append(("stage", x))
            return x * 10

        out = []
        for y in prefetch(iter(range(6)), stage, depth=depth):
            staged = sum(1 for e in log if e[0] == "stage")
            assert staged - len(out) == min(depth + 1, 6 - len(out))
            log.append(("yield", y))
            out.append(y)
        return out, log

    got, log = run(prefetch_batches)
    assert got == [10 * i for i in range(6)]
    assert log[:depth + 1] == [("stage", i) for i in range(depth + 1)]
    assert run(j_prefetch) == (got, log)
    assert list(prefetch_batches([1, 2], depth=3)) == [1, 2]
    with pytest.raises(ValueError, match="depth"):
        list(prefetch_batches([1], depth=0))


def test_stage_batch_on_the_cpu():
    b = _batch(get_config("qwen3-14b").reduced())
    out = stage_batch(b, "cpu")
    for key in b:
        assert out[key].device.type == "cpu"
        np.testing.assert_array_equal(out[key].numpy(), b[key])


def test_train_main_fails_and_resumes(tmp_path, capsys):
    """The driver's flags (``--reduce``, ``--layers``, ``--fail-at``,
    ``--resume``) on the CPU: a failure at step 4 with checkpoints every
    2, then ``--resume`` from step 4 to the end."""
    argv = ["--arch", "qwen3-14b", "--reduce", "--layers", "3", "--steps",
            "6", "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "2"]
    with pytest.raises(SimulatedFailure):
        T.main(argv + ["--fail-at", "4"], device="cpu")
    hist = T.main(argv + ["--resume"], device="cpu")
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and "steps=4->6" in out
    assert [h["step"] for h in hist] == [6]
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2", "step_4", "step_6"]


def test_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-14b").reduced()
    for make in (make_train_step, make_eval_step):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        T.build(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        T.main(["--arch", "qwen3-14b", "--reduce", "--steps", "1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_steps_deterministic_and_close_to_cpu(cuda_device):
    """3 steps of the reduced config on the card twice (bitwise equal) and
    on the CPU (within 1e-5 relative L2)."""
    tc = dataclasses.replace(get_config("qwen3-14b").reduced(),
                             microbatches=2)
    runs = []
    for device in ("cpu", cuda_device, cuda_device):
        _, step, init, _ = make_train_step(tc, "cpu")
        p, o = init(0)
        p = tree_map(lambda t: t.to(device), p)
        o = tree_map(lambda t: t.to(device), o)
        _, step, _, _ = make_train_step(tc, device)
        for s in range(3):
            p, o, _ = step(p, o, _batch(tc, seed=40 + s))
        runs.append(_np(p))
    for a, b in zip(jax.tree.leaves(runs[1]), jax.tree.leaves(runs[2])):
        np.testing.assert_array_equal(a, b)
    assert _rel_l2(runs[1], runs[0]) <= TOL
