"""Checks shared by the family tests of the port (``test_torch_vlm.py``,
``test_torch_xlstm.py``, ``test_torch_hybrid.py``): one reduced
configuration through both packages with the JAX model's own weights,
carried across by ``convert``.  Inputs are made from a seed with numpy.

Tolerances: 1e-5 for the loss, the gradients (relative L2 a leaf), the
grad norm and a train step's parameters and moments (float32, sums in
another order); 1e-4 for 8 decode steps' logits (element by element) and
every state leaf (relative L2 a leaf; the differences compound through
the states); greedy tokens exactly.

The recurrent families' gradients are steeper than float32's last bit:
JAX's own gradient moves by more than 1e-5 relative when its weights move
by about half an ulp (``perturbed``; on the tests' weights and batches by
up to 3.0e-4 a leaf, and 2.0e-3 for the reduced xlstm-350m's mLSTM input
gate bias ``b_i``, whose gradient is a sum that nearly cancels; 1.2e-6
for the dense configs).  Their checks pass ``spread=True``: each
gradient-derived quantity is held within ``spread_bound``: the larger of
1e-5 and ``SPREAD_FACTOR`` times the largest distance from JAX's value to
JAX's own at three perturbed weights, capped at ``SPREAD_CAP``; the test
asserts that this distance exceeds 1e-5 somewhere (the floor is real).
Two implementations that round differently at every operation land
farther apart than one does from itself under a half-ulp change of its
weights: the port's distance was up to 3.4 times that spread
(zamba2-2.7b's grad norm under remat), hence the factor 4.  The cap, 1e-2,
lies above the largest spread (2.0e-3) times 4 and far below the O(1)
error of a wrong gradient.  ``spread_report`` (run this file) prints every
such quantity with its error, spread and bound.

The bfloat16 cases hold the port to JAX at bf16 within a fraction of
JAX's own bf16 distance from its float32 run (``bf16_matches``,
``bf16_block_matches``), so a port that rounds at other points, or not
at all, fails: blocks within ``BF16_BLOCK_FRACTION`` (0.25) of it, the
whole reduced model within ``BF16_MODEL_FRACTION`` (0.5; the hybrid's
shared attention layer rounds its MLP's silu once, as the dense
families do, where JAX rounds each operation of its sigmoid).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import decode_loop as jax_decode_loop
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, train_state_from_numpy
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim import global_norm
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

TOL = 1e-5
DECODE_TOL = 1e-4
SPREAD_FACTOR = 4
SPREAD_CAP = 1e-2
BF16_BLOCK_FRACTION = 0.25
BF16_MODEL_FRACTION = 0.5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def jax_layout(tree):
    """A port tree as numpy in the JAX layout: every list (the per-layer
    and per-group lists of the stacks) stacked on a new leading axis,
    tuples kept, tensors as float32 arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    if isinstance(tree, dict):
        return {k: jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(jax_layout(v) for v in tree)
    if isinstance(tree, list):
        items = [jax_layout(v) for v in tree]
        return jax.tree.map(lambda *xs: np.stack(xs), *items)
    return np.asarray(tree)


def rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((g - w) ** 2).sum() / max((w ** 2).sum(), 1e-30)))


def rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def same_leaves(got, want, tol, what="", by_leaf=False):
    """Every leaf of the port tree ``got`` (in the JAX layout) within
    ``tol`` of the JAX tree ``want``, paths and shapes equal: element by
    element (atol = rtol = tol), or with ``by_leaf`` in relative L2 a leaf
    (recurrent states, whose entries range over orders of magnitude)."""
    gl = jax.tree.leaves_with_path(jax_layout(got))
    wl = jax.tree.leaves_with_path(jax.tree.map(np.asarray, want))
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        name = f"{what}{jax.tree_util.keystr(path)}"
        assert g.shape == w.shape, name
        if by_leaf:
            assert rel_l2(g, w) <= tol, (name, rel_l2(g, w))
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       atol=tol, rtol=tol, err_msg=name)


def configs(arch, **over):
    """(JAX config, port config) of the reduced ``arch``."""
    return (jax_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def make_pair(arch, seed=0, master=False, jp=None, **over):
    """(JAX model, JAX params, port model, port params) of the reduced
    ``arch``, the weights the JAX model's own (``jp`` when given: options
    in ``over`` that change no parameter shape may reuse another pair's)."""
    jcfg, tcfg = configs(arch, **over)
    jm = jax_build(jcfg)
    if jp is None:
        jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=master)
    return jm, jp, build_model(tcfg, "cpu"), tp


def prompt(cfg, B, S_, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


def batch(cfg, B=4, S_=16, seed=0):
    """Tokens, labels (3 masked) and, for the VLM, patches normal(0, 0.1),
    as ``tests/test_models.py`` makes them."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    labels[0, :3] = -1
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
         "labels": labels}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            0, 0.1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def config_equal(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_config(arch).reduced())


def convert_keeps_every_leaf(pair):
    """Every leaf carried across, in the JAX layout, equal and the leaf
    count equal; at bfloat16 compute, each leaf's dtype that of the
    port's own ``init``.  Returns the bf16 tree."""
    jm, jp, tm, tp = pair
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert tm.param_count(tp) == n_jax
    same_leaves(tp, jp, 0.0, "convert")
    bcfg = dataclasses.replace(tm.cfg, dtype="bfloat16")
    conv = model_params_from_numpy(bcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    own = build_model(bcfg, "cpu").init(0)
    assert {p: x.dtype for p, x in tree_leaves_with_path(conv)} == \
        {p: x.dtype for p, x in tree_leaves_with_path(own)}
    return conv


def bf16_leaves(params):
    """The names of the bfloat16 leaves of ``params``."""
    return {p[-1] for p, x in tree_leaves_with_path(params)
            if x.dtype == torch.bfloat16}


def perturbed(tree, seed=0):
    """``tree``'s float32 leaves times (1 + 6e-8 N(0, 1)): each moved by
    about half an ulp, to its neighbour or not."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        return a * (1 + 6e-8 * rng.standard_normal(a.shape)).astype(
            np.float32)

    return jax.tree.map(one, tree)


def loss_and_grads(pair, b, spread=False):
    """(JAX loss, metrics, grads; port loss, metrics, grads) of ``b`` from
    the same float32 master weights; with ``spread``, also JAX's grads at
    ``perturbed`` weights (``jg_spread``)."""
    jm, jp, tm, _ = pair
    tp = model_params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu", master=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    (jl, jmet), jg = fn(jp, jb)
    out = {}
    if spread:   # the farthest of three perturbations, leaf by leaf
        out["jg_spread"] = [fn(perturbed(jp, seed), jb)[1]
                            for seed in range(3)]
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, {k: t(v) for k, v in b.items()})
    tl.backward()
    tg = tree_map(lambda p: p.grad, tp)
    return dict(out, jl=jl, jmet=jmet, jg=jg, tl=tl.detach(), tmet=tmet,
                tg=tg)


def spread_bound(spread, tol=TOL):
    """The bound of a quantity whose JAX spread is ``spread``: the larger
    of ``tol`` and ``SPREAD_FACTOR`` times it, capped at ``SPREAD_CAP``."""
    return min(max(tol, SPREAD_FACTOR * spread), SPREAD_CAP)


def grads_match(r, tol=TOL):
    """The loss within ``tol`` relative; every gradient leaf within ``tol``
    relative L2 and the global norm within ``tol`` relative, or, where the
    result carries ``jg_spread``, within ``spread_bound`` of JAX's own
    spread (which must exceed ``tol`` somewhere).  Returns a row a leaf
    (and one for the norm): (name, error, spread, bound)."""
    assert rel(r["tl"], r["jl"]) <= tol
    assert float(r["tmet"]["tokens"]) == float(r["jmet"]["tokens"])
    gl = jax.tree.leaves_with_path(jax_layout(r["tg"]))
    wl = jax.tree.leaves_with_path(jax.tree.map(np.asarray, r["jg"]))
    runs = r.get("jg_spread", [])
    sl = list(zip(*(jax.tree.leaves(jax.tree.map(np.asarray, g))
                    for g in runs))) if runs else [()] * len(wl)
    assert [p for p, _ in gl] == [p for p, _ in wl] and len(sl) == len(wl)
    rows = []
    for (path, g), (_, w), s in zip(gl, wl, sl):
        spread = max((rel_l2(x, w) for x in s), default=0.0)
        rows.append((jax.tree_util.keystr(path), rel_l2(g, w), spread,
                     spread_bound(spread, tol) if s else tol))
    spread = max((rel(JA.global_norm(g), JA.global_norm(r["jg"]))
                  for g in runs), default=0.0)
    rows.append(("grad_norm", rel(global_norm(r["tg"]),
                                  JA.global_norm(r["jg"])), spread,
                 spread_bound(spread, tol) if runs else tol))
    for name, err, _, bound in rows:
        assert err <= bound, (name, err, bound)
    if runs:
        assert max(s for _, _, s, _ in rows) > tol
    return rows


def decode_8_steps(pair, cache_seq=10, seed=2, tol=DECODE_TOL):
    """8 decode steps from empty states: each step's logits within ``tol``
    element by element, then every state leaf within ``tol`` relative
    L2."""
    jm, jp, tm, tp = pair
    B, steps = 2, 8
    toks = prompt(tm.cfg, B, steps, seed)
    step = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(B, cache_seq), tm.init_cache(B, cache_seq)
    for s in range(steps):
        want, jc = step(jp, {"token": jnp.asarray(toks[:, s:s + 1]),
                             "pos": jnp.asarray(s, jnp.int32), "cache": jc})
        got, tc = tm.decode_step(tp, {"token": t(toks[:, s:s + 1]),
                                      "pos": s, "cache": tc})
        close(got.float(), want, tol)
    same_leaves(tc, jc, tol, "state", by_leaf=True)
    return tc


def engine_tokens(pair, prefetch, P=12, gen=6):
    """Greedy tokens of the port's ``decode_loop_engine`` and
    ``decode_loop`` equal JAX's ``decode_loop`` (which warms the states by
    stepping the prompt, as the port's does)."""
    jm, jp, tm, tp = pair
    jm_, jstep = jax_make_serve_step(jm.cfg)
    p = prompt(tm.cfg, 2, P, 12)
    ref = jax_decode_loop(jm_, jax.jit(jstep), jp, p, gen=gen,
                          cache_seq=P + gen)
    model, step = make_serve_step(tm.cfg, "cpu")
    own = S.decode_loop(model, step, tp, p, gen=gen, cache_seq=P + gen)
    out, summary = S.decode_loop_engine(model, step, tp, p, gen=gen,
                                        cache_seq=P + gen, prefetch=prefetch)
    np.testing.assert_array_equal(own, ref)
    np.testing.assert_array_equal(out, ref)
    assert summary["requests"] == P - 1 + gen


def _tree_rel(got, want):
    """Relative L2 over two trees of arrays (``got`` in the JAX layout)."""
    g = jax.tree.leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    num = sum(((np.asarray(a, np.float64) - np.asarray(b, np.float64))
               ** 2).sum() for a, b in zip(g, w))
    den = sum((np.asarray(b, np.float64) ** 2).sum() for b in w)
    return float(np.sqrt(num / den))


def train_step_matches(arch, mb, seed=10, spread=False):
    """One ``train_step`` from the JAX ``init_state``'s state at
    ``microbatches`` ``mb``: its loss and tokens, then its grad_norm, the
    parameters and both moments over the tree within 1e-5 relative L2 (with
    ``spread``, within the larger of 1e-5 and ``SPREAD_FACTOR`` times JAX's
    own distance to its steps from ``perturbed`` parameters)."""
    jc, tc = configs(arch, microbatches=mb)
    _, jstep, jinit, _ = jax_make_train_step(jc)
    _, tstep, _, _ = make_train_step(tc, "cpu")
    jp, jo = jax.jit(jinit)(jax.random.PRNGKey(0))
    tp, to = train_state_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jo),
                                    device="cpu")
    b = batch(tc, seed=seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jstep = jax.jit(jstep)
    runs = [jstep(perturbed(jp, seed), jo, jb) for seed in
            range(3 if spread else 0)]
    jp, jo, jm = jstep(jp, jo, jb)
    tp, to, tm = tstep(tp, to, b)
    assert rel(tm["loss"], jm["loss"]) <= TOL
    assert float(tm["tokens"]) == float(jm["tokens"])
    f32 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float32))
    pairs = {"grad_norm": (rel(tm["grad_norm"], jm["grad_norm"]), max(
                 [rel(sm["grad_norm"], jm["grad_norm"]) for _, _, sm in runs],
                 default=0.0)),
             "params": (_tree_rel(jax_layout(tp), f32(jp)), max(
                 [_tree_rel(f32(sp), f32(jp)) for sp, _, _ in runs],
                 default=0.0))}
    for key in ("m", "v"):
        pairs[key] = (_tree_rel(jax_layout(to[key]), f32(jo[key])), max(
            [_tree_rel(f32(so[key]), f32(jo[key])) for _, so, _ in runs],
            default=0.0))
    rows = [(name, err, own, spread_bound(own) if spread else TOL)
            for name, (err, own) in pairs.items()]
    for name, err, own, bound in rows:
        assert err <= bound, (name, err, own, bound)
    if spread:
        assert max(own for _, _, own, _ in rows) > TOL
    assert int(to["step"]) == int(jo["step"]) == 1
    return rows


def bf16_close(got, want, ref, fraction, what=""):
    """``got`` (the port at bf16) within ``fraction`` of JAX's own bf16
    distance from its float32 run (``want`` against ``ref``), relative L2;
    where JAX's bf16 and float32 agree (a float32 path), within 1e-6."""
    got, want, ref = (np.asarray(a, np.float32) for a in (got, want, ref))
    err, own = rel_l2(got, want), rel_l2(want, ref)
    assert err <= max(fraction * own, 1e-6), (what, err, own)
    return err, own


def _flat(o):
    """The arrays of a block's result (tuples, dicts by sorted key, None
    dropped) as float32 numpy arrays."""
    if o is None:
        return []
    if isinstance(o, (tuple, list)):
        return [a for v in o for a in _flat(v)]
    if isinstance(o, dict):
        return [a for k in sorted(o) for a in _flat(o[k])]
    if isinstance(o, torch.Tensor):
        return [o.detach().float().numpy()]
    return [np.asarray(o, np.float32)]


def bf16_block_matches(jfn, tfn, jp, tp, x, **kw):
    """A block at bf16 in both packages against JAX's at float32, from
    the same bf16-rounded input x (B, L, D): the output and every returned
    state leaf within ``BF16_BLOCK_FRACTION`` (``bf16_close``), and JAX's
    bf16 output away from its float32 one.  ``kw`` is passed to both
    blocks; states in it are JAX arrays or port tensors alike."""
    xb = jnp.asarray(x, jnp.bfloat16)
    x32 = np.asarray(xb, np.float32)

    def to_t(v):
        return tuple(t(a) for a in v) if isinstance(v, tuple) else v

    jb = jfn(jp, xb, dtype=jnp.bfloat16, **kw)
    jf = jfn(jp, jnp.asarray(x32), dtype=jnp.float32, **kw)
    tb = tfn(tp, t(x32).bfloat16(), dtype=torch.bfloat16,
             **{k: to_t(v) for k, v in kw.items()})
    jbl, jfl, tbl = _flat(jb), _flat(jf), _flat(tb)
    assert len(jbl) == len(jfl) == len(tbl)
    rows = [bf16_close(g, w, r, BF16_BLOCK_FRACTION, f"leaf {i}")
            for i, (g, w, r) in enumerate(zip(tbl, jbl, jfl))]
    assert rows[0][1] > 1e-3       # the output's bf16 rounding is real
    return rows


def bf16_matches(arch, jp, steps=8):
    """bfloat16 compute against JAX's at bfloat16 from the JAX parameters
    ``jp``: the loss, ``steps`` decode steps' logits (all steps together)
    and, after them, every state leaf within ``BF16_MODEL_FRACTION`` of
    JAX's own bf16 distance from its float32 run (``bf16_close``).
    Returns the port's bf16 states."""
    jm, jp, tm, tp = make_pair(arch, jp=jp, dtype="bfloat16")
    jm32 = jax_build(configs(arch)[0])
    b = batch(tm.cfg, B=2, seed=11)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tl, _ = tm.loss_fn(tp, {k: t(v) for k, v in b.items()})
    bf16_close(tl, jm.loss_fn(jp, jb)[0], jm32.loss_fn(jp, jb)[0],
               BF16_MODEL_FRACTION, "loss")
    toks = prompt(tm.cfg, 2, steps, 2)
    step, step32 = jax.jit(jm.decode_step), jax.jit(jm32.decode_step)
    jc, jc32, tc = jm.init_cache(2, steps), jm32.init_cache(2, steps), \
        tm.init_cache(2, steps)
    got, want, ref = [], [], []
    for s in range(steps):
        tok = toks[:, s:s + 1]
        pos = jnp.asarray(s, jnp.int32)
        w, jc = step(jp, {"token": jnp.asarray(tok), "pos": pos, "cache": jc})
        r, jc32 = step32(jp, {"token": jnp.asarray(tok), "pos": pos,
                              "cache": jc32})
        g, tc = tm.decode_step(tp, {"token": t(tok), "pos": s, "cache": tc})
        got.append(g.float().numpy())
        want.append(np.asarray(w, np.float32))
        ref.append(np.asarray(r))
    bf16_close(np.stack(got), np.stack(want), np.stack(ref),
               BF16_MODEL_FRACTION, "logits")
    gl = jax.tree.leaves(jax_layout(tc))
    wl = jax.tree.leaves(jc)
    rl = jax.tree.leaves(jc32)
    assert len(gl) == len(wl) == len(rl)
    for i, (g, w, r) in enumerate(zip(gl, wl, rl)):
        bf16_close(g, w, r, BF16_MODEL_FRACTION, f"state leaf {i}")
    return tc


def spread_report():
    """Every spread-held quantity of the family tests, as the tests make
    them: (case, name, error, JAX's spread, bound) rows."""
    out = []
    for arch in ("xlstm-350m", "zamba2-2.7b"):
        pair = make_pair(arch)
        cases = {"grads": (pair, 7),
                 "grads remat": (make_pair(arch, jp=pair[1], attn_chunk=4,
                                           remat="full"), 8)}
        for case, (p, seed) in cases.items():
            r = loss_and_grads(p, batch(p[2].cfg, seed=seed), spread=True)
            out += [(f"{arch} {case}",) + row for row in grads_match(r)]
    for arch in ("xlstm-350m", "zamba2-2.7b", "internvl2-76b"):
        for mb in (1, 2):
            out += [(f"{arch} train step mb {mb}",) + row
                    for row in train_step_matches(arch, mb, spread=True)]
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_lm_family.py
    for case, name, err, spread, bound in spread_report():
        print(f"{case:34s} {name:40s} err {err:.3e} spread {spread:.3e} "
              f"bound {bound:.3e}" + ("" if bound == TOL else "  (spread)"))
