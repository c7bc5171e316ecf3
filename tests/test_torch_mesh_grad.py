"""The gradient convention of ``launch.mesh`` on an emulated mesh.

Every place of a model axis of 4 (``emulate_mesh``, one thread a place,
float64 on the CPU) computes a function of a whole input ``x`` and its
block of a weight cut over the axis, through ``enter``, ``gather_cat``,
``gather_stack`` and ``ordered_sum``; each place's ``backward`` must give
``torch.autograd``'s gradients of the same function computed whole on one
place: ``x``'s whole gradient on every place and the place's block of the
weights'.  Tolerance 1e-12 (float64, sums in another order).  One case
drops the ``enter`` and must get ``x``'s gradient wrong, so the check can
fail.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import (
    axis_group,
    emulate_mesh,
    enter,
    gather_cat,
    gather_stack,
    ordered_sum,
)

N, B, D, F = 4, 3, 5, 8
TOL = 1e-12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s))
            for k, s in (("x", (B, D)), ("w1", (D, F)), ("w2", (F, D)),
                         ("c", (B, F)))}


def _block(w, dim, r):
    m = w.shape[dim] // N
    return w.narrow(dim, r * m, m).clone()


def _replicated(x, w1, w2, c, tp):
    """x into the place's columns of w1, the column blocks gathered back
    whole (``gather_cat``), then work every place repeats."""
    y = tp["enter"](x) @ w1
    z = tp["gather"](torch.tanh(y), 1)
    return torch.sum(torch.sin(z) * c)


def _rank_local(x, w1, w2, c, tp):
    """x into the place's columns of w1, a nonlinearity on the place's
    block, its rows of w2, the partials summed (``ordered_sum``), then
    work every place repeats."""
    h = torch.tanh(tp["enter"](x) @ w1)
    out = tp["sum"](h @ w2)
    return torch.sum(out * out) + torch.sum(torch.cos(out))


def _stacked(x, w1, w2, c, tp):
    """Each place's block gathered as a stack (``gather_stack``), its
    slices read by every place."""
    y = tp["enter"](x) @ w1
    parts = tp["stack"](torch.sigmoid(y))
    return sum(torch.sum(parts[i] * c[:, i * (F // N):(i + 1) * (F // N)])
               for i in range(N))


CASES = {"replicated": _replicated, "rank_local": _rank_local,
         "stacked": _stacked}
# which dim of w1 and w2 each case cuts (None: whole)
CUTS = {"replicated": (1, None), "rank_local": (1, 0), "stacked": (1, None)}


def _whole(fn, inputs):
    """The gradients of ``fn`` on one place: every collective the
    identity or a concatenation of one."""
    x, w1, w2 = (inputs[k].clone().requires_grad_(True)
                 for k in ("x", "w1", "w2"))
    tp = {"enter": lambda t: t, "gather": lambda t, dim: t,
          "sum": lambda t: t, "stack": lambda t: torch.stack(
              t.split(F // N, dim=1))}
    loss = fn(x, w1, w2, inputs["c"], tp)
    loss.backward()
    return loss.detach(), x.grad, w1.grad, w2.grad


def _places(fn, inputs, with_enter=True):
    def place(mesh):
        r = mesh.get_local_rank("model")
        group = axis_group(mesh, "model")
        c1, c2 = CUTS[fn.__name__.lstrip("_")]
        x = inputs["x"].clone().requires_grad_(True)
        w1 = (inputs["w1"] if c1 is None else _block(inputs["w1"], c1, r))
        w2 = (inputs["w2"] if c2 is None else _block(inputs["w2"], c2, r))
        w1, w2 = (w.clone().requires_grad_(True) for w in (w1, w2))
        tp = {"enter": ((lambda t: enter(t, group)) if with_enter
                        else (lambda t: t)),
              "gather": lambda t, dim: gather_cat(t, group, dim),
              "sum": lambda t: ordered_sum(t, group),
              "stack": lambda t: gather_stack(t, group)}
        loss = fn(x, w1, w2, inputs["c"], tp)
        loss.backward()
        return r, loss.detach(), x.grad, w1.grad, w2.grad

    return emulate_mesh({"data": 1, "model": N}, place)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_through_the_collectives_equal_the_whole(name):
    fn = CASES[name]
    inputs = _inputs()
    loss, dx, dw1, dw2 = _whole(fn, inputs)
    c1, c2 = CUTS[name]
    for r, l_r, dx_r, dw1_r, dw2_r in _places(fn, inputs):
        torch.testing.assert_close(l_r, loss, atol=TOL, rtol=TOL)
        torch.testing.assert_close(dx_r, dx, atol=TOL, rtol=TOL)
        want1 = dw1 if c1 is None else _block(dw1, c1, r)
        torch.testing.assert_close(dw1_r, want1, atol=TOL, rtol=TOL)
        if c2 is not None:
            torch.testing.assert_close(dw2_r, _block(dw2, c2, r), atol=TOL,
                                       rtol=TOL)


@pytest.mark.parametrize("name", ["replicated", "rank_local"])
def test_without_enter_the_gradient_is_wrong(name):
    """The same function without ``enter``: each place's gradient of x
    is its own block's share only, not the whole gradient."""
    fn = CASES[name]
    inputs = _inputs(1)
    _, dx, _, _ = _whole(fn, inputs)
    for _, _, dx_r, _, _ in _places(fn, inputs, with_enter=False):
        assert not torch.allclose(dx_r, dx, atol=1e-6, rtol=1e-6)


def test_places_do_not_share_a_graph():
    """A place's gathered tensors hold the other places' values, not their
    autograd graphs: a place's backward reaches only its own leaves."""
    inputs = _inputs(2)

    def place(mesh):
        r = mesh.get_local_rank("model")
        group = axis_group(mesh, "model")
        w = _block(inputs["w1"], 1, r).requires_grad_(True)
        z = gather_cat(inputs["x"] @ w, group, 1)
        torch.sum(z * z).backward()
        return r, w.grad, z.grad_fn is not None

    for r, g, recorded in emulate_mesh({"data": 1, "model": N}, place):
        w = _block(inputs["w1"], 1, r)
        assert recorded
        torch.testing.assert_close(g, 2 * inputs["x"].T @ (inputs["x"] @ w),
                                   atol=TOL, rtol=TOL)


def test_collectives_of_one_place_are_the_identity():
    """Over one place (the degenerate group) every collective is the
    identity forward and backward; ``enter`` on a tensor autograd does not
    record is the tensor itself."""
    x = torch.arange(6.0, dtype=torch.float64).requires_grad_(True)

    def place(mesh):
        group = axis_group(mesh, "model")
        y = ordered_sum(enter(x * 1.0, group), group)
        z = gather_cat(y, group, 0)
        (z * z).sum().backward()
        plain = torch.ones(3)
        return enter(plain, group) is plain

    assert emulate_mesh({"data": 1, "model": 1}, place) == [True]
    torch.testing.assert_close(x.grad, 2 * x.detach())


def _cut_tree(seed=3):
    """A gradient tree of whole leaves and the dim each is cut on over
    the model axis (None: whole), with two layers of one path (one int8
    scale between them, as ``compress_grads`` groups them)."""
    rng = np.random.default_rng(seed)
    whole = {"a": torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)),
             "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
             "stack": [{"w": torch.from_numpy(rng.standard_normal(
                 (4, 8)).astype(np.float32) * 10 ** i)} for i in range(2)]}
    cuts = {"a": 0, "b": None, "stack": [{"w": 1}, {"w": 1}]}
    return whole, cuts


def _place_tree(whole, cuts, r):
    from repro_torch.tree import tree_map

    return tree_map(lambda t, c: t if c is None else _block(t, c, r),
                    whole, cuts)


def test_global_norm_over_a_mesh_is_the_whole_trees():
    """``global_norm(grads, cut)`` on every place's blocks: the whole
    tree's norm (1e-6 relative: sums in another order), the same bits on
    every place."""
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves

    whole, cuts = _cut_tree()
    want = global_norm(whole)

    def place(mesh):
        r = mesh.get_local_rank("model")
        g = axis_group(mesh, "model")
        mine = _place_tree(whole, cuts, r)
        cut = [None if c is None else g for c in tree_leaves(cuts)]
        return global_norm(mine, cut)

    got = emulate_mesh({"data": 1, "model": N}, place)
    for x in got:
        assert torch.equal(x, got[0])
        torch.testing.assert_close(x, want, rtol=1e-6, atol=0)


def test_compress_grads_over_a_mesh_takes_the_whole_leaves_scales():
    """``compress_grads(grads, state, cut)`` on every place's blocks: the
    place's blocks of the whole tree's wire values and error feedback
    (every scale is the whole leaves' max, which is exact in any order)."""
    from repro_torch.optim import compress_grads, init_compression
    from repro_torch.tree import tree_leaves

    whole, cuts = _cut_tree(4)
    wire, ef = compress_grads(whole, init_compression(whole))

    def place(mesh):
        r = mesh.get_local_rank("model")
        g = axis_group(mesh, "model")
        mine = _place_tree(whole, cuts, r)
        cut = [None if c is None else g for c in tree_leaves(cuts)]
        w, e = compress_grads(mine, init_compression(mine), cut)
        return r, w, e["ef"]

    for r, w, e in emulate_mesh({"data": 1, "model": N}, place):
        for got, want in ((w, wire), (e, ef["ef"])):
            for a, b in zip(tree_leaves(got),
                            tree_leaves(_place_tree(want, cuts, r))):
                assert torch.equal(a, b)
