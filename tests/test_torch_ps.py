"""The port's parameter server against the JAX package's: the same graph,
labels, placement and ``DBPGConfig`` through ``repro.ml.PSCluster`` and
``repro_torch.ml.PSCluster`` on the CPU.  The traffic meters (inner,
inter, per machine) and ``nnz_w`` must be equal; ``w`` and the objectives
agree within 1e-5 relative in float32 (the port sums the gradient's
segments in the JAX package's order, but the sigmoid's ``exp`` is not
XLA's, so ``w`` may differ in its last bits; ``REL`` below).  Cases mirror
``tests/test_ps.py`` and the cluster half of ``tests/test_elastic.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import random_parts as j_random_parts
from repro.core.placement import build_placement as j_build_placement
from repro.graphs import ctr_like as j_ctr_like
from repro.ml import DBPGConfig as JDBPG
from repro.ml import PSCluster as JPS
from repro.ml import make_problem as j_make_problem
from repro.ml import dbpg as jdbpg
from repro.ml.lr import SparseBatch as JBatch
from repro.ml.lr import _margins as j_margins
from repro.ml.lr import lr_grad as j_lr_grad
from repro.ml.lr import lr_objective as j_lr_objective
from repro_torch.api import ParsaConfig, partition
from repro_torch.configs.parsa_paper import PAPER, ParsaExperimentConfig
from repro_torch.convert import (
    PS_STATE_KEYS,
    graph_from_numpy,
    ps_state_from_numpy,
)
from repro_torch.core import from_edges, improvement, random_parts
from repro_torch.ml import (
    DBPGConfig,
    PSCluster,
    SparseBatch,
    TrafficMeter,
    lr_grad,
    lr_objective,
    make_problem,
)
from repro_torch.ml.dbpg import (
    dequantize_int8,
    kkt_filter,
    prox_step,
    quantize_int8,
    soft_threshold,
)
from repro_torch.ml.lr import _margins

REL = 1e-5


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


@pytest.fixture(scope="module")
def lr_setup():
    g = j_ctr_like(500, 1500, nnz_per_row=15, seed=11)
    w_star, labels = j_make_problem(g, seed=11)
    return g, labels


@pytest.fixture(scope="module")
def placements(lr_setup):
    """The JAX package's Parsa placements of the LR graph (both clusters
    take the same arrays)."""
    g, _ = lr_setup
    return {(k, b, a): j_build_placement(g, k, b=b, a=a)
            for k, b, a in ((4, 2, 0), (8, 4, 2))}


def _clusters(g, labels, parts_u, parts_v, k, **cfg):
    extra = {n: cfg.pop(n) for n in ("flops_rate", "bandwidth", "seed")
             if n in cfg}
    return (JPS(g, labels, parts_u, parts_v, k, JDBPG(**cfg), **extra),
            PSCluster(_port(g), labels, parts_u, parts_v, k,
                      DBPGConfig(**cfg), device="cpu", **extra))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if not want.size:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, what


def _same_meter(jc, tc):
    assert (tc.meter.inner_bytes, tc.meter.inter_bytes) == \
        (jc.meter.inner_bytes, jc.meter.inter_bytes)
    assert np.array_equal(tc.meter.per_machine, jc.meter.per_machine)
    assert np.array_equal(tc._keys_sent, jc._keys_sent)


def _same_run(rj, rt):
    for key in ("inner_bytes", "inter_bytes", "total_bytes",
                "inner_fraction", "nnz_w", "modeled_time_s",
                "modeled_compute_s", "modeled_comm_s"):
        assert rt[key] == rj[key], key
    assert len(rt["objective"]) == len(rj["objective"])
    _close(rt["objective"], rj["objective"], "objective")


def _same_w(jc, tc):
    _close(tc.w.numpy(), np.asarray(jc.w), "w")
    assert np.array_equal(tc.w.numpy() != 0, np.asarray(jc.w) != 0)


# ------------------------------------------------- tests/test_ps.py
def test_dbpg_converges(lr_setup, placements):
    g, labels = lr_setup
    pl = placements[(4, 2, 0)]
    jc, tc = _clusters(g, labels, pl.doc_to_shard, pl.vocab_to_shard, 4,
                       lam=0.3, lr=0.005, max_delay=0, compress=False,
                       kkt_eps=0.0)
    rj, rt = jc.run(20, log_every=5), tc.run(20, log_every=5)
    _same_run(rj, rt)
    _same_w(jc, tc)
    assert rt["objective"][-1] < rt["objective"][0] * 0.85


def test_parsa_reduces_inter_machine_traffic(lr_setup, placements):
    g, labels = lr_setup
    pl = placements[(8, 4, 2)]
    runs = {}
    for name, pu, pv in (("parsa", pl.doc_to_shard, pl.vocab_to_shard),
                         ("random", random_parts(g.num_u, 8, 0),
                          random_parts(g.num_v, 8, 1))):
        jc, tc = _clusters(g, labels, pu, pv, 8, lam=0.3, lr=0.03)
        rj, rt = jc.run(5), tc.run(5)
        _same_run(rj, rt)
        runs[name] = rt
    assert runs["parsa"]["inter_bytes"] < runs["random"]["inter_bytes"]
    assert runs["parsa"]["inner_fraction"] > runs["random"]["inner_fraction"]


def test_bounded_delay_still_converges(lr_setup, placements):
    g, labels = lr_setup
    pl = placements[(4, 2, 0)]
    jc, tc = _clusters(g, labels, pl.doc_to_shard, pl.vocab_to_shard, 4,
                       lam=0.3, lr=0.003, max_delay=3)
    rj, rt = jc.run(20, log_every=19), tc.run(20, log_every=19)
    _same_run(rj, rt)
    assert tc.rng.bit_generator.state == jc.rng.bit_generator.state
    assert rt["objective"][-1] < rt["objective"][0]


def test_kkt_filter_keeps_active_coords():
    w = torch.tensor([0.0, 0.0, 1.0, -2.0])
    g = torch.tensor([0.05, 0.5, 0.01, 0.3])
    assert kkt_filter(w, g, lam=0.2, eps=0.1).tolist() == [False, True,
                                                            True, True]
    rng = np.random.default_rng(0)
    w = (rng.normal(size=4000) * (rng.random(4000) < 0.5)).astype(np.float32)
    g = rng.normal(0, 0.2, 4000).astype(np.float32)
    g[:50] = np.float32(0.3 * (1 - 0.1))           # on the boundary
    assert np.array_equal(
        kkt_filter(torch.from_numpy(w), torch.from_numpy(g), 0.3,
                   0.1).numpy(),
        np.asarray(jdbpg.kkt_filter(jnp.asarray(w), jnp.asarray(g), 0.3,
                                    0.1)))


def test_quantization_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, 1000).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    err = np.abs(dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) * 0.5 + 1e-6
    jq, js = jdbpg.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.float32(js)
    # half-way values round to even in both packages
    h = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    assert np.array_equal(quantize_int8(torch.from_numpy(h))[0].numpy(),
                          np.asarray(jdbpg.quantize_int8(jnp.asarray(h))[0]))


def test_soft_threshold():
    w = torch.tensor([-3.0, -0.1, 0.0, 0.1, 3.0])
    np.testing.assert_allclose(soft_threshold(w, 0.5).numpy(),
                               [-2.5, 0, 0, 0, 2.5])
    rng = np.random.default_rng(1)
    w = rng.normal(size=500).astype(np.float32)
    g = rng.normal(size=500).astype(np.float32)
    got = prox_step(torch.from_numpy(w), torch.from_numpy(g),
                    DBPGConfig(lam=0.3, lr=0.03)).numpy()
    want = np.asarray(jdbpg.prox_step(jnp.asarray(w), jnp.asarray(g),
                                      JDBPG(lam=0.3, lr=0.03)))
    assert np.array_equal(got, want)


def test_traffic_meter_bare_regression():
    m = TrafficMeter()
    m.add(0, 0, 8)
    assert m.per_machine is None
    m.add(2, 5, 4)
    assert (m.inner_bytes, m.inter_bytes, m.total) == (8, 4, 12)
    assert m.per_machine.shape[0] == 6
    assert m.per_machine[2] == 4 == m.per_machine[5]
    m.add(7, 0, 2)
    assert m.per_machine.shape[0] == 8
    assert list(m.per_machine) == [2, 0, 4, 0, 0, 4, 0, 2]


def _tiny_cluster(cfg=None):
    """4 examples x 6 features, k=2 (``tests/test_ps.py``'s)."""
    g = from_edges(4, 6,
                   np.array([0, 0, 1, 1, 1, 2, 2, 3, 3, 3]),
                   np.array([0, 1, 1, 2, 3, 3, 4, 4, 5, 0]))
    if cfg is None:
        cfg = DBPGConfig(lam=0.0, lr=0.1, kkt_eps=0.0, compress=False,
                         max_delay=0, error_feedback=False)
    return PSCluster(g, np.ones(4, np.float32), np.array([0, 0, 1, 1]),
                     np.array([0, 0, 0, 1, 1, 1]), 2, cfg, device="cpu")


def test_metering_hand_computed_4x6():
    cl = _tiny_cluster()
    cl.run(2)
    assert cl.meter.inner_bytes == 120
    assert cl.meter.inter_bytes == 40
    assert list(cl.meter.per_machine) == [40, 40]


def test_pull_plan_value_delta_cache_and_stale_fallback():
    cl = _tiny_cluster()
    cl.commit_weights(np.arange(1, 7, dtype=np.float32))
    plan = cl.plan_pull(0)
    assert plan.total_bytes == 16
    assert list(plan.src_bytes) == [12, 4]
    h = cl.pull_nowait(plan)
    assert h.fresh_entries == 4 and h.stale_entries == 0
    assert h.inner_bytes == 12 and h.inter_bytes == 4
    np.testing.assert_array_equal(h.block().numpy()[:4], [1, 2, 3, 4])
    assert cl.plan_pull(0).total_bytes == 0
    cl.commit_weights(torch.arange(11, 17, dtype=torch.float32))
    h2 = cl.pull_nowait(cl.plan_pull(0), exclude=frozenset({1}))
    assert h2.stale_entries == 1 and h2.fresh_entries == 3
    buf = h2.buffer.numpy()
    np.testing.assert_array_equal(buf[:3], [11, 12, 13])
    assert buf[3] == 4.0
    nxt = cl.plan_pull(0)
    assert nxt.src_bytes[1] == 4 and nxt.src_bytes[0] == 0


def test_pull_handle_blocks_out_the_modeled_wire_time():
    cl = _tiny_cluster()
    cl.commit_weights(np.arange(1, 7, dtype=np.float32))
    h = cl.pull_nowait(cl.plan_pull(1), wire_s=0.02, wait_s=0.01,
                       queue_s=0.01)
    assert h.done_at == pytest.approx(h.issued_at + 0.04)
    import time

    buf = h.block()
    assert time.perf_counter() >= h.done_at
    assert buf.device.type == "cpu" and buf.dtype == torch.float32
    # the handle owns a copy: a later pull does not alias into it
    cl.commit_weights(np.zeros(6, np.float32))
    cl.pull_nowait(cl.plan_pull(1))
    assert float(buf[5]) == 6.0


# -------------------------------------------- JAX run() against the port
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("tau", [0, 3])
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kkt_eps", [0.1, 0.0])
def test_run_matches_jax(lr_setup, placements, k, tau, compress, kkt_eps):
    g, labels = lr_setup
    pl = placements[(4, 2, 0) if k == 4 else (8, 4, 2)]
    jc, tc = _clusters(g, labels, pl.doc_to_shard, pl.vocab_to_shard, k,
                       lam=0.3, lr=0.03, max_delay=tau, compress=compress,
                       kkt_eps=kkt_eps, seed=1)
    rj, rt = jc.run(8, log_every=2), tc.run(8, log_every=2)
    _same_run(rj, rt)
    _same_meter(jc, tc)
    _same_w(jc, tc)


@pytest.mark.parametrize("tau,compress", [(3, True), (0, False)])
def test_jax_state_carried_across_continues_the_run(lr_setup, placements,
                                                    tau, compress):
    """JAX runs 3 steps; its state, as numpy arrays, loads into a port
    cluster, which runs 3 more: equal to JAX's 6."""
    g, labels = lr_setup
    pl = placements[(8, 4, 2)]
    args = (g, labels, pl.doc_to_shard, pl.vocab_to_shard, 8)
    cfg = dict(lam=0.3, lr=0.03, max_delay=tau, compress=compress, seed=2)
    jc, _ = _clusters(*args, **cfg)
    j6, tc = _clusters(*args, **cfg)
    jc.run(3)
    state = dict(
        w=np.asarray(jc.w), pull_cache=[np.asarray(a) for a in jc._pull_cache],
        ef=[np.asarray(a) for a in jc._ef],
        hist=[np.asarray(a) for a in jc._hist], keys_sent=jc._keys_sent,
        inner_bytes=jc.meter.inner_bytes, inter_bytes=jc.meter.inter_bytes,
        per_machine=jc.meter.per_machine,
        rng_state=jc.rng.bit_generator.state)
    assert set(state) == set(PS_STATE_KEYS)
    ps_state_from_numpy(tc, state)
    rt, rj = tc.run(3), j6.run(6)
    # run()'s modeled compute counts its own iterations (3 against 6); the
    # meters and what they price carry across
    for key in ("inner_bytes", "inter_bytes", "total_bytes",
                "inner_fraction", "nnz_w", "modeled_comm_s"):
        assert rt[key] == rj[key], key
    _same_meter(j6, tc)
    _same_w(j6, tc)
    assert tc.rng.bit_generator.state == j6.rng.bit_generator.state
    with pytest.raises(ValueError, match="lacks"):
        ps_state_from_numpy(tc, {"w": state["w"]})


# --------------------------------------- tests/test_elastic.py's cluster
def test_ps_cluster_k_change_teardown_spawn():
    g = j_ctr_like(200, 400, nnz_per_row=8, seed=2)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, g.num_u).astype(np.float32)
    parts_u = rng.integers(0, 3, g.num_u).astype(np.int32)
    parts_v = rng.integers(0, 3, g.num_v).astype(np.int32)
    jc, tc = _clusters(g, labels, parts_u, parts_v, 3)
    _same_run(jc.run(2), tc.run(2))
    pu5 = rng.integers(0, 5, g.num_u).astype(np.int32)
    pv5 = rng.integers(0, 5, g.num_v).astype(np.int32)
    rep = tc.apply_placement(pu5, pv5, k=5)
    assert rep == jc.apply_placement(pu5, pv5, k=5)
    assert tc.k == 5 and len(tc.batches) == 5 and len(tc._pull_cache) == 5
    assert tc.meter.per_machine.shape == (5,)
    assert tc._keys_sent.shape == (5, 5) and not tc._keys_sent.any()
    assert rep["reshard_bytes"] > 0 and tc.placement_version == 1
    _same_run(jc.run(2), tc.run(2))
    rep = tc.apply_placement(pu5 % 2, pv5 % 2, k=2)
    assert rep == jc.apply_placement(pu5 % 2, pv5 % 2, k=2)
    assert tc.k == 2 and len(tc.batches) == 2 and len(tc._pull_cache) == 2
    assert tc.meter.per_machine.shape == (2,)
    _same_run(jc.run(2), tc.run(2))
    _same_meter(jc, tc)
    rep = tc.apply_placement(pu5 % 2, pv5 % 2)   # same k: keys re-sent
    assert rep == jc.apply_placement(pu5 % 2, pv5 % 2)
    assert rep["reshard_bytes"] == 0 and not tc._keys_sent.any()
    for bad, match in (((pu5, pv5 % 2, 2), "labels reach"),
                       ((pu5 % 2, pv5 % 2, 0), "k must be"),
                       ((pu5[:5] % 2, pv5 % 2, 2), "fixed graph"),
                       ((pu5 % 2, pv5[:5] % 2, 2), "parts_v shape")):
        with pytest.raises(ValueError, match=match):
            tc.apply_placement(*bad[:2], k=bad[2])


# ----------------------------------------------------- pieces of ml.lr
def test_make_problem_and_batches_match_jax(lr_setup):
    g, labels = lr_setup
    pg = _port(g)
    w_star, tl = make_problem(pg, seed=11)
    jw, _ = j_make_problem(g, seed=11)
    assert np.array_equal(tl, labels) and np.array_equal(w_star, jw)
    rows = np.arange(3, g.num_u, 7)
    for pad in (None, 4096):
        jb = JBatch.from_graph(g, rows, labels, pad_to=pad)
        tb = SparseBatch.from_graph(pg, rows, labels, pad_to=pad,
                                    device="cpu")
        for f in ("row_ids", "col_ids", "values", "labels"):
            assert np.array_equal(getattr(tb, f).numpy(),
                                  np.asarray(getattr(jb, f))), f
        assert (tb.num_rows, tb.num_features) == (jb.num_rows,
                                                  jb.num_features)
        w = np.random.default_rng(3).normal(size=g.num_v).astype(np.float32)
        # the margins sum each row in CSR order: the JAX bits
        assert np.array_equal(_margins(tb, torch.from_numpy(w)).numpy(),
                              np.asarray(j_margins(jb, jnp.asarray(w))))
        _close(lr_grad(tb, torch.from_numpy(w)).numpy(),
               np.asarray(j_lr_grad(jb, jnp.asarray(w))), "grad")
        _close([float(lr_objective(tb, torch.from_numpy(w), 0.3))],
               [float(j_lr_objective(jb, jnp.asarray(w), 0.3))], "objective")


def test_gradient_sums_each_column_in_csr_order():
    """Against a float32 loop over the nonzeros in CSR order: equal bits
    (the JAX package's segment_sum order on the CPU)."""
    g = _port(j_ctr_like(300, 200, nnz_per_row=12, seed=4))
    labels = np.where(np.arange(300) % 3, 1.0, -1.0).astype(np.float32)
    b = SparseBatch.from_graph(g, np.arange(300), labels, device="cpu")
    w = np.random.default_rng(0).normal(size=200).astype(np.float32)
    m = _margins(b, torch.from_numpy(w))
    coef = (-b.labels * torch.sigmoid(-m)).numpy()
    want = np.zeros(200, np.float32)
    for r, c in zip(b.row_ids.numpy(), b.col_ids.numpy()):
        want[c] = np.float32(want[c] + coef[r])
    assert np.array_equal(lr_grad(b, torch.from_numpy(w)).numpy(), want)
    empty = SparseBatch.from_graph(g, np.arange(0), labels, device="cpu")
    assert not lr_grad(empty, torch.from_numpy(w)).any()


def test_random_parts_improvement_and_paper_config():
    from repro.configs.parsa_paper import PAPER as JPAPER
    from repro.core import improvement as j_improvement

    for n, k, seed in ((100, 7, 0), (33, 4, 5)):
        assert np.array_equal(random_parts(n, k, seed),
                              j_random_parts(n, k, seed))
    assert improvement(150.0, 100.0) == j_improvement(150.0, 100.0) == 50.0
    assert improvement(1.0, 0.0) == float("inf")
    assert dataclasses.asdict(PAPER) == dataclasses.asdict(JPAPER)
    assert PAPER == ParsaExperimentConfig() and PAPER.dbpg_passes == 45


def test_from_partition_uses_the_refined_placement():
    g = _port(j_ctr_like(300, 600, nnz_per_row=10, seed=3))
    _, labels = make_problem(g, seed=5)
    res = partition(g, ParsaConfig(k=4, block_size=64,
                                   refine_backend="device"), device="cpu")
    cl = PSCluster.from_partition(g, labels, res, DBPGConfig(lam=0.3),
                                  device="cpu", seed=1)
    assert np.array_equal(cl.parts_u, res.parts_u)
    assert np.array_equal(cl.parts_v, res.parts_v) and cl.k == 4
    jc = JPS(g, labels, res.parts_u, res.parts_v, 4, JDBPG(lam=0.3), seed=1)
    _same_run(jc.run(3, log_every=2), cl.run(3, log_every=2))
    res.parts_v = None
    with pytest.raises(ValueError, match="parts_v"):
        PSCluster.from_partition(g, labels, res, DBPGConfig())


def test_ps_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port(j_ctr_like(20, 40, nnz_per_row=4, seed=0))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        PSCluster(g, np.ones(20, np.float32), np.zeros(20, np.int32),
                  np.zeros(40, np.int32), 1, DBPGConfig())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cluster_deterministic_and_close_to_cpu(cuda_device, lr_setup,
                                                     placements):
    g, labels = lr_setup
    pl = placements[(8, 4, 2)]
    runs = []
    for device in ("cpu", cuda_device, cuda_device):
        cl = PSCluster(_port(g), labels, pl.doc_to_shard, pl.vocab_to_shard,
                       8, DBPGConfig(lam=0.3, lr=0.03, max_delay=3),
                       device=device, seed=1)
        runs.append((cl.run(8, log_every=7), cl.w.cpu().numpy()))
    (rc, wc), (r1, w1), (r2, w2) = runs
    assert r1 == r2 and np.array_equal(w1, w2)
    _close(w1, wc, "w")
    for key in ("inner_bytes", "inter_bytes"):
        assert abs(r1[key] - rc[key]) <= 1e-3 * rc[key]
