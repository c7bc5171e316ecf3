"""The port's elastic session against the JAX package's: the same seeded
chunks, ops and chaos schedules through ``repro.elastic.ElasticSession``
(its plain reference, ``use_kernel=False``) and
``repro_torch.elastic.ElasticSession`` on the CPU (the plain versions of
the port's kernels), compared bit for bit (tolerance 0: every output is
an integer).  After each op: parts, live sets, sizes, ``k``, traffic,
every ``ElasticOp`` field but the wall-clock ``seconds``, and the dispatch
records.  Cases mirror ``tests/test_elastic.py``, the sketched elastic
test of ``tests/test_sketch.py``, the straggler cases of
``tests/test_fault.py`` and the chaos script of
``benchmarks/bench_chaos.py``; 4-worker sessions run JAX
``parallel_device`` on 8 forced host devices in a subprocess."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import ParsaStreamConfig as JStreamConfig
from repro.api_backends import TrafficCounters as JTraffic
from repro.core.jax_partition import _biased_perm as j_biased_perm
from repro.core.jax_partition import _weighted_block_targets as j_targets
from repro.core.jax_partition import dispatch_counter as j_dispatch_counter
from repro.elastic import ChaosEvent as JEvent
from repro.elastic import ChaosSchedule as JSchedule
from repro.elastic import ElasticConfig as JElasticConfig
from repro.elastic import ElasticSession as JElastic
from repro.elastic import FleetState as JFleetState
from repro.elastic import ThresholdPolicy as JThreshold
from repro.graphs import ctr_like_stream as j_ctr_like_stream
from repro.graphs import text_like as j_text_like
from repro.runtime import BoundedDelayAccumulator as JAccumulator
from repro.runtime import StragglerConfig as JStragglerConfig
from repro.runtime import StragglerEWMA as JEWMA
from repro_torch import api as tapi
from repro_torch.api import (
    ChaosEvent,
    ChaosSchedule,
    ElasticConfig,
    ElasticPolicy,
    ElasticSession,
    ParsaConfig,
    ParsaStreamConfig,
    ThresholdPolicy,
)
from repro_torch.api_backends import TrafficCounters
from repro_torch.convert import graph_from_numpy
from repro_torch.core.bipartite import BipartiteGraph
from repro_torch.core.costs import PartitionMetrics, evaluate, need_matrix
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.core.partition import _biased_perm, _weighted_block_targets
from repro_torch.core.refine import need_masks
from repro_torch.elastic import FleetState
from repro_torch.kernels.parsa_cost import unpack_bitmask
from repro_torch.runtime import (
    BoundedDelayAccumulator,
    StragglerConfig,
    StragglerEWMA,
)
from repro_torch.stream import DriftTracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_V = 1500
# benchmarks/bench_chaos.py's disaster script, as (feed, kind, machine,
# factor), and run(scale=0.1)'s geometry
CHAOS_EVENTS = ((2, "add", None, 4.0), (3, "add", None, 4.0),
                (4, "straggle", 1, 4.0), (5, "kill", None, 4.0),
                (6, "add", None, 4.0), (7, "add", None, 4.0),
                (8, "recover", 1, 4.0), (9, "kill", None, 4.0))
CHAOS_GEOMETRY = dict(n_u=1200, num_v=1638, k0=8, chunks=12, block=128)


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _chunks(n=4, rows=600, num_v=NUM_V, seed=1):
    return j_ctr_like_stream(rows, num_v, chunks=n, nnz_per_row=10,
                             churn=0.3, seed=seed)


def _base(k=4, workers=1, **extra):
    if workers > 1:
        return dict(k=k, backend="parallel_device", workers=workers,
                    block_size=32, merge_every=1, refine_v=False, **extra)
    return dict(k=k, backend="device_scan", block_size=64, refine_v=False,
                **extra)


def _configs(k=4, workers=1, repartition_frac=0.02, base_extra=None, **kw):
    """(JAX ElasticConfig, port ElasticConfig) of ``tests/test_elastic.py``'s
    ``_ecfg``."""
    base = _base(k, workers, **(base_extra or {}))
    skw = dict(repartition="never", repartition_frac=repartition_frac)
    j = JElasticConfig(stream=JStreamConfig(
        base=JConfig(**base, use_kernel=False), **skw), min_k=2, max_k=16,
        **kw)
    t = ElasticConfig(stream=ParsaStreamConfig(base=ParsaConfig(**base),
                                               **skw),
                      min_k=2, max_k=16, **kw)
    return j, t


def _sessions(num_v=NUM_V, jpolicy=None, tpolicy=None, jchaos=None,
              tchaos=None, **kw):
    jc, tc = _configs(**kw)
    return (JElastic(jc, num_v=num_v, policy=jpolicy, chaos=jchaos),
            ElasticSession(tc, num_v=num_v, policy=tpolicy, chaos=tchaos,
                           device="cpu"))


def _schedules(events, seed):
    """The same schedule in both packages, from (feed, kind, machine,
    factor) tuples."""
    return (JSchedule([JEvent(*e) for e in events], seed=seed),
            ChaosSchedule([ChaosEvent(*e) for e in events], seed=seed))


def _same_state(js, ts):
    assert ts.k == js.k
    assert np.array_equal(ts.parts, js.parts)
    assert np.array_equal(ts.stream.arena.masks_np(logical=False),
                          js.stream.arena.masks_np(logical=False))
    assert np.array_equal(ts.stream.arena.sizes.numpy(),
                          np.asarray(js.stream.arena.sizes))
    assert dataclasses.astuple(ts.traffic) == dataclasses.astuple(js.traffic)
    assert ts.n_feeds == js.n_feeds
    assert ts.stream._need_exact == js.stream._need_exact


def _op_fields(op):
    d = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)
         if f.name != "seconds"}
    d["traffic"] = dataclasses.astuple(d["traffic"])
    return d


def _same_ops(jops, tops):
    assert [_op_fields(o) for o in tops] == [_op_fields(o) for o in jops]


def _records(counts):
    return [(r.phase, r.nbytes, r.meta) for r in counts.records]


def _feed_both(js, ts, chunks):
    for c in chunks:
        with j_dispatch_counter() as jc:
            ju = js.feed(c)
        with dispatch_counter() as tc:
            tu = ts.feed(_port(c))
        assert np.array_equal(tu.parts, ju.parts)
        assert tu.dispatches == ju.dispatches
        assert _records(tc) == _records(jc)
        _same_state(js, ts)
    _same_ops(js.ops, ts.ops)


def _op_both(js, ts, call):
    """``call(session)`` on both; the ops, dispatch records and state
    after it must agree.  Returns the port's op and dispatch log."""
    with j_dispatch_counter() as jc:
        jop = call(js)
    with dispatch_counter() as tc:
        top = call(ts)
    assert _op_fields(top) == _op_fields(jop)
    assert _records(tc) == _records(jc)
    _same_state(js, ts)
    _same_ops(js.ops, ts.ops)
    return top, tc


def _fed(n=3, **kw):
    js, ts = _sessions(**kw)
    _feed_both(js, ts, _chunks(n))
    return js, ts


def _exact_popcounts(ts):
    g = ts.stream.arena.graph()
    want = evaluate(g, ts.parts, None, ts.k)
    assert ts.stream._popcount_metrics().as_dict() == want.as_dict()


# ---------------------------------------------------------- elastic ops
def test_grow_one_dispatch_and_consistency():
    js, ts = _fed()
    k0 = ts.k
    before = np.bincount(ts.parts, minlength=k0)
    op, counts = _op_both(js, ts, lambda s: s.grow_k(force=True))
    assert op.committed and ts.k == k0 + 1 and op.partner == k0
    scans = [r for r in counts.records if "scan" in r.phase]
    assert [r.phase for r in scans] == ["elastic_grow_scan"]
    assert scans[0].nbytes > 0 and scans[0].meta["machine"] == op.machine
    after = np.bincount(ts.parts, minlength=ts.k)
    assert after[op.machine] + after[k0] == before[op.machine]
    assert op.traffic.migration_bytes > 0
    _exact_popcounts(ts)


def test_shrink_zero_scans_and_consistency():
    js, ts = _fed()
    k0 = ts.k
    op, counts = _op_both(js, ts, lambda s: s.shrink_k(force=True))
    assert op.committed and ts.k == k0 - 1
    assert counts.records == [] and counts.launches == {}
    assert op.traffic.migration_bytes > 0 and ts.parts.max() < ts.k
    g = ts.stream.arena.graph()
    assert np.array_equal(unpack_bitmask(ts.stream.arena.masks_np(),
                                         g.num_v),
                          need_matrix(g, ts.parts, ts.k))


def test_repair_one_dispatch_refills_lost_machine():
    js, ts = _fed(repartition_frac=0.0)
    lost = 1
    lost_rows = int((ts.parts == lost).sum())
    assert lost_rows > 0
    op, counts = _op_both(js, ts, lambda s: s.repair(lost))
    scans = [r for r in counts.records if "scan" in r.phase]
    assert [r.phase for r in scans] == ["elastic_repair_scan"]
    assert scans[0].meta["machine"] == lost and scans[0].meta["rows"] > 0
    assert op.mode == "warm" and op.moved_u == lost_rows
    assert op.traffic.migration_bytes > 0
    _exact_popcounts(ts)
    assert ts.traffic.migration_bytes >= op.traffic.migration_bytes


@pytest.mark.parametrize("mode,frac", [("warm", 0.0), ("warm", 0.02),
                                       ("cold", 0.0), ("cold", 0.02)])
def test_repair_modes_match_jax(mode, frac):
    """Warm repair without and with the §4.4 seeding of the lost
    subgraph, and the cold repartition; then a feed on the repaired
    state."""
    js, ts = _fed(repartition_frac=frac)
    lost = int(np.argmax(np.bincount(ts.parts, minlength=ts.k)))
    op, counts = _op_both(js, ts, lambda s: s.repair(lost, mode=mode))
    assert op.mode == mode and op.committed
    phases = [r.phase for r in counts.records]
    assert phases == (["elastic_repair_scan"] if mode == "warm"
                      else ["partition_scan"])
    assert ts.stream._need_exact == (frac == 0.0)
    _feed_both(js, ts, _chunks(1, seed=4))


def test_ops_bit_deterministic_under_fixed_seed():
    def run():
        js, ts = _fed()
        for call in (lambda s: s.grow_k(force=True), lambda s: s.repair(0),
                     lambda s: s.shrink_k(force=True),
                     lambda s: s.grow_k(force=True)):
            _op_both(js, ts, call)
        return ts

    a, b = run(), run()
    assert a.k == b.k and np.array_equal(a.parts, b.parts)
    assert np.array_equal(a.stream.arena.masks_np(),
                          b.stream.arena.masks_np())
    assert [_op_fields(o) for o in a.ops] == [_op_fields(o) for o in b.ops]


class _NoPolicy:
    min_partitions, max_partitions = 2, 16

    def grow(self, state):
        return False

    def shrink(self, state):
        return False

    def repair(self, state):
        return "warm"

    def rebalance(self, state, weights):
        return None


def test_policy_veto_leaves_state_untouched():
    js, ts = _sessions(jpolicy=_NoPolicy(), tpolicy=_NoPolicy())
    _feed_both(js, ts, _chunks(2))
    parts0 = ts.parts.copy()
    masks0 = ts.stream.arena.masks_np().copy()
    traffic0 = ts.traffic
    op_g, _ = _op_both(js, ts, lambda s: s.grow_k())
    op_s, _ = _op_both(js, ts, lambda s: s.shrink_k())
    assert not op_g.committed and not op_s.committed and ts.k == 4
    assert op_g.traffic.migration_bytes > 0     # metered, not committed
    assert np.array_equal(ts.parts, parts0)
    assert np.array_equal(ts.stream.arena.masks_np(), masks0)
    assert ts.traffic == traffic0
    # a vetoed grow still drew its permutation: the next grow draws the
    # same op ordinal in both packages
    _op_both(js, ts, lambda s: s.grow_k(force=True))


@pytest.mark.parametrize("k,mig,sav", [(4, 50, 10), (4, 5000, 10),
                                       (8, 0, 10**9), (2, 0, 10**9),
                                       (5, 320, 10), (5, 321, 10)])
def test_threshold_policy_budget_gate(k, mig, sav):
    pol = ThresholdPolicy(min_k=2, max_k=8, budget_feeds=32)
    jpol = JThreshold(min_k=2, max_k=8, budget_feeds=32)
    st = FleetState(k, 5, np.ones(k), np.ones(k), migration_bytes=mig,
                    projected_savings=sav)
    jst = JFleetState(k, 5, np.ones(k), np.ones(k), migration_bytes=mig,
                      projected_savings=sav)
    assert (pol.grow(st), pol.shrink(st)) == (jpol.grow(jst),
                                              jpol.shrink(jst))
    assert pol.repair(st) == "warm"
    w = np.array([0.5, 1.5])
    assert pol.rebalance(st, w) is w
    assert ThresholdPolicy(straggler_bias=False).rebalance(st, w) is None
    assert isinstance(ThresholdPolicy(), ElasticPolicy)
    assert isinstance(_NoPolicy(), ElasticPolicy)


# ------------------------------------------------------------- chaos
@pytest.mark.parametrize("seed", [0, 5, 9, 123])
def test_chaos_schedule_draws_match_jax(seed):
    """Open targets are drawn at construction, one draw an open event in
    declaration order, then sorted by feed: the same machines as JAX."""
    events = [(3, "kill", None, 4.0), (1, "straggle", None, 2.0),
              (1, "add", None, 4.0), (0, "recover", None, 4.0),
              (2, "kill", 7, 4.0), (4, "burst", None, 0.5)]
    js, ts = _schedules(events, seed)
    assert [dataclasses.astuple(e) for e in ts.events] == \
        [dataclasses.astuple(e) for e in js.events]
    for feed in range(6):
        assert [dataclasses.astuple(e) for e in ts.at(feed)] == \
            [dataclasses.astuple(e) for e in js.at(feed)]
    assert ts.remaining == js.remaining == 0


def test_chaos_schedule_deterministic_and_validated():
    ev = [ChaosEvent(3, "kill"), ChaosEvent(1, "straggle", factor=2.0),
          ChaosEvent(1, "add")]
    s1, s2 = ChaosSchedule(ev, seed=9), ChaosSchedule(ev, seed=9)
    assert s1.events == s2.events
    assert [e.kind for e in s1.at(1)] == ["straggle", "add"]
    assert s1.at(1) == []
    assert s1.remaining == 1
    s1.reset()
    assert s1.remaining == 3
    for bad, match in (((0, "explode"), "kind"),
                       ((0, "straggle", None, 1.0), "factor"),
                       ((-1, "kill"), "feed"),
                       ((0, "burst", None, 0.0), "factor")):
        with pytest.raises(ValueError, match=match):
            ChaosEvent(*bad)


def test_chaos_run_bit_deterministic():
    events = [(1, "kill", 1, 4.0), (2, "add", None, 4.0),
              (3, "straggle", 0, 4.0)]

    def run():
        jchaos, tchaos = _schedules(events, 5)
        js, ts = _sessions(jchaos=jchaos, tchaos=tchaos)
        _feed_both(js, ts, _chunks(4))
        return ts

    a, b = run(), run()
    assert a.k == b.k and np.array_equal(a.parts, b.parts)
    assert a.traffic == b.traffic
    kinds = [(o.kind, o.committed) for o in a.ops]
    assert ("repair", True) in kinds and ("grow", True) in kinds


def test_bench_chaos_script_replays_like_jax():
    """``benchmarks/bench_chaos.py``'s events at ``run(scale=0.1)``'s
    geometry: k 8 -> 12 with two seeded kills, one grow scan per add and
    one repair scan per kill, each feed equal to JAX."""
    geo = CHAOS_GEOMETRY
    g = j_text_like(geo["n_u"], geo["num_v"], mean_len=20, seed=0)
    bounds = np.linspace(0, geo["n_u"], geo["chunks"] + 1).astype(int)
    chunks = [g.slice_u(int(bounds[i]), int(bounds[i + 1]))
              for i in range(geo["chunks"])]
    base = dict(k=geo["k0"], backend="device_scan",
                block_size=geo["block"], refine_v=False, seed=0)
    jchaos, tchaos = _schedules(CHAOS_EVENTS, 0)
    js = JElastic(JElasticConfig(stream=JStreamConfig(
        base=JConfig(**base, use_kernel=False), repartition="never")),
        num_v=geo["num_v"], chaos=jchaos)
    ts = ElasticSession(ElasticConfig(stream=ParsaStreamConfig(
        base=ParsaConfig(**base), repartition="never")),
        num_v=geo["num_v"], chaos=tchaos, device="cpu")
    for i, c in enumerate(chunks):
        with dispatch_counter() as counts:
            ts.feed(_port(c))
        js.feed(c)
        _same_state(js, ts)
        due = [e[1] for e in CHAOS_EVENTS if e[0] == i]
        assert counts["stream_feed_scan"] == 1
        assert counts.get("elastic_grow_scan", 0) == due.count("add")
        assert counts.get("elastic_repair_scan", 0) == due.count("kill")
    _same_ops(js.ops, ts.ops)
    assert ts.k == 12 and tchaos.remaining == 0
    assert [o.kind for o in ts.ops] == ["grow"] * 2 + ["repair"] + \
        ["grow"] * 2 + ["repair"]


# --------------------------------------------------- straggler routing
@pytest.mark.parametrize("weights,nb", [([1.0, 1.0, 4.0, 2.0], 16),
                                        ([0.0, 1.0], 7),
                                        ([0.3, 0.3, 0.4], 10),
                                        ([1.0] * 8, 13)])
def test_weighted_block_targets_match_jax(weights, nb):
    t = _weighted_block_targets(np.array(weights), nb)
    assert np.array_equal(t, j_targets(np.array(weights), nb))
    assert t.sum() == nb


@pytest.mark.parametrize("seed", [None, 3])
def test_biased_perm_routes_padding_to_slow_workers(seed):
    targets = np.array([1, 7])
    nb, nb_per = 8, 7
    rng = None if seed is None else np.random.default_rng(seed)
    jrng = None if seed is None else np.random.default_rng(seed)
    perm = _biased_perm(targets, nb, nb_per, rng)
    assert np.array_equal(perm, j_biased_perm(targets, nb, nb_per, jrng))
    shard = perm.reshape(2, nb_per)
    assert (shard[0] < nb).sum() == 1 and (shard[1] < nb).sum() == 7
    assert sorted(p for p in perm if p < nb) == list(range(nb))


def test_straggler_ewma_seeds_lazily_and_floors():
    e = StragglerEWMA(4, alpha=0.5, floor=0.25)
    assert np.allclose(e.weights(), 1.0)
    e.update([1.0, np.nan, 1.0, 1.0])
    assert np.allclose(e.weights(), 1.0)
    e.update([1.0, 1.0, 100.0, 1.0])
    w = e.weights()
    assert w.argmin() == 2 and w[2] > 0
    with pytest.raises(ValueError, match="shape"):
        e.update([1.0])
    for bad, match in ((dict(workers=0), "workers"),
                       (dict(workers=2, alpha=0.0), "alpha"),
                       (dict(workers=2, floor=1.5), "floor")):
        with pytest.raises(ValueError, match=match):
            StragglerEWMA(**bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_ewma_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = StragglerEWMA(6, alpha=0.3, floor=0.1), JEWMA(6, alpha=0.3,
                                                         floor=0.1)
    for _ in range(12):
        t = rng.exponential(1.0, 6) * rng.choice([1.0, 10.0], 6)
        t[rng.random(6) < 0.2] = rng.choice([np.nan, 0.0, -1.0])
        a.update(t)
        b.update(t)
        assert np.array_equal(a.weights(), b.weights())


def test_straggler_accumulator():
    """``tests/test_fault.py::test_straggler_accumulator`` on tensors."""
    cfg = StragglerConfig(num_shards=4, quorum=0.75, max_delay=1,
                          stale_decay=0.5)
    acc = BoundedDelayAccumulator(cfg, {"g": torch.zeros(3)})
    g = {"g": torch.ones(3)}
    for s in range(3):
        acc.submit(s, g, arrived_step=0)
    assert acc.ready(arrived=3)
    torch.testing.assert_close(acc.take(arrived=3)["g"], torch.ones(3))
    acc.submit(3, g, arrived_step=0)
    for s in range(3):
        acc.submit(s, g, arrived_step=1)
    out = acc.take(arrived=4)
    torch.testing.assert_close(out["g"], torch.full((3,), (3 + 0.5) / 4))


@pytest.mark.parametrize("seed", range(6))
def test_straggler_accumulator_tau_bounded_matches_jax(seed):
    """The property of ``tests/test_fault.py`` (stale_decay 1: quorum
    steps with stale folds apply exactly the synchronous sum when every
    gradient arrives within τ), on seeded draws, with every take equal to
    the JAX accumulator's on the same submissions, over a nested tree."""
    rng = np.random.default_rng(seed)
    num_shards, steps = int(rng.integers(2, 6)), int(rng.integers(1, 5))
    tau = int(rng.integers(0, 3))
    jcfg = JStragglerConfig(num_shards=num_shards, quorum=1.0 / num_shards,
                            max_delay=tau, stale_decay=1.0)
    cfg = StragglerConfig(**dataclasses.asdict(jcfg))
    like = {"g": torch.zeros(2), "h": [torch.zeros(3)]}
    acc = BoundedDelayAccumulator(cfg, like)
    jacc = JAccumulator(jcfg, {"g": np.zeros(2, np.float32),
                               "h": [np.zeros(3, np.float32)]})
    grads = rng.uniform(-8, 8, (steps, num_shards, 5)).astype(np.float32)
    delays = rng.integers(0, tau + 1, (steps, num_shards))
    applied = np.zeros(5, np.float64)
    un_taken = 0

    def take():
        out = acc.take(arrived=un_taken)
        jout = jacc.take(arrived=un_taken)
        got = np.concatenate([out["g"].numpy(), out["h"][0].numpy()])
        want = np.concatenate([np.asarray(jout["g"]),
                               np.asarray(jout["h"][0])])
        assert np.array_equal(got, want)
        return got.astype(np.float64) * un_taken

    for t in range(steps + tau + 1):
        for step in range(steps):
            for s in range(num_shards):
                if step + delays[step][s] == t:
                    x = grads[step][s]
                    acc.submit(s, {"g": torch.from_numpy(x[:2]),
                                   "h": [torch.from_numpy(x[2:])]},
                               arrived_step=step)
                    jacc.submit(s, {"g": x[:2], "h": [x[2:]]},
                                arrived_step=step)
                    un_taken += 1
        ready = acc.ready(un_taken) if un_taken else False
        assert ready == (jacc.ready(un_taken) if un_taken else False)
        if ready:
            applied += take()
            un_taken = 0
    if un_taken:
        applied += take()
    np.testing.assert_allclose(applied,
                               grads.astype(np.float64).sum(axis=(0, 1)),
                               rtol=1e-5, atol=1e-4)


def test_observe_wallclock_weights_are_finite():
    """Measured scan seconds feed the EWMA: not deterministic, so only
    the shape and finiteness of the weights are held."""
    _, tc = _configs(workers=4, observe_wallclock=True)
    ts = ElasticSession(tc, num_v=NUM_V, device="cpu")
    for c in _chunks(2):
        ts.feed(_port(c))
    w = ts.ewma.weights()
    assert w.shape == (4,) and np.isfinite(w).all() and (w > 0).all()
    assert ts.ewma._seen.all()


# ------------------------------------------------------ 4 workers, JAX
PAR_CASES = {
    # tests/test_elastic.py::test_parallel_feed_with_bias_covers_all_rows
    "bias": dict(events=None, straggle=8.0, chunks=[[3, 1], [2, 3]],
                 kw={}),
    # a chaos run at 4 workers: straggle, add, kill, recover
    "chaos": dict(events=[[1, "straggle", 1, 4.0], [2, "add", None, 4.0],
                          [2, "kill", None, 4.0], [3, "recover", 1, 4.0]],
                  straggle=None, chunks=[[5, 1]], kw={}),
    # straggler bias off: the policy vetoes the EWMA weights
    "no_bias": dict(events=None, straggle=8.0, chunks=[[3, 1], [2, 3]],
                    kw={"straggler_bias": False}),
}

_JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.api import ParsaConfig, ParsaStreamConfig
from repro.elastic import (ChaosEvent, ChaosSchedule, ElasticConfig,
                           ElasticSession)
from repro.graphs import ctr_like_stream

cases, out_path = json.loads(sys.argv[1])
out = {}
for name, case in cases.items():
    base = ParsaConfig(k=4, backend="parallel_device", workers=4,
                       block_size=32, merge_every=1, refine_v=False,
                       use_kernel=False)
    cfg = ElasticConfig(stream=ParsaStreamConfig(
        base=base, repartition="never", repartition_frac=0.02),
        min_k=2, max_k=16, **case["kw"])
    chaos = (None if case["events"] is None else ChaosSchedule(
        [ChaosEvent(*e) for e in case["events"]], seed=3))
    sess = ElasticSession(cfg, num_v=1500, chaos=chaos)
    i = 0
    for part, (n, seed) in enumerate(case["chunks"]):
        if part == 1 and case["straggle"] is not None:
            sess._straggle[0] = case["straggle"]
        for c in ctr_like_stream(600, 1500, chunks=n, nnz_per_row=10,
                                 churn=0.3, seed=seed):
            u = sess.feed(c)
            p = f"{name}/{i}/"
            out[p + "parts"] = sess.parts.copy()
            out[p + "masks"] = sess.stream.arena.masks_np(logical=False)
            out[p + "sizes"] = np.asarray(sess.stream.arena.sizes)
            out[p + "traffic"] = np.asarray(dataclasses.astuple(sess.traffic))
            out[p + "weights"] = sess.ewma.weights()
            out[p + "dispatches"] = json.dumps(u.dispatches, sort_keys=True)
            i += 1
    out[name + "/ops"] = json.dumps([
        [o.kind, o.committed, o.k_before, o.k_after, o.machine,
         list(dataclasses.astuple(o.traffic)), o.projected_savings,
         o.moved_u, o.mode, o.partner] for o in sess.ops])
np.savez(out_path, **out)
print("JAX_ELASTIC_DONE")
"""


@pytest.fixture(scope="module")
def jax_parallel_elastic(tmp_path_factory):
    """JAX ``parallel_device`` elastic sessions on 8 forced host devices,
    computed once in a subprocess (the device count is fixed when JAX
    starts)."""
    path = tmp_path_factory.mktemp("jax_elastic") / "out.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([PAR_CASES, str(path)])
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, arg], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "JAX_ELASTIC_DONE" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path, allow_pickle=True))


@pytest.mark.parametrize("name", list(PAR_CASES))
def test_parallel_elastic_matches_jax(jax_parallel_elastic, name):
    case = PAR_CASES[name]
    _, tc = _configs(workers=4, **case["kw"])
    chaos = (None if case["events"] is None else ChaosSchedule(
        [ChaosEvent(*e) for e in case["events"]], seed=3))
    ts = ElasticSession(tc, num_v=NUM_V, chaos=chaos, device="cpu")
    want = jax_parallel_elastic
    i = 0
    for part, (n, seed) in enumerate(case["chunks"]):
        if part == 1 and case["straggle"] is not None:
            ts._straggle[0] = case["straggle"]
        for c in _chunks(n, seed=seed):
            u = ts.feed(_port(c))
            p = f"{name}/{i}/"
            assert np.array_equal(ts.parts, want[p + "parts"]), p
            assert np.array_equal(ts.stream.arena.masks_np(logical=False),
                                  want[p + "masks"]), p
            assert np.array_equal(ts.stream.arena.sizes.numpy(),
                                  want[p + "sizes"]), p
            assert list(dataclasses.astuple(ts.traffic)) == \
                list(want[p + "traffic"]), p
            assert np.array_equal(ts.ewma.weights(), want[p + "weights"]), p
            assert json.dumps(u.dispatches, sort_keys=True) == \
                str(want[p + "dispatches"]), p
            i += 1
    ops = [[o.kind, o.committed, o.k_before, o.k_after, o.machine,
            list(dataclasses.astuple(o.traffic)), o.projected_savings,
            o.moved_u, o.mode, o.partner] for o in ts.ops]
    assert json.dumps(ops) == str(want[name + "/ops"])
    assert np.bincount(ts.parts, minlength=ts.k).sum() == ts.parts.shape[0]
    if case["straggle"] is not None:
        assert ts.ewma.weights().argmin() == 0
    if name == "chaos":
        assert [o.kind for o in ts.ops] == ["grow", "repair"]


# ------------------------------------------------------------ PS bridge
def test_sync_cluster_pushes_elastic_placement():
    from repro.ml.dbpg import DBPGConfig as JDBPG
    from repro.ml.ps import PSCluster as JPS
    from repro_torch.ml import DBPGConfig, PSCluster

    js, ts = _fed(n=2)
    g = ts.stream.arena.graph()
    labels = np.zeros(g.num_u, np.float32)
    jps = JPS(js.stream.arena.graph(), labels, js.parts.copy(),
              np.full(g.num_v, -1, np.int32), js.k, JDBPG())
    tps = PSCluster(g, labels, ts.parts.copy(),
                    np.full(g.num_v, -1, np.int32), ts.k, DBPGConfig(),
                    device="cpu")
    _op_both(js, ts, lambda s: s.grow_k(force=True))
    want, rep = js.sync_cluster(jps), ts.sync_cluster(tps)
    assert rep == want and rep["moved_rows"] > 0
    assert tps.k == ts.k == jps.k
    assert np.array_equal(tps.parts_u, ts.parts)
    assert np.array_equal(tps.meter.per_machine, jps.meter.per_machine)
    with pytest.raises(ValueError, match="rows"):
        ts.sync_cluster(PSCluster(g.slice_u(0, 10), labels[:10],
                                  ts.parts[:10].copy(),
                                  np.full(g.num_v, -1, np.int32), ts.k,
                                  DBPGConfig(), device="cpu"))


# ------------------------------------------------- stream k-change hook
def test_apply_partition_state_validates_shapes():
    _, ts = _fed(n=1)
    W_cap = ts.stream.arena.W_cap
    n = ts.parts.shape[0]
    with pytest.raises(ValueError, match="capacity-stable"):
        ts.stream.apply_partition_state(
            np.zeros(n, np.int32), np.zeros((5, W_cap + 1), np.int32), k=5)
    with pytest.raises(ValueError, match="U rows"):
        ts.stream.apply_partition_state(
            np.zeros(n + 3, np.int32), np.zeros((4, W_cap), np.int32))


def test_feed_after_k_change_keeps_streaming():
    js, ts = _fed(n=2)
    _op_both(js, ts, lambda s: s.grow_k(force=True))
    k_new = ts.k
    with dispatch_counter():
        upd = ts.feed(_port(_chunks(1, seed=9)[0]))
    js.feed(_chunks(1, seed=9)[0])
    _same_state(js, ts)
    assert upd.metrics.k == k_new
    assert upd.dispatches.get("stream_feed_scan") == 1
    want = evaluate(ts.stream.arena.graph(), ts.parts, None, ts.k)
    assert ts.stream._popcount_metrics().traffic_sum >= want.traffic_sum


def test_empty_part_repair_and_refused_grow_draw_no_permutation():
    """A part with no rows: its repair is the no-scan path, and a grow
    whose largest part has one row is refused; neither advances the op
    ordinal, so the next grow draws the JAX permutation."""
    js, ts = _sessions()
    tiny = _chunks(8)[0].slice_u(0, 2)
    _feed_both(js, ts, [tiny])
    empty = int(np.flatnonzero(np.bincount(ts.parts, minlength=4) == 0)[0])
    op, counts = _op_both(js, ts, lambda s: s.repair(empty))
    assert op.committed and op.moved_u == 0 and counts.records == []
    op, counts = _op_both(js, ts, lambda s: s.grow_k(force=True))
    assert not op.committed and counts.records == []
    assert ts._n_ops == 0
    _feed_both(js, ts, _chunks(2))
    _op_both(js, ts, lambda s: s.grow_k(force=True))
    _op_both(js, ts, lambda s: s.grow_k(target=0, force=True))
    assert ts._n_ops == 2
    with pytest.raises(ValueError, match="machine"):
        ts.repair(ts.k)
    with pytest.raises(ValueError, match="warm"):
        ts.repair(0, mode="lukewarm")


def test_shrink_at_min_k_is_refused():
    js, ts = _fed(k=2)
    op, counts = _op_both(js, ts, lambda s: s.shrink_k(force=True))
    assert op.committed and ts.k == 1
    op, _ = _op_both(js, ts, lambda s: s.shrink_k(force=True))
    assert not op.committed and op.machine == -1


# ------------------------------------- satellite: need-pack int32 ceiling
def test_need_masks_past_the_int32_key_ceiling():
    """The JAX package refuses k * num_v past 2^31 (int32 keys); the port
    builds int64 keys and computes past that ceiling."""
    num_v = 2**31 // 4 + 1
    g = BipartiteGraph(2, num_v, np.array([0, 1, 2], np.int64),
                       np.array([0, num_v - 1], np.int32))
    masks = need_masks(g, np.array([0, 3], np.int32), 4, device="cpu")
    W = (num_v + 31) // 32
    assert masks.shape == (4, W)
    nz = torch.nonzero(masks).tolist()
    assert nz == [[0, 0], [3, W - 1]]
    assert int(masks[0, 0]) == 1
    assert int(masks[3, W - 1]) == 1 << ((num_v - 1) % 32)


# --------------------------------------- satellite: drift cold window
def test_drift_tracker_cold_window_lazy_seed():
    def metrics(max_foot, k=4):
        foot = np.full(k, 50, np.int64)
        foot[0] = max_foot
        return PartitionMetrics(k, np.ones(k, np.int64), foot, foot.copy(),
                                foot.copy(), np.zeros(k, np.int64))

    t = DriftTracker(window=8, threshold=1.0, min_feeds=1)
    d0 = t.update(metrics(100))
    assert not d0.repartition and d0.baseline == pytest.approx(d0.drift)
    d1 = t.update(metrics(100))
    assert not d1.repartition and d1.baseline == pytest.approx(d0.drift)
    d2 = t.update(metrics(300))
    assert d2.repartition
    d3 = t.update(metrics(300))
    assert not d3.repartition and d3.baseline == pytest.approx(d3.drift)


def test_migration_bytes_accumulates_separately():
    a = TrafficCounters(pushed_bytes=8, migration_bytes=100)
    b = TrafficCounters(pulled_bytes=4, migration_bytes=50)
    s = a + b
    assert s.migration_bytes == 150
    assert (s.pushed_bytes, s.pulled_bytes) == (8, 4)
    assert dataclasses.astuple(s) == dataclasses.astuple(
        JTraffic(pushed_bytes=8, migration_bytes=100)
        + JTraffic(pulled_bytes=4, migration_bytes=50))


# ------------------------------------------------------- sketched arena
def test_elastic_sketch_grow_repair_one_dispatch():
    """``tests/test_sketch.py::test_elastic_sketch_grow_repair_one_dispatch``
    against JAX: grow and repair on a sketched arena, one scan each."""
    js, ts = _sessions(base_extra=dict(set_repr="sketch",
                                       sketch_hot_bits=256,
                                       sketch_bucket_bits=128))
    _feed_both(js, ts, j_ctr_like_stream(600, NUM_V, chunks=3,
                                         nnz_per_row=10, seed=1))
    assert ts.stream.sketch is not None
    k0 = ts.k
    op, counts = _op_both(js, ts, lambda s: s.grow_k(force=True))
    assert op.committed and ts.k == k0 + 1
    assert counts["elastic_grow_scan"] == 1
    assert sum(v for n, v in counts.items() if "scan" in n) == 1
    op, counts = _op_both(js, ts, lambda s: s.repair(1))
    assert counts["elastic_repair_scan"] == 1
    assert sum(v for n, v in counts.items() if "scan" in n) == 1
    assert ts.parts.max() < ts.k
    assert ts.parts.shape[0] == ts.stream.arena.num_u


# ------------------------------------------------------------ surface
def test_api_surface_and_config_validation():
    from repro import api as japi

    names = ("ChaosEvent", "ChaosSchedule", "ElasticConfig",
             "ElasticPolicy", "ElasticSession", "ThresholdPolicy")
    for name in names:
        assert getattr(tapi, name).__name__ == getattr(japi, name).__name__
        assert name in tapi.__all__
    stream = ParsaStreamConfig(base=ParsaConfig(**_base()))
    for bad, match in ((dict(min_k=0), "min_k"), (dict(min_k=5, max_k=4),
                                                   "min_k"),
                       (dict(budget_feeds=-1), "budget_feeds")):
        with pytest.raises(ValueError, match=match):
            ElasticConfig(stream=stream, **bad)


def test_elastic_entry_points_need_the_card(monkeypatch):
    _, tc = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ElasticSession(tc, num_v=NUM_V)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_elastic_equals_cpu_elastic(cuda_device):
    _, tc = _configs()
    cpu = ElasticSession(tc, num_v=NUM_V, device="cpu")
    gpu = ElasticSession(tc, num_v=NUM_V, device=cuda_device)
    for s in (cpu, gpu):
        for c in _chunks(3):
            s.feed(_port(c))
        s.grow_k(force=True)
        s.repair(0)
        s.shrink_k(force=True)
    assert np.array_equal(cpu.parts, gpu.parts)
    assert np.array_equal(cpu.stream.arena.masks_np(),
                          gpu.stream.arena.masks_np())
    assert [_op_fields(o) for o in cpu.ops] == [_op_fields(o)
                                                for o in gpu.ops]
