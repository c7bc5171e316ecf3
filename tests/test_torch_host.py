"""The port's host algorithms against the JAX package: the graph's CSC side
and slicing, ``BucketQueue``, Algorithm 3 (``host``, with the §4.2/§4.4
subgraph driver), the Algorithm 4 simulation (``parallel_sim``) with §4.4
global initialization, the new config fields, and ``traffic`` carried
across by ``convert``.  Bit for bit: the program is integer."""
import numpy as np
import pytest

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core.bucket_queue import BucketQueue as JBucketQueue
from repro.core.parallel import global_initialization as j_global_init
from repro.graphs import text_like as j_text_like
from repro_torch.api import ParsaConfig, TrafficCounters, partition
from repro_torch.convert import graph_from_numpy, result_from_numpy
from repro_torch.core.bucket_queue import BucketQueue
from repro_torch.core.parallel import global_initialization
from repro_torch.core.subgraphs import divide

METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
TRAFFIC_FIELDS = ("pushed_bytes", "pulled_bytes", "tasks",
                  "stale_pushes_missed", "migration_bytes")


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _assert_results_equal(got, want):
    for f in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.neighbor_sets, want.neighbor_sets)
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(got.metrics, f),
                              getattr(want.metrics, f)), f
    assert (got.traffic is None) == (want.traffic is None)
    if want.traffic is not None:
        for f in TRAFFIC_FIELDS:
            assert getattr(got.traffic, f) == getattr(want.traffic, f), f


# ------------------------------------------------------------ the graph
def test_csc_degrees_and_slices_match_jax():
    g = j_text_like(300, 500, mean_len=12, seed=1)
    t = _port(g)
    assert np.array_equal(t.v_indptr, g.v_indptr)
    assert np.array_equal(t.v_indices, g.v_indices)
    assert np.array_equal(t.v_neighbors(7), g.v_neighbors(7))
    assert np.array_equal(t.degree_u(), g.degree_u())
    assert np.array_equal(t.degree_v(), g.degree_v())
    ids = np.random.default_rng(0).choice(300, 40, replace=False)
    for got, want in ((t.subgraph_u(ids), g.subgraph_u(ids)),
                      (t.slice_u(10, 90), g.slice_u(10, 90))):
        assert (got.num_u, got.num_v) == (want.num_u, want.num_v)
        assert np.array_equal(got.u_indptr, want.u_indptr)
        assert np.array_equal(got.u_indices, want.u_indices)
    with pytest.raises(ValueError, match="out of range"):
        t.slice_u(5, 301)
    plan = divide(t, 4, seed=3)
    assert sum(b.size for b in plan.blocks) == 300


@pytest.mark.parametrize("seed", range(3))
def test_bucket_queue_matches_jax(seed):
    """Random decrease / delete / pop sequences, overflow bucket included."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 40, 200)
    costs[:5] = 60                      # above theta: the overflow bucket
    qs = [BucketQueue(costs, theta=30), JBucketQueue(costs, theta=30)]
    for _ in range(400):
        op, i = rng.integers(0, 3), int(rng.integers(0, 200))
        if op == 0:
            c = int(rng.integers(0, 60))
            for q in qs:
                q.decrease(i, c)
        elif op == 1:
            for q in qs:
                q.delete(i)
        elif len(qs[0]):
            assert qs[0].pop_min() == qs[1].pop_min()
        assert len(qs[0]) == len(qs[1])
        assert np.array_equal(qs[0].cost, qs[1].cost)


# ------------------------------------------------------------- backends
@pytest.mark.parametrize("select", ["size", "footprint"])
@pytest.mark.parametrize("init_iters", [0, 2])
@pytest.mark.parametrize("blocks", [1, 4])
def test_host_backend_matches_jax(blocks, init_iters, select):
    g = j_text_like(240, 400, mean_len=10, seed=5)
    kw = dict(k=4, backend="host", blocks=blocks, init_iters=init_iters,
              select=select, seed=1, refine_backend="device", sweeps=2)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    _assert_results_equal(got, want)
    assert set(got.timings) == set(want.timings)


def test_host_backend_warm_start_and_host_refine_match_jax():
    g1 = j_text_like(200, 300, mean_len=10, seed=2)
    g2 = j_text_like(150, 300, mean_len=10, seed=3)
    cfg = dict(k=4, backend="host", refine_backend="host")
    r1 = j_partition(g1, JConfig(**cfg))
    want = r1.refine(g2)
    got = partition(_port(g2), ParsaConfig(**cfg), init_sets=r1.s_masks,
                    device="cpu")
    _assert_results_equal(got, want)


@pytest.mark.parametrize("tau", [0, 2, None])
def test_parallel_sim_matches_jax(tau):
    """W=4 workers, bounded or eventual delay, one individual-init pass
    and §4.4 global initialization; the device refine after global init
    must pack the need matrix (S_i ⊋ N(U_i)), not reuse the sets."""
    g = j_text_like(400, 600, mean_len=10, seed=7)
    kw = dict(k=4, backend="parallel_sim", blocks=8, workers=4, tau=tau,
              init_iters=1, global_init_frac=0.05, seed=3,
              refine_backend="device", sweeps=2)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    _assert_results_equal(got, want)
    assert got.traffic.tasks == 9 and got.traffic.pushed_bytes > 0


def test_global_init_makes_sets_larger_than_the_need_matrix():
    """Why the cold-start gate checks ``global_init_frac``: the sets hold
    N(U_i) and the sample's sets, so they are not the need matrix."""
    from repro_torch.core.costs import need_matrix

    g = j_text_like(400, 600, mean_len=10, seed=7)
    S = global_initialization(_port(g), 4, sample_frac=0.05, seed=3)
    assert np.array_equal(S, j_global_init(g, 4, sample_frac=0.05, seed=3))
    cfg = ParsaConfig(k=4, backend="parallel_sim", blocks=8,
                      global_init_frac=0.05, seed=3, refine_v=False)
    r = partition(_port(g), cfg, device="cpu")
    need = need_matrix(_port(g), r.parts_u, 4)
    assert not (need & ~r.neighbor_sets).any()
    assert (r.neighbor_sets & ~need).any()


# --------------------------------------------------------------- config
def test_new_config_fields_are_validated():
    for bad, match in [(dict(blocks=0), "blocks"),
                       (dict(init_iters=-1), "init_iters"),
                       (dict(select="random"), "select"),
                       (dict(workers=0), "workers"),
                       (dict(tau=-1), "tau"),
                       (dict(global_init_frac=1.5), "global_init_frac"),
                       (dict(merge_every=0), "merge_every"),
                       (dict(devices=0), "devices")]:
        with pytest.raises(ValueError, match=match):
            ParsaConfig(k=4, **bad)
    j, t = JConfig(k=4), ParsaConfig(k=4)
    for f in ("blocks", "init_iters", "theta", "select", "workers", "tau",
              "global_init_frac", "merge_every", "devices"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.backend == "device_scan" and j.backend == "host"
    assert ParsaConfig(k=4, tau=None).tau is None


def test_convert_carries_traffic_and_parallel_fields():
    g = j_text_like(300, 500, mean_len=10, seed=0)
    cfg = JConfig(k=4, backend="parallel_sim", blocks=4, workers=2, tau=1,
                  global_init_frac=0.1, merge_every=3)
    r = j_partition(g, cfg)
    got = result_from_numpy(r.parts_u, r.parts_v, r.s_masks, 4, g.num_v,
                            cfg, device="cpu", traffic=r.traffic)
    assert isinstance(got.traffic, TrafficCounters)
    for f in TRAFFIC_FIELDS:
        assert getattr(got.traffic, f) == getattr(r.traffic, f), f
    for f in ("backend", "blocks", "workers", "tau", "global_init_frac",
              "merge_every"):
        assert getattr(got.config, f) == getattr(cfg, f), f
    assert result_from_numpy(r.parts_u, None, r.s_masks, 4, g.num_v,
                             cfg).traffic is None
    total = got.traffic + TrafficCounters(pushed_bytes=4, migration_bytes=8)
    assert total.pushed_bytes == r.traffic.pushed_bytes + 4
    assert total.migration_bytes == 8 and total.tasks == r.traffic.tasks
