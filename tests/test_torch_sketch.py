"""The port's sketched server sets against the JAX package: the copied
``SketchSpec``, the plain version of the one-launch ``sketch_select``
kernel, and ``partition(set_repr="sketch")`` end to end, warm starts
included, bit for bit on the CPU path (tolerance 0: every output is an
integer).  Graphs are those of ``tests/test_sketch.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as js
from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.graphs import ctr_like as j_ctr_like
from repro.graphs import text_like as j_text_like
from repro.kernels import parsa_cost as jk
from repro.sketch.spec import linear_counting_error as j_lc_error
from repro_torch import sketch as ts
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import (
    graph_from_numpy,
    result_from_numpy,
    sketch_from_numpy,
)
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.kernels.parsa_cost import BIG, ops, sketch_select_ref
from repro_torch.sketch.spec import linear_counting_error

METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
# the compressing geometry of test_sketch.py's facade tests
SKETCH_KW = dict(set_repr="sketch", sketch_hot_bits=1024,
                 sketch_bucket_bits=512)


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _specs(num_v, hot, buckets, seed, hot_ids=None):
    kw = dict(num_v=num_v, hot_bits=hot, bucket_bits=buckets, seed=seed,
              hot_ids=hot_ids)
    return ts.SketchSpec(**kw), js.SketchSpec(**kw)


def _assert_spec_equal(got, want):
    for f in ("num_v", "hot_bits", "bucket_bits", "seed", "is_exact",
              "width_bits", "width_words"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.hot_ids is None) == (want.hot_ids is None)
    if want.hot_ids is not None:
        assert np.array_equal(got.hot_ids, want.hot_ids)


def _assert_results_equal(got, want):
    assert np.array_equal(got.parts_u, want.parts_u)
    assert np.array_equal(got.s_masks, np.asarray(want.s_masks))
    assert (got.parts_v is None) == (want.parts_v is None)
    if want.parts_v is not None:
        assert got.parts_v.dtype == want.parts_v.dtype
        assert np.array_equal(got.parts_v, want.parts_v)
    assert got.num_v == want.num_v
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(got.metrics, f),
                              getattr(want.metrics, f)), f
    assert (got.sketch is None) == (want.sketch is None)
    if want.sketch is not None:
        _assert_spec_equal(got.sketch, want.sketch)


# ------------------------------------------------------------ SketchSpec
@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("num_v,hot,buckets,seed", [
    (2000, 64, 96, 0), (1111, 96, 72, 3), (50_000, 512, 2048, 1),
])
def test_spec_map_and_transforms_match_jax(num_v, hot, buckets, seed, ranked):
    """map_columns (growth columns included), sketch_graph, sketch_masks,
    expand_parts_v, the estimates and the memory model, on a ragged num_v,
    with the identity hot prefix and with ranked hot ids."""
    rng = np.random.default_rng(seed)
    g = j_ctr_like(300, num_v, nnz_per_row=12, seed=seed)
    hot_ids = None
    if ranked:
        hot_ids = js.rank_hot_columns(g, hot)
        assert np.array_equal(ts.rank_hot_columns(_port(g), hot), hot_ids)
    got, want = _specs(num_v, hot, buckets, seed, hot_ids)
    _assert_spec_equal(got, want)
    assert got.compression == want.compression
    cols = np.concatenate([np.arange(num_v), [num_v, 5 * num_v, 10**9]])
    mapped = got.map_columns(cols)
    assert mapped.dtype == want.map_columns(cols).dtype
    assert np.array_equal(mapped, want.map_columns(cols))
    gs, gj = got.sketch_graph(_port(g)), want.sketch_graph(g)
    assert (gs.num_u, gs.num_v) == (gj.num_u, gj.num_v)
    assert np.array_equal(gs.u_indptr, gj.u_indptr)
    assert np.array_equal(gs.u_indices, gj.u_indices)
    assert gs.u_indices.dtype == gj.u_indices.dtype
    sets = rng.random((6, num_v)) < 0.05
    packed = jk.pack_bitmask(sets, num_v)
    for s in (sets, packed):
        assert np.array_equal(got.sketch_masks(s), want.sketch_masks(s))
    pv = rng.integers(-1, 8, got.width_bits).astype(np.int32)
    assert np.array_equal(got.expand_parts_v(pv), want.expand_parts_v(pv))
    row = got.sketch_masks(packed)[0]
    assert got.estimate_cardinality(row) == want.estimate_cardinality(row)
    for tail_n in (0, 50, 4000):
        assert got.error_band(tail_n) == want.error_band(tail_n)
    assert got.mem_bytes(16, 1024, 4) == want.mem_bytes(16, 1024, 4)
    assert got.exact_mem_bytes(16, 1024) == want.exact_mem_bytes(16, 1024)


def test_spec_exact_collapse_matches_jax():
    """hot_bits >= num_v collapses to the identity map: no buckets, the
    graph and masks pass through, expand is a copy."""
    got = ts.SketchSpec.for_graph(300, 512, 128, seed=5)
    want = js.SketchSpec.for_graph(300, 512, 128, seed=5)
    _assert_spec_equal(got, want)
    assert got.is_exact and got.bucket_bits == 0 and got.width_bits == 300
    g = _port(j_text_like(40, 300, mean_len=6, seed=0))
    assert got.sketch_graph(g) is g
    masks = jk.pack_bitmask(np.random.default_rng(0).random((3, 300)) < .2,
                            300)
    assert np.array_equal(got.sketch_masks(masks), masks)
    pv = np.arange(300, dtype=np.int32) % 7
    assert np.array_equal(got.expand_parts_v(pv), want.expand_parts_v(pv))
    assert got.error_band(100) == want.error_band(100) == 0.0
    row = masks[:1]
    assert got.estimate_cardinality(row) == want.estimate_cardinality(row)


def test_spec_helpers_and_validation_match_jax():
    rng = np.random.default_rng(2)
    masks = rng.integers(0, 2**32, size=(9, 13), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    assert np.array_equal(ts.packed_popcount_rows(masks),
                          js.packed_popcount_rows(masks))
    for occ, m in ((0, 64), (10, 64), (64, 64), (700, 2048)):
        assert ts.linear_counting_estimate(occ, m) == \
            js.linear_counting_estimate(occ, m)
    for n, m in ((4, 64), (64, 64), (5000, 2048)):
        assert linear_counting_error(n, m) == j_lc_error(n, m)
    for args in ((2**17, 16, 1024), (100_000_000, 16, 1024, 8)):
        assert ts.set_structure_bytes(*args) == js.set_structure_bytes(*args)
    for kw, match in [(dict(num_v=0, hot_bits=0, bucket_bits=1), "num_v"),
                      (dict(num_v=100, hot_bits=-1, bucket_bits=1),
                       "hot_bits"),
                      (dict(num_v=100, hot_bits=32, bucket_bits=-1),
                       "bucket_bits"),
                      (dict(num_v=100, hot_bits=32, bucket_bits=0),
                       "bucket_bits"),
                      (dict(num_v=100, hot_bits=32, bucket_bits=32,
                            hot_ids=np.arange(5)), "hot_ids")]:
        with pytest.raises(ValueError, match=match):
            js.SketchSpec(**kw)
        with pytest.raises(ValueError, match=match):
            ts.SketchSpec(**kw)


# ------------------------------------------- the plain sketch_select
@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("B", [256, 1024])
def test_sketch_cost_select_matches_jax(B, k, greedy):
    """The CPU path of sketch_cost_select equals the JAX
    sketch_cost_select(use_kernel=False) on the ragged 12-word width of
    test_sketch.py, retired rows and disabled slots included.  (B=1024,
    k=64) is past the kernel's shared-memory guard."""
    rng = np.random.default_rng(B + k + greedy)
    width = 372                                   # 12 words, ragged
    nbr = jk.pack_bitmask(
        [rng.choice(width, size=rng.integers(1, 60)) for _ in range(B)],
        width)
    s = jk.pack_bitmask(rng.random((k, width)) < 0.15, width)
    retired = rng.random(B) < 0.1
    order = rng.permutation(k).astype(np.int32)
    enabled = rng.random(k) < 0.9
    jkw = dict(order=jnp.asarray(order),
               enabled=jnp.asarray(enabled)) if greedy else {}
    tkw = dict(order=_t(order), enabled=_t(enabled)) if greedy else {}
    want = jk.sketch_cost_select(jnp.asarray(nbr), jnp.asarray(s),
                                 jnp.asarray(retired), use_kernel=False,
                                 **jkw)
    got = ops.sketch_cost_select(_t(nbr), _t(s), _t(retired), **tkw)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32 and g_.shape == (k,)
        assert np.array_equal(g_.numpy(), np.asarray(w_))
    u, c = sketch_select_ref(_t(nbr), _t(s), _t(retired), *tkw.values(),
                             greedy=greedy)
    assert u.shape == c.shape == (1, k)
    ju, jc = jk.sketch_select_ref(jnp.asarray(nbr), jnp.asarray(s),
                                  jnp.asarray(retired), *jkw.values(),
                                  greedy=greedy)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    assert np.array_equal(c.numpy(), np.asarray(jc))


def test_sketch_select_guard_is_a_shape_function():
    """The route past the guard depends on (B, k) alone: both geometries of
    the sketched scan fit one CTA's shared memory (the tile, 8 candidates a
    greedy slot and B taken flags), a 256 KiB tile does not, and B stays
    within the epilogue's per-thread bitmask."""
    assert ops.SKETCH_SELECT_MAX_SMEM_BYTES == 227 * 1024
    assert ops.sketch_smem_bytes(256, 16) == 16 * 1024 + 512 + 256
    assert ops.sketch_select_fits(256, 16)      # 16 KiB tile
    assert ops.sketch_select_fits(1024, 16)     # 64 KiB tile
    assert ops.sketch_select_fits(256, 64)
    assert ops.sketch_select_fits(1024, 56)     # 224 KiB tile: 232,192 bytes
    assert not ops.sketch_select_fits(1024, 64)  # 256 KiB tile
    # largest B at k=2: 4 * (2 B + 4) + B bytes, rounded up to 16
    assert ops.sketch_select_fits(25_825, 2)
    assert not ops.sketch_select_fits(25_826, 2)
    assert not ops.sketch_select_fits(ops.SELECT_MAX_B + 8, 1)


def test_sketch_select_cascade_empty_and_disabled_slots():
    """All-identical columns cascade to k distinct rows; all-retired rows
    and disabled slots give (-1, BIG); on the CPU nothing launches."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(7)
    B, k, width = 128, 16, 500
    nbr = _t(jk.pack_bitmask(
        [rng.choice(width, size=20, replace=False) for _ in range(B)], width))
    s = torch.zeros((k, nbr.shape[1]), dtype=torch.int32)
    order = torch.arange(k, dtype=torch.int32)
    u, c = ops.sketch_cost_select(nbr, s, torch.zeros(B, dtype=torch.bool),
                                  order=order)
    assert len(set(u.tolist())) == k and (c < BIG).all()
    u, c = ops.sketch_cost_select(nbr, s, torch.ones(B, dtype=torch.bool),
                                  order=order)
    assert u.tolist() == [-1] * k and c.tolist() == [BIG] * k
    en = torch.zeros(k, dtype=torch.bool)
    en[3] = True
    u, c = ops.sketch_cost_select(nbr, s, torch.zeros(B, dtype=torch.bool),
                                  order=order, enabled=en)
    assert (u[:3] == -1).all() and u[3] >= 0 and (u[4:] == -1).all()
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="word widths"):
        ops.sketch_cost_select(nbr, s[:, :3].contiguous(),
                               torch.zeros(B, dtype=torch.bool))


# ------------------------------------------------------------- the facade
@pytest.mark.parametrize("refine_backend", ["device", "host"])
def test_sketched_partition_matches_jax(refine_backend):
    """A compressing run: parts_u, sketch-space s_masks, parts_v expanded to
    the true |V|, every metric, the spec with its ranked hot ids, and the
    timings' keys."""
    g = j_ctr_like(800, 4000, nnz_per_row=15, seed=2)
    kw = dict(k=8, backend="device_scan", block_size=128,
              refine_backend=refine_backend, **SKETCH_KW)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    _assert_results_equal(got, want)
    assert not got.sketch.is_exact and got.sketch.hot_ids is not None
    assert got.parts_v.shape == (4000,)
    assert got.num_v == got.sketch.width_bits
    assert set(got.timings) == set(want.timings)
    assert "sketch" in got.timings


def test_sketch_exact_collapse_matches_exact_run_and_jax():
    """hot_bits >= |V| is bit-identical to the exact pipeline."""
    g = j_text_like(500, 900, mean_len=15, seed=9)
    kw = dict(k=8, backend="device_scan", block_size=64,
              refine_backend="device", sweeps=2)
    sk = dict(set_repr="sketch", sketch_hot_bits=1024, sketch_bucket_bits=32)
    exact = partition(_port(g), ParsaConfig(**kw), device="cpu")
    got = partition(_port(g), ParsaConfig(**kw, **sk), device="cpu")
    want = j_partition(g, JConfig(**kw, **sk))
    _assert_results_equal(got, want)
    assert got.sketch.is_exact and exact.sketch is None
    for name in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(got, name), getattr(exact, name))
    assert got.metrics.as_dict() == exact.metrics.as_dict()


def test_sketched_host_blocked_oracle_matches_device_scan():
    """The parity oracle runs at the sketched width, as in JAX."""
    g = _port(j_ctr_like(500, 3000, nnz_per_row=12, seed=4))
    cfg = ParsaConfig(k=8, block_size=64, refine_backend="device",
                      **SKETCH_KW)
    scan = partition(g, cfg, device="cpu")
    loop = partition(g, cfg.replace(backend="host_blocked_oracle"),
                     device="cpu")
    for name in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(scan, name), getattr(loop, name))


# ----------------------------------------------------------- warm starts
def _warm_graphs():
    return (j_ctr_like(600, 4000, nnz_per_row=15, seed=2),
            j_ctr_like(500, 4000, nnz_per_row=15, seed=3))


def test_sketched_refine_keeps_spec_and_matches_jax():
    g1, g2 = _warm_graphs()
    kw = dict(k=8, backend="device_scan", block_size=128,
              refine_backend="device", **SKETCH_KW)
    j1 = j_partition(g1, JConfig(**kw))
    want = j1.refine(g2)
    r1 = partition(_port(g1), ParsaConfig(**kw), device="cpu")
    got = r1.refine(_port(g2))
    assert got.sketch is r1.sketch
    _assert_results_equal(got, want)
    # a dense true-domain warm start compresses to the same sets
    dense = np.zeros((8, 4000), bool)
    dense[:, :50] = True
    a = partition(_port(g2), ParsaConfig(**kw), init_sets=dense,
                  sketch_spec=r1.sketch, device="cpu")
    b = j_partition(g2, JConfig(**kw), init_sets=dense,
                    sketch_spec=j1.sketch)
    _assert_results_equal(a, b)
    with pytest.raises(ValueError, match="same parameter side"):
        r1.refine(_port(j_ctr_like(50, 3999, nnz_per_row=5, seed=0)))


def test_jax_sketched_result_carried_over_refines_the_same():
    g1, g2 = _warm_graphs()
    cfg = JConfig(k=8, backend="device_scan", block_size=128,
                  refine_backend="device", **SKETCH_KW)
    r1 = j_partition(g1, cfg)
    want = r1.refine(g2)
    sp = r1.sketch
    spec = sketch_from_numpy(sp.num_v, sp.hot_bits, sp.bucket_bits, sp.seed,
                             None if sp.hot_ids is None
                             else np.asarray(sp.hot_ids))
    _assert_spec_equal(spec, sp)
    carried = result_from_numpy(r1.parts_u, r1.parts_v, r1.s_masks, 8,
                                r1.num_v, cfg, device="cpu", sketch=spec)
    assert carried.config.set_repr == "sketch"
    got = carried.refine(_port(g2))
    _assert_results_equal(got, want)


# -------------------------------------------------------------- dispatch
def test_sketch_mode_dispatches_like_exact_mode():
    g = _port(j_ctr_like(800, 4000, nnz_per_row=15, seed=2))
    cfg = ParsaConfig(k=8, block_size=128, refine_backend="device")
    logs = []
    for c in (cfg, cfg.replace(**SKETCH_KW)):
        with dispatch_counter() as counts:
            partition(g, c, device="cpu")
        logs.append(counts)
    assert logs[0] == logs[1] == {"partition_scan": 1, "refine_scan": 1,
                                  "metrics": 1}


# --------------------------------------------- the card (skipped here)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sketch_select_equals_plain_version(cuda_device):
    rng = np.random.default_rng(5)
    for B, k in ((256, 16), (1024, 16), (1024, 64)):
        words = rng.integers(0, 2**32, size=(B, 12), dtype=np.uint64)
        nbr = _t(words.astype(np.uint32).view(np.int32)).to(cuda_device)
        s = _t(rng.integers(0, 2**32, size=(k, 12), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(cuda_device)
        retired = _t(rng.random(B) < 0.2).to(cuda_device)
        order = _t(rng.permutation(k).astype(np.int32)).to(cuda_device)
        enabled = _t(rng.random(k) < 0.8).to(cuda_device)
        for kw, greedy in ((dict(order=order, enabled=enabled), True),
                           ({}, False)):
            got = ops.sketch_cost_select(nbr, s, retired, **kw)
            u, c = sketch_select_ref(nbr, s, retired, *kw.values(),
                                     greedy=greedy)
            want = (u[0], c[0]) if greedy else (c[0], u[0])
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_)
