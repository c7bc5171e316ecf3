"""The port's online stream against the JAX package's: the same seeded
chunks through ``repro.stream.StreamSession`` (its plain reference,
``use_kernel=False``) and ``repro_torch.stream.StreamSession`` on the CPU
(the plain versions of the port's kernels), compared bit for bit
(tolerance 0: every output is an integer).  Per feed: parts, live sets,
sizes, ``StreamUpdate.metrics``, ``dispatches``, ``traffic``, ``W_cap``
and any ``MigrationPlan``; per stream: ``result(refine_v=True)``.  Cases
mirror ``tests/test_stream.py`` and the sketched-stream tests of
``tests/test_sketch.py``; 4-worker feeds run JAX ``parallel_device`` on 8
forced host devices in a subprocess."""
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
from repro.api import StreamSession as JSession
from repro.core.bipartite import BipartiteGraph as JGraph
from repro.graphs import ctr_like_stream as j_ctr_like_stream
from repro.graphs import social_like_stream as j_social_like_stream
from repro.graphs import text_like as j_text_like
from repro.graphs import text_like_stream as j_text_like_stream
from repro.kernels import parsa_cost as jk
from repro.stream import DriftTracker as JDriftTracker
from repro.stream import StreamArena as JArena
from repro.stream import plan_migration as j_plan_migration
from repro_torch import graphs as tg
from repro_torch.api import (
    ParsaConfig,
    ParsaStreamConfig,
    StreamSession,
    partition,
    stream_partition,
)
from repro_torch.convert import graph_from_numpy
from repro_torch.core.bipartite import BipartiteGraph
from repro_torch.core.costs import PartitionMetrics, evaluate, need_matrix
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.core.partition import pack_graph_blocks
from repro_torch.kernels.parsa_cost import (
    pack_bitmask,
    packed_intersect_counts,
    unpack_bitmask,
)
from repro_torch.stream import DriftTracker, StreamArena, plan_migration

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
PLAN_ARRAYS = ("assign", "parts_u", "s_masks")
PLAN_INTS = ("moved_u", "kept_overlap", "acquired_bytes", "retired_bytes")
BASE = dict(k=4, backend="device_scan", block_size=64, refine_v=False)
SKETCH = dict(BASE, set_repr="sketch", sketch_hot_bits=256,
              sketch_bucket_bits=128)


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _traffic(t):
    return None if t is None else dataclasses.astuple(t)


def _sessions(num_v, base=BASE, **skw):
    """(JAX session, port session on the CPU) on the same configuration."""
    js = JSession(JStreamConfig(base=JConfig(**base, use_kernel=False),
                                **skw), num_v=num_v)
    ts = StreamSession(ParsaStreamConfig(base=ParsaConfig(**base), **skw),
                       num_v=num_v, device="cpu")
    return js, ts


def _padding_bits_zero(masks: np.ndarray, num_v: int) -> bool:
    return not unpack_bitmask(masks, masks.shape[1] * 32)[:, num_v:].any()


def _same_metrics(a, b):
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _same_plan(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in PLAN_ARRAYS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in PLAN_INTS:
        assert getattr(a, f) == getattr(b, f), f
    assert _traffic(a.traffic) == _traffic(b.traffic)


def _same_update(a, b):
    assert (a.chunk, a.u_start, a.u_stop) == (b.chunk, b.u_start, b.u_stop)
    assert np.array_equal(a.parts, b.parts)
    _same_metrics(a.metrics, b.metrics)
    assert a.dispatches == b.dispatches
    assert _traffic(a.traffic) == _traffic(b.traffic)
    assert a.repartitioned == b.repartitioned
    assert (a.drift is None) == (b.drift is None)
    if a.drift is not None:
        assert dataclasses.astuple(a.drift) == dataclasses.astuple(b.drift)
    _same_plan(a.migration, b.migration)


def _same_state(js, ts):
    assert np.array_equal(ts.parts, js.parts)
    assert ts.arena.W_cap == js.arena.W_cap
    assert ts.arena.num_v == js.arena.num_v
    assert np.array_equal(ts.arena.masks_np(logical=False),
                          js.arena.masks_np(logical=False))
    assert np.array_equal(ts.arena.sizes.numpy(), np.asarray(js.arena.sizes))
    assert _traffic(ts.traffic) == _traffic(js.traffic)
    assert (ts.n_feeds, ts.repartitions) == (js.n_feeds, js.repartitions)


def _same_result(js, ts, refine_v=True):
    want, got = js.result(refine_v=refine_v), ts.result(refine_v=refine_v)
    assert np.array_equal(got.parts_u, want.parts_u)
    assert np.array_equal(got.s_masks, want.s_masks)
    assert (got.parts_v is None) == (want.parts_v is None)
    if want.parts_v is not None:
        assert np.array_equal(got.parts_v, want.parts_v)
    _same_metrics(got.metrics, want.metrics)
    assert got.num_v == want.num_v
    assert _traffic(got.traffic) == _traffic(want.traffic)
    return got


def _feed_both(js, ts, chunks):
    for c in chunks:
        _same_update(js.feed(c), ts.feed(_port(c)))
        _same_state(js, ts)
        assert _padding_bits_zero(ts.arena.masks_np(logical=False),
                                  ts.arena.num_v)


# ------------------------------------------------------------ one chunk
def test_one_chunk_feed_equals_device_scan():
    """The whole graph as ONE chunk is the device_scan backend: same
    permutation, same scan, same parts and sets; the result's parts_v and
    metrics are the facade's with refine_backend="device"."""
    g = j_text_like(900, 1100, mean_len=18, seed=11)
    js, ts = _sessions(g.num_v, base=dict(BASE, k=8))
    _feed_both(js, ts, [g])
    ref = partition(_port(g), ParsaConfig(**dict(BASE, k=8)), device="cpu")
    assert np.array_equal(ts.parts, ref.parts_u)
    assert np.array_equal(ts.arena.masks_np(), ref.s_masks)
    got = _same_result(js, ts)
    want = partition(_port(g), ParsaConfig(k=8, block_size=64,
                                           refine_backend="device"),
                     device="cpu")
    assert np.array_equal(got.parts_v, want.parts_v)
    _same_metrics(got.metrics, want.metrics)
    assert set(got.timings) == {"partition_v", "metrics", "total"}


# ------------------------------------------------------- exact streams
def test_four_chunk_feed_matches_jax():
    g = j_text_like(800, 1000, mean_len=15, seed=7)
    js, ts = _sessions(g.num_v, repartition="never")
    for i in range(4):
        chunk = g.slice_u(i * 200, (i + 1) * 200)
        want = js.feed(chunk)
        with dispatch_counter() as counts:
            upd = ts.feed(_port(chunk))
        _same_update(want, upd)
        _same_state(js, ts)
        assert upd.dispatches == {"stream_feed_scan": 1, "stream_metrics": 1}
        scan = next(r for r in counts.records
                    if r.phase == "stream_feed_scan")
        assert scan.nbytes == (ts.arena.s_masks.nbytes
                               + ts.arena.sizes.nbytes)
        assert scan.meta == {"k": 4}
        assert set(upd.timings) == {"pack", "partition_u", "metrics",
                                    "total"}
    sizes = np.bincount(ts.parts, minlength=4)
    assert sizes.max() - sizes.min() <= 1
    pg = _port(g)
    assert np.array_equal(pack_bitmask(need_matrix(pg, ts.parts, 4),
                                       g.num_v), ts.arena.masks_np())
    _same_result(js, ts)


@pytest.mark.parametrize("num_v", [97, 510, 1001])
def test_ragged_widths_keep_padding_bits_zero(num_v):
    """num_v % 32 != 0: the ragged last word's padding bits stay zero on
    both sides, and the popcount metrics equal the host evaluate."""
    chunks = j_text_like_stream(240, num_v, chunks=3, mean_len=9, seed=3)
    js, ts = _sessions(num_v)
    _feed_both(js, ts, chunks)
    want = evaluate(ts.arena.graph(), ts.parts, None, 4)
    assert ts._popcount_metrics().as_dict() == want.as_dict()
    _same_result(js, ts, refine_v=False)


def test_growing_v_doubles_capacity_like_jax():
    chunks = j_social_like_stream(600, chunks=4, m=5, seed=2)
    js, ts = _sessions(chunks[0].num_v, repartition="never")
    w0 = ts.arena.W_cap
    widths = []
    for c in chunks:
        _feed_both(js, ts, [c])
        widths.append(ts.arena.W_cap)
    assert ts.arena.num_v == 600
    assert ts.arena.W_cap >= (600 + 31) // 32 > w0
    assert len(set(widths)) > 1          # the scan ran at a new W mid-stream
    got = _same_result(js, ts)
    assert got.num_v == 600


@pytest.mark.parametrize("tb_pad", [1, 8, 64])
def test_truncated_rows_match_jax_at_any_tb_pad(tb_pad):
    """JAX pads a feed's truncated-row width TB to a power of two >=
    ``tb_pad`` (for its jit cache); the port takes TB from the chunk's
    rows.  The pad adds only dropped rows, so the bits agree at any pad."""
    chunks = j_text_like_stream(480, 1000, chunks=3, mean_len=30, seed=5)
    base = dict(BASE, cap=2)
    js = JSession(JStreamConfig(base=JConfig(**base, use_kernel=False),
                                repartition="never", tb_pad=tb_pad),
                  num_v=1000)
    ts = StreamSession(ParsaStreamConfig(base=ParsaConfig(**base),
                                         repartition="never"),
                       num_v=1000, device="cpu")
    packed = pack_graph_blocks(_port(chunks[0]), 64, cap=2)
    assert (packed.tr_ids != 64).any()       # the chunk has truncated rows
    _feed_both(js, ts, chunks)
    _same_result(js, ts)


# ------------------------------------------------------- drift repair
@pytest.mark.parametrize("frac", [0.0, 0.02])
def test_drift_repair_and_migration_match_jax(frac):
    chunks = j_ctr_like_stream(900, 2000, chunks=4, nnz_per_row=12,
                               churn=0.7, seed=1)
    js, ts = _sessions(2000, drift_threshold=1.0, drift_min_feeds=1,
                       repartition_frac=frac)
    updates = []
    for c in chunks:
        want, got = js.feed(c), ts.feed(_port(c))
        _same_update(want, got)
        _same_state(js, ts)
        updates.append(got)
    repaired = [u for u in updates if u.repartitioned]
    assert repaired, "drift repair never triggered"
    for u in updates:
        if u.repartitioned:
            assert u.dispatches == {"stream_feed_scan": 1,
                                    "stream_metrics": 2,
                                    "partition_scan": 1}
            assert "repartition" in u.timings
            m = u.migration
            assert m.traffic.migration_bytes == (m.acquired_bytes
                                                 + m.retired_bytes)
        else:
            assert u.dispatches == {"stream_feed_scan": 1,
                                    "stream_metrics": 1}
    assert ts._need_exact == (frac == 0.0)
    _same_result(js, ts)


def test_explicit_repartition_matches_jax():
    chunks = j_ctr_like_stream(800, 1600, chunks=4, nnz_per_row=12,
                               churn=0.8, seed=9)
    js, ts = _sessions(1600, repartition="never")
    _feed_both(js, ts, chunks)
    with dispatch_counter() as counts:
        plan = ts.repartition()
    _same_plan(js.repartition(), plan)
    assert dict(counts) == {"partition_scan": 1}
    _same_state(js, ts)
    assert np.array_equal(plan.parts_u, ts.parts)
    assert np.array_equal(ts.arena.sizes.numpy(),
                          np.bincount(plan.parts_u, minlength=4))
    _same_result(js, ts)


def test_apply_partition_state_at_new_k_then_feed():
    """The elastic hook: commit a k=6 state (capacity-stable sets), then
    feed at the new k in both packages."""
    chunks = j_text_like_stream(600, 700, chunks=3, mean_len=10, seed=5)
    js, ts = _sessions(700, repartition="never")
    _feed_both(js, ts, chunks[:2])
    parts6 = (ts.parts.astype(np.int64) * 7 % 6).astype(np.int32)
    need = pack_bitmask(need_matrix(ts.arena.graph(), parts6, 6), 700)
    masks = np.pad(need, [(0, 0), (0, ts.arena.W_cap - need.shape[1])])
    js.apply_partition_state(parts6, masks, k=6)
    ts.apply_partition_state(parts6, torch.from_numpy(masks), k=6)
    assert ts.k == 6 and ts.arena.k == 6
    _same_state(js, ts)
    _feed_both(js, ts, chunks[2:])
    with pytest.raises(ValueError, match="capacity-stable"):
        ts.apply_partition_state(ts.parts, masks[:, :-1], k=6)
    with pytest.raises(ValueError, match="U rows"):
        ts.apply_partition_state(ts.parts[:-1], masks, k=6)


# --------------------------------------------------------- sketched streams
def _grown(chunk, new_num_v):
    return JGraph(chunk.num_u, new_num_v, np.asarray(chunk.u_indptr),
                  np.asarray(chunk.u_indices))


def test_sketched_stream_feed_grow_save_load(tmp_path):
    """A compressing sketch: the arena runs at the sketch's width, V growth
    past num_v is free, the result expands parts_v to the true extent, and
    a snapshot resumes bit-identically, as in JAX."""
    num_v = 1500
    chunks = j_ctr_like_stream(600, num_v, chunks=3, nnz_per_row=10, seed=1)
    js, ts = _sessions(num_v, base=SKETCH, repartition="never")
    assert ts.sketch is not None
    assert ts.arena.num_v == ts.sketch.width_bits == js.sketch.width_bits
    for c in chunks:
        with dispatch_counter() as counts:
            _same_update(js.feed(c), ts.feed(_port(c)))
        assert dict(counts) == {"partition_scan": 0, "stream_feed_scan": 1,
                                "stream_metrics": 1}
        _same_state(js, ts)
    _feed_both(js, ts, [_grown(chunks[0], num_v + 800)])
    assert ts._true_num_v == js._true_num_v == num_v + 800
    got = _same_result(js, ts)
    assert got.sketch is ts.sketch and got.parts_v.shape == (num_v + 800,)
    ts.save(tmp_path / "t.npz")
    restored = StreamSession.load(tmp_path / "t.npz",
                                  ParsaStreamConfig(base=ParsaConfig(**SKETCH),
                                                    repartition="never"),
                                  device="cpu")
    assert restored.sketch.width_bits == ts.sketch.width_bits
    assert restored._true_num_v == ts._true_num_v
    more = j_ctr_like_stream(200, num_v, chunks=1, nnz_per_row=10, seed=4)
    want = js.feed(more[0])
    got = ts.feed(_port(more[0]))
    _same_update(want, got)
    _same_update(got, restored.feed(_port(more[0])))
    assert np.array_equal(restored.arena.masks_np(), ts.arena.masks_np())


def test_sketched_exact_collapse_is_the_exact_stream():
    num_v = 1001
    chunks = j_text_like_stream(240, num_v, chunks=3, mean_len=9, seed=3)
    js, ts = _sessions(num_v, base=dict(SKETCH, sketch_hot_bits=1024))
    assert ts.sketch is None and ts.arena.num_v == num_v
    _feed_both(js, ts, chunks)
    plain = StreamSession(ParsaStreamConfig(base=ParsaConfig(**BASE)),
                          num_v=num_v, device="cpu")
    for c in chunks:
        plain.feed(_port(c))
    assert np.array_equal(plain.parts, ts.parts)
    assert np.array_equal(plain.arena.masks_np(), ts.arena.masks_np())


# ------------------------------------------------------------ snapshots
def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """A stream saved by the JAX package loads into the port, and the next
    two feeds give JAX's bits (the stream's counterpart of carrying
    weights across); the port's snapshot loads back into JAX too."""
    chunks = j_ctr_like_stream(900, 2000, chunks=4, nnz_per_row=12,
                               churn=0.7, seed=1)
    skw = dict(drift_threshold=1.0, drift_min_feeds=1,
               repartition_frac=0.02)
    js, _ = _sessions(2000, **skw)
    js.feed(chunks[0])
    js.feed(chunks[1])
    js.save(tmp_path / "jax.npz")
    cfg = ParsaStreamConfig(base=ParsaConfig(**BASE), **skw)
    ts = StreamSession.load(tmp_path / "jax.npz", cfg, device="cpu")
    _same_state(js, ts)
    # the drift window is not persisted: a fresh JAX restore is the peer
    jr = JSession.load(tmp_path / "jax.npz",
                       JStreamConfig(base=JConfig(**BASE, use_kernel=False),
                                     **skw))
    _feed_both(jr, ts, chunks[2:])
    ts.save(tmp_path / "port.npz")
    back = JSession.load(tmp_path / "port.npz", jr.config)
    assert np.array_equal(back.parts, jr.parts)
    assert np.array_equal(back.arena.masks_np(), jr.arena.masks_np())
    assert back._rng.bit_generator.state == jr._rng.bit_generator.state
    with pytest.raises(ValueError, match="k="):
        StreamSession.load(tmp_path / "jax.npz",
                           ParsaStreamConfig(base=ParsaConfig(**dict(
                               BASE, k=8))), device="cpu")


def test_arena_snapshots_cross_load(tmp_path):
    chunks = j_text_like_stream(300, 500, chunks=3, mean_len=10, seed=2)
    js, ts = _sessions(500)
    _feed_both(js, ts, chunks)
    js.arena.save(tmp_path / "j.npz")
    a = StreamArena.load(tmp_path / "j.npz", device="cpu")
    assert (a.num_u, a.num_v, a.W_cap) == (ts.arena.num_u, ts.arena.num_v,
                                           ts.arena.W_cap)
    g1, g2 = a.graph(), ts.arena.graph()
    assert np.array_equal(g1.u_indptr, g2.u_indptr)
    assert np.array_equal(g1.u_indices, g2.u_indices)
    assert np.array_equal(a.masks_np(), ts.arena.masks_np())
    assert torch.equal(a.sizes, ts.arena.sizes)
    # a zero-edge snapshot restores with zero-length buffers and re-grows
    StreamArena(4, 100, device="cpu").save(tmp_path / "empty.npz")
    e = StreamArena.load(tmp_path / "empty.npz", device="cpu")
    g = tg.text_like(50, 100, mean_len=5, seed=0)
    assert e.append(g) == (0, 50)
    assert np.array_equal(e.graph().u_indices, g.u_indices)
    ja = JArena.load(tmp_path / "empty.npz")
    assert ja.append(j_text_like(50, 100, mean_len=5, seed=0)) == (0, 50)


# ----------------------------------------------------------- guard rails
def test_feed_failure_leaves_session_consistent():
    g = tg.text_like(200, 400, mean_len=8, seed=0)
    sess = StreamSession(ParsaStreamConfig(base=ParsaConfig(**BASE)),
                         num_v=400, device="cpu")
    sess.feed(g.slice_u(0, 100))
    bad = BipartiteGraph(5, 10, np.array([0, 1, 2, 3, 4, 5], np.int64),
                         np.array([1, 2, 3, 99, 4], np.int32))  # 99 >= 10
    before_u, before_parts = sess.arena.num_u, sess.parts.copy()
    before_masks, rng = sess.arena.masks_np(), sess._rng.bit_generator.state
    with pytest.raises(ValueError, match="exceeds"):
        sess.feed(bad)
    assert sess.arena.num_u == before_u
    assert np.array_equal(sess.parts, before_parts)
    assert np.array_equal(sess.arena.masks_np(), before_masks)
    assert sess._rng.bit_generator.state == rng
    sess.feed(g.slice_u(100, 200))
    assert sess.parts.shape == (200,)


@pytest.mark.parametrize("kw,match", [
    (dict(base=dict(k=4, backend="host")), "device backend"),
    (dict(repartition="sometimes"), "repartition must be"),
    (dict(repartition_frac=1.5), "repartition_frac"),
    (dict(drift_window=0), "window"),
    (dict(drift_threshold=0.5), "threshold"),
    (dict(drift_min_feeds=0), "min_feeds"),
])
def test_stream_config_validation_matches_jax(kw, match):
    kw = dict(kw)
    base = kw.pop("base", BASE)
    with pytest.raises(ValueError, match=match) as want:
        JStreamConfig(base=JConfig(**base), **kw)
    with pytest.raises(ValueError, match=match) as got:
        ParsaStreamConfig(base=ParsaConfig(**base), **kw)
    assert str(got.value) == str(want.value)


def test_stream_partition_convenience():
    chunks = j_text_like_stream(400, 600, chunks=3, mean_len=10, seed=4)
    jcfg = JStreamConfig(base=JConfig(**BASE, use_kernel=False),
                         repartition="never")
    from repro.stream import stream_partition as j_stream_partition

    want, wu = j_stream_partition(chunks, jcfg)
    got, gu = stream_partition([_port(c) for c in chunks],
                               ParsaStreamConfig(base=ParsaConfig(**BASE),
                                                 repartition="never"),
                               device="cpu")
    assert [u.chunk for u in gu] == [0, 1, 2]
    for a, b in zip(wu, gu):
        _same_update(a, b)
    assert np.array_equal(got.parts_u, want.parts_u)
    assert np.array_equal(got.s_masks, want.s_masks)
    with pytest.raises(ValueError, match="at least one chunk"):
        stream_partition([], ParsaStreamConfig(base=ParsaConfig(**BASE)),
                         device="cpu")


def test_stream_entry_points_need_the_card(monkeypatch, tmp_path):
    cfg = ParsaStreamConfig(base=ParsaConfig(**BASE))
    StreamSession(cfg, num_v=100, device="cpu").save(tmp_path / "s.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tg.text_like(50, 100, mean_len=5, seed=0)
    for call in (lambda: StreamSession(cfg, num_v=100),
                 lambda: StreamSession.load(tmp_path / "s.npz", cfg),
                 lambda: stream_partition([g], cfg)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


# ------------------------------------------------------ copied numpy parts
@pytest.mark.parametrize("name", ["text", "ctr", "social", "social_graph"])
def test_stream_generators_match_jax(name):
    cases = {
        "text": lambda m: m.text_like_stream(300, 700, chunks=4,
                                             mean_len=8, drift=0.5, seed=3),
        "ctr": lambda m: m.ctr_like_stream(300, 1200, chunks=4,
                                           nnz_per_row=10, churn=0.6,
                                           seed=3),
        "social": lambda m: m.social_like_stream(400, chunks=3, m=4,
                                                 seed=3),
        "social_graph": lambda m: [m.natural_to_bipartite(
            *m.social_like(300, m=4, seed=3))],
    }
    import repro.graphs as jg

    want, got = cases[name](jg), cases[name](tg)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert (g.num_u, g.num_v) == (w.num_u, w.num_v)
        assert np.array_equal(g.u_indptr, w.u_indptr)
        assert np.array_equal(g.u_indices, w.u_indices)
        assert g.u_indices.dtype == w.u_indices.dtype


def test_social_like_edges_match_jax():
    import repro.graphs as jg

    got, want = tg.social_like(300, m=4, seed=3), jg.social_like(300, m=4,
                                                                 seed=3)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_intersect_counts_and_plan_migration_match_jax(seed):
    """Random packed stacks with bit-31 words (negative int32)."""
    rng = np.random.default_rng(seed)
    k, W, n = [4, 7, 16, 3][seed], [1, 33, 64, 200][seed], 300
    a, b = _words(rng, (k, W)), _words(rng, (k, W))
    a[:, 0] |= np.int32(-2**31)
    b &= _words(rng, (k, W))
    assert np.array_equal(packed_intersect_counts(a, b),
                          jk.packed_intersect_counts(a, b))
    assert packed_intersect_counts(a, b).dtype == np.int64
    new_parts = rng.integers(0, k, n).astype(np.int32)
    old_parts = rng.integers(0, k, n - 20).astype(np.int32)
    deg = rng.integers(0, 9, n)
    for degrees in (None, deg):
        _same_plan(j_plan_migration(new_parts, a, old_parts, b, degrees),
                   plan_migration(new_parts, a, old_parts, b, degrees))
    with pytest.raises(ValueError, match="word width"):
        packed_intersect_counts(a, b[:, :-1])


def test_intersect_counts_popcount_table_fallback(monkeypatch):
    """numpy without ``bitwise_count`` takes the byte table."""
    rng = np.random.default_rng(9)
    a, b = _words(rng, (5, 17)), _words(rng, (6, 17))
    want = packed_intersect_counts(a, b)
    monkeypatch.delattr(np, "bitwise_count", raising=False)
    assert np.array_equal(packed_intersect_counts(a, b), want)


def test_drift_tracker_decisions_match_jax():
    """A scripted metric sequence through both trackers: the lazily
    seeded cold window, trips, resets and the full-window mean."""
    rng = np.random.default_rng(3)
    jt, tt = JDriftTracker(4, 1.1, 2), DriftTracker(4, 1.1, 2)
    trips = 0
    for step in range(40):
        fp = rng.integers(50, 100, 4) * (1 + (step % 7 == 6) * 3)
        m = PartitionMetrics(4, np.ones(4, np.int64), fp, fp, fp,
                             np.zeros(4, np.int64))
        want, got = jt.update(m), tt.update(m)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        trips += got.repartition
        if step == 20:
            jt.reset()
            tt.reset()
    assert trips > 0
    for kw in (dict(window=0), dict(threshold=0.9), dict(min_feeds=0)):
        with pytest.raises(ValueError):
            DriftTracker(**kw)


# -------------------------------- 4 workers, against JAX on 8 host devices
# name → (stream kind, stream kwargs, extra base kwargs, stream-config
# kwargs, worker_weights or None)
PAR_BASE = dict(k=8, backend="parallel_device", block_size=64, workers=4,
                merge_every=2, refine_v=False)
PAR_CASES = {
    "shuffle": ("text", dict(num_docs=1200, vocab=2000, chunks=3,
                             mean_len=15, seed=4), {}, {}, None),
    "weights": ("text", dict(num_docs=1200, vocab=2000, chunks=3,
                             mean_len=15, seed=4), {},
                dict(shuffle_blocks=False), [1.0, 2.0, 0.5, 3.0]),
    "weights_shuffle": ("text", dict(num_docs=1200, vocab=2000, chunks=3,
                                     mean_len=15, seed=4), {}, {},
                        [1.0, 2.0, 0.5, 3.0]),
    "drift": ("ctr", dict(num_impressions=1200, num_features=2000,
                          chunks=4, nnz_per_row=12, churn=0.7, seed=1), {},
              dict(drift_threshold=1.0, drift_min_feeds=1,
                   repartition_frac=0.02), None),
    "sketch": ("ctr", dict(num_impressions=900, num_features=3000,
                           chunks=3, nnz_per_row=10, seed=2),
               dict(set_repr="sketch", sketch_hot_bits=512,
                    sketch_bucket_bits=256), {}, None),
}

_JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.api import ParsaConfig, ParsaStreamConfig, StreamSession
from repro.graphs import ctr_like_stream, text_like_stream

base, cases, out_path = json.loads(sys.argv[1])
gen = {"text": text_like_stream, "ctr": ctr_like_stream}
out = {}
for name, (kind, gkw, bkw, skw, weights) in cases.items():
    chunks = gen[kind](**gkw)
    cfg = ParsaStreamConfig(base=ParsaConfig(**base, **bkw,
                                             use_kernel=False), **skw)
    sess = StreamSession(cfg, num_v=chunks[0].num_v)
    for i, c in enumerate(chunks):
        u = sess.feed(c, worker_weights=None if weights is None
                      else np.asarray(weights))
        p = f"{name}/{i}/"
        out[p + "parts"] = u.parts
        out[p + "masks"] = sess.arena.masks_np(logical=False)
        out[p + "sizes"] = np.asarray(sess.arena.sizes)
        out[p + "footprint"] = u.metrics.footprint
        out[p + "traffic"] = np.asarray(dataclasses.astuple(u.traffic))
        out[p + "dispatches"] = json.dumps(u.dispatches, sort_keys=True)
        out[p + "repartitioned"] = u.repartitioned
        if u.migration is not None:
            out[p + "assign"] = u.migration.assign
            out[p + "mig"] = np.asarray(dataclasses.astuple(
                u.migration.traffic))
    r = sess.result(refine_v=True)
    out[name + "/parts_v"] = r.parts_v
    out[name + "/m_traffic"] = r.metrics.traffic
    out[name + "/session_traffic"] = np.asarray(
        dataclasses.astuple(sess.traffic))
np.savez(out_path, **out)
print("JAX_STREAM_DONE")
"""


@pytest.fixture(scope="module")
def jax_parallel_streams(tmp_path_factory):
    """JAX ``parallel_device`` streams on 8 forced host devices, computed
    once in a subprocess (the device count is fixed when JAX starts)."""
    path = tmp_path_factory.mktemp("jax_streams") / "out.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([PAR_BASE, PAR_CASES, str(path)])
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, arg], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "JAX_STREAM_DONE" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path, allow_pickle=True))


@pytest.mark.parametrize("name", list(PAR_CASES))
def test_parallel_feeds_match_jax(jax_parallel_streams, name):
    kind, gkw, bkw, skw, weights = PAR_CASES[name]
    chunks = (tg.text_like_stream if kind == "text"
              else tg.ctr_like_stream)(**gkw)
    sess = StreamSession(ParsaStreamConfig(
        base=ParsaConfig(**PAR_BASE, **bkw), **skw),
        num_v=chunks[0].num_v, device="cpu")
    want = jax_parallel_streams
    for i, c in enumerate(chunks):
        u = sess.feed(c, worker_weights=None if weights is None
                      else np.asarray(weights))
        p = f"{name}/{i}/"
        assert np.array_equal(u.parts, want[p + "parts"]), p
        assert np.array_equal(sess.arena.masks_np(logical=False),
                              want[p + "masks"]), p
        assert np.array_equal(sess.arena.sizes.numpy(), want[p + "sizes"])
        assert np.array_equal(u.metrics.footprint, want[p + "footprint"])
        assert list(_traffic(u.traffic)) == list(want[p + "traffic"])
        assert json.dumps(u.dispatches, sort_keys=True) == \
            str(want[p + "dispatches"])
        assert u.repartitioned == bool(want[p + "repartitioned"])
        if u.migration is not None:
            assert np.array_equal(u.migration.assign, want[p + "assign"])
            assert list(_traffic(u.migration.traffic)) == \
                list(want[p + "mig"])
    if name == "drift":
        assert sess.repartitions > 0
    r = sess.result(refine_v=True)
    assert np.array_equal(r.parts_v, want[name + "/parts_v"])
    assert np.array_equal(r.metrics.traffic, want[name + "/m_traffic"])
    assert list(_traffic(sess.traffic)) == \
        list(want[name + "/session_traffic"])


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stream_equals_cpu_stream(cuda_device):
    chunks = tg.social_like_stream(600, chunks=4, m=5, seed=2)
    cfg = ParsaStreamConfig(base=ParsaConfig(**BASE), repartition="never")
    cpu = StreamSession(cfg, num_v=chunks[0].num_v, device="cpu")
    gpu = StreamSession(cfg, num_v=chunks[0].num_v, device=cuda_device)
    for c in chunks:
        a, b = cpu.feed(c), gpu.feed(c)
        assert np.array_equal(a.parts, b.parts)
        assert np.array_equal(cpu.arena.masks_np(), gpu.arena.masks_np())
    assert np.array_equal(cpu.result(refine_v=True).parts_v,
                          gpu.result(refine_v=True).parts_v)
