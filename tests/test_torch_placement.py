"""The port's placement layer against the JAX package, on the inputs of
``tests/test_placement.py``: the embedding ``Placement`` (Parsa and
random), its gather traffic, the MoE expert placement and its all-to-all
traffic, ``ParsaShardedData``'s batches, and ``partition(placement=True)``
with its two refusals.  Every array and dict is compared exactly
(tolerance 0: the program is integer; the traffic dicts' fractions are
computed from the same integers)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core.moe_placement import alltoall_traffic as j_alltoall_traffic
from repro.core.moe_placement import \
    build_expert_placement as j_build_expert_placement
from repro.core.placement import build_placement as j_build_placement
from repro.core.placement import gather_traffic as j_gather_traffic
from repro.data import ParsaShardedData as JShardedData
from repro.graphs import text_like as j_text_like
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import graph_from_numpy
from repro_torch.core.moe_placement import (
    alltoall_traffic,
    build_expert_placement,
)
from repro_torch.core.placement import (
    build_placement,
    gather_traffic,
    placement_from_parts,
)
from repro_torch.data import ParsaShardedData

K = 8
PLACEMENT_FIELDS = ("doc_to_shard", "vocab_to_shard", "vocab_perm",
                    "vocab_unperm", "shard_row_counts")


@pytest.fixture(scope="module")
def doc_graph():
    return j_text_like(320, 800, mean_len=25, seed=13)


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _same_placement(got, want):
    assert got.k == want.k
    for f in PLACEMENT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert np.array_equal(a, b) and a.dtype == b.dtype, f


@pytest.fixture(scope="module")
def placements(doc_graph):
    """(port, JAX) placements by method, built once."""
    g = _port(doc_graph)
    return {m: (build_placement(g, K, b=4, a=2, method=m, device="cpu"),
                j_build_placement(doc_graph, K, b=4, a=2, method=m))
            for m in ("parsa", "random")}


@pytest.mark.parametrize("method", ["parsa", "random"])
def test_build_placement_matches_jax(placements, method):
    got, want = placements[method]
    _same_placement(got, want)
    ids = np.arange(50) * 13 % 800
    assert np.array_equal(got.permute_ids(ids), want.permute_ids(ids))


@pytest.mark.parametrize("method", ["parsa", "random"])
def test_gather_traffic_matches_jax(doc_graph, placements, method):
    got, want = placements[method]
    assert gather_traffic(_port(doc_graph), got) == \
        j_gather_traffic(doc_graph, want)


def test_parsa_placement_beats_random(doc_graph, placements):
    g = _port(doc_graph)
    parsa = gather_traffic(g, placements["parsa"][0])
    rand = gather_traffic(g, placements["random"][0])
    assert parsa["local_fraction"] > rand["local_fraction"]
    assert parsa["remote_rows_sum"] < rand["remote_rows_sum"]


def test_placement_fills_unused_vocab_like_jax():
    """Parameters no document touches (parts_v = -1) go round-robin over
    the least-loaded shards."""
    from repro.core.placement import placement_from_parts as j_from_parts

    rng = np.random.default_rng(5)
    parts_u = rng.integers(0, 4, 60).astype(np.int32)
    parts_v = rng.integers(-1, 4, 90).astype(np.int32)
    _same_placement(placement_from_parts(parts_u, parts_v, 90, 4),
                    j_from_parts(parts_u, parts_v, 90, 4))


def _routing_counts():
    rng = np.random.default_rng(0)
    groups, experts = 64, 32
    counts = np.zeros((groups, experts), int)
    for gidx in range(groups):
        favorites = (gidx * 3 + np.arange(6)) % experts
        counts[gidx, favorites] = rng.integers(5, 50, size=6)
    return counts


def test_expert_placement_matches_jax():
    counts = _routing_counts()
    got = build_expert_placement(counts, K, device="cpu")
    want = j_build_expert_placement(counts, K)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(a, b), f.name
    t = alltoall_traffic(counts, got)
    assert t == j_alltoall_traffic(counts, want)
    assert t["crossing_tokens_parsa"] < t["crossing_tokens_roundrobin"]


def test_parsa_sharded_data_matches_jax(doc_graph, placements):
    g = _port(doc_graph)
    for method in ("parsa", "random"):
        got, want = placements[method]
        dp = ParsaShardedData(g, got, batch=160, seq=8, seed=1)
        dj = JShardedData(doc_graph, want, batch=160, seq=8, seed=1)
        for step in range(3):
            for permute in (True, False):
                a = dp.batch_at(step, permute_vocab=permute)
                b = dj.batch_at(step, permute_vocab=permute)
                assert a.keys() == b.keys()
                for key in a:
                    assert np.array_equal(a[key], b[key])
                    assert a[key].dtype == b[key].dtype
            assert np.array_equal(dp.working_set_per_shard(step),
                                  dj.working_set_per_shard(step))
    ws_p = sum(ParsaShardedData(g, placements["parsa"][0], batch=160, seq=8,
                                seed=1).working_set_per_shard(s).sum()
               for s in range(3))
    ws_r = sum(ParsaShardedData(g, placements["random"][0], batch=160,
                                seq=8, seed=1).working_set_per_shard(s).sum()
               for s in range(3))
    assert ws_p < ws_r


@pytest.mark.parametrize("backend", ["device_scan", "host"])
def test_partition_with_placement_matches_jax(doc_graph, backend):
    kw = dict(k=K, backend=backend, refine_backend="device", block_size=64,
              placement=True)
    got = partition(_port(doc_graph), ParsaConfig(**kw), device="cpu")
    want = j_partition(doc_graph, JConfig(**kw))
    _same_placement(got.placement, want.placement)
    assert np.array_equal(got.parts_u, want.parts_u)
    assert np.array_equal(got.parts_v, want.parts_v)
    assert set(got.timings) == set(want.timings)
    assert "placement" in got.timings
    # the exact collapse of a sketch keeps identities, so it places
    col = partition(_port(doc_graph), ParsaConfig(
        **kw, set_repr="sketch", sketch_hot_bits=1024), device="cpu")
    _same_placement(col.placement, got.placement)
    off = partition(_port(doc_graph), ParsaConfig(**dict(kw,
                                                         placement=False)),
                    device="cpu")
    assert off.placement is None and "placement" not in off.timings


def test_placement_refusals_match_jax(doc_graph):
    with pytest.raises(ValueError, match="requires refine_v") as want:
        JConfig(k=K, placement=True, refine_v=False)
    with pytest.raises(ValueError, match="requires refine_v") as got:
        ParsaConfig(k=K, placement=True, refine_v=False)
    assert str(got.value) == str(want.value)
    kw = dict(k=K, backend="device_scan", refine_backend="device",
              block_size=64, placement=True, set_repr="sketch",
              sketch_hot_bits=256, sketch_bucket_bits=128)
    with pytest.raises(ValueError, match="exact parameter identities") as w:
        j_partition(doc_graph, JConfig(**kw))
    with pytest.raises(ValueError, match="exact parameter identities") as g:
        partition(_port(doc_graph), ParsaConfig(**kw), device="cpu")
    assert str(g.value) == str(w.value)


def test_placement_entry_points_need_the_card(doc_graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port(doc_graph)
    for call in (lambda: build_placement(g, K),
                 lambda: build_placement(g, K, method="random"),
                 lambda: build_expert_placement(_routing_counts(), K),
                 lambda: partition(g, ParsaConfig(k=K, placement=True))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
