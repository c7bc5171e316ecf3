"""The port's Algorithm 2 and packed-word metrics against the JAX package:
``need_masks``, ``refine_v_device`` and ``evaluate_device``, bit for bit, on
the CPU path (the refine-sweep kernel's plain version)."""
import numpy as np
import pytest
import torch

from repro.core.bipartite import from_edges as j_from_edges
from repro.core.jax_refine import evaluate_device as j_evaluate_device
from repro.core.jax_refine import need_masks as j_need_masks
from repro.core.jax_refine import refine_v_device as j_refine_v_device
from repro.core.partition_u import partition_u_impl
from repro.graphs import text_like as j_text_like
from repro_torch.convert import graph_from_numpy
from repro_torch.core import refine as tr
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.core.partition_v import partition_v

METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _random_graph(rng, nu, nv, ne, isolate_frac=0.0):
    """As in test_refine.py: a tail of V that no edge touches, so the
    isolated-parameter −1 convention is hit."""
    hi = max(1, int(nv * (1 - isolate_frac)))
    return j_from_edges(nu, nv, rng.integers(0, nu, size=ne),
                        rng.integers(0, hi, size=ne))


def _assert_metrics_equal(got, want):
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.as_dict() == want.as_dict()


# ------------------------------------------------------------ need_masks
@pytest.mark.parametrize("k", [4, 16, 64])
def test_need_masks_matches_jax(k):
    rng = np.random.default_rng(k)
    g = _random_graph(rng, 300, 700, 4000, isolate_frac=0.1)
    parts_u = rng.integers(0, k, size=g.num_u).astype(np.int32)
    want = np.asarray(j_need_masks(g, parts_u, k))
    got = tr.need_masks(_port(g), parts_u, k, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_need_masks_empty_graph():
    g = _port(j_from_edges(5, 70, np.zeros(0, np.int64), np.zeros(0, np.int64)))
    got = tr.need_masks(g, np.zeros(5, np.int32), 4, device="cpu")
    assert got.shape == (4, 3) and not got.any()


def test_need_masks_sets_bit31():
    """Parameter 31 of a word is the int32 sign bit: set by scatter-add."""
    g = j_from_edges(4, 64, np.array([0, 1, 2, 3]), np.array([31, 63, 31, 0]))
    parts_u = np.array([0, 1, 1, 0], np.int32)
    want = np.asarray(j_need_masks(g, parts_u, 2))
    got = tr.need_masks(_port(g), parts_u, 2, device="cpu").numpy()
    assert np.array_equal(got, want) and (got < 0).any()


# ------------------------------------------------- partition_v parity
@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("k", [4, 16])
def test_refine_v_device_matches_jax(k, sweeps):
    rng = np.random.default_rng(17 * k + sweeps)
    g = _random_graph(rng, 400, 777, 6000, isolate_frac=0.15)
    parts_u = partition_u_impl(g, k, seed=1).parts_u
    want, _ = j_refine_v_device(g, parts_u, k, sweeps=sweeps, chunk=128)
    want = np.asarray(want)
    got, need = tr.refine_v_device(_port(g), parts_u, k, sweeps=sweeps,
                                   chunk=128, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), partition_v(_port(g), parts_u, k,
                                                   sweeps=sweeps))
    assert np.array_equal(need.numpy(), np.asarray(j_need_masks(g, parts_u, k)))
    assert (want == -1).any()  # the isolated tail is exercised


def test_refine_v_device_k64_chunk_sizes():
    rng = np.random.default_rng(5)
    g = _random_graph(rng, 500, 1500, 9000, isolate_frac=0.05)
    parts_u = rng.integers(0, 64, size=g.num_u).astype(np.int32)
    want = partition_v(_port(g), parts_u, 64, sweeps=2)
    for chunk in (32, 2048):
        got, _ = tr.refine_v_device(_port(g), parts_u, 64, sweeps=2,
                                    chunk=chunk, device="cpu")
        assert np.array_equal(got.numpy(), want), chunk


def test_refine_v_device_matches_jax_kernel_path_interpret():
    """The JAX refine-sweep Pallas kernel (interpret mode) gives the same."""
    rng = np.random.default_rng(3)
    g = _random_graph(rng, 250, 400, 3000, isolate_frac=0.1)
    parts_u = partition_u_impl(g, 8).parts_u
    want, _ = j_refine_v_device(g, parts_u, 8, sweeps=2, chunk=64,
                                use_kernel=True, interpret=True)
    got, _ = tr.refine_v_device(_port(g), parts_u, 8, sweeps=2, chunk=64,
                                device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_refine_v_device_reuses_need_words_and_counts_phases():
    g = j_text_like(200, 400, mean_len=10, seed=1)
    parts_u = partition_u_impl(g, 4).parts_u
    gt = _port(g)
    need = tr.need_masks(gt, parts_u, 4, device="cpu")
    with dispatch_counter() as counts:
        got, need_out = tr.refine_v_device(gt, parts_u, 4, sweeps=2, chunk=64,
                                           need_words=need, device="cpu")
    assert need_out is need
    assert counts == {"partition_scan": 0, "refine_scan": 1}
    assert counts.launches == {"refine_scan": {}}  # plain version: no launch
    assert np.array_equal(got.numpy(), partition_v(gt, parts_u, 4, sweeps=2))


def test_refine_v_device_rejects_bad_chunk():
    g = _port(j_text_like(50, 100, mean_len=5, seed=0))
    with pytest.raises(ValueError, match="multiple of 32"):
        tr.refine_v_device(g, np.zeros(50, np.int32), 4, chunk=48,
                           device="cpu")


# --------------------------------------------------------- metrics parity
@pytest.mark.parametrize("k", [4, 16, 64])
def test_evaluate_device_matches_jax(k):
    rng = np.random.default_rng(k + 1)
    g = _random_graph(rng, 350, 900, 5000, isolate_frac=0.1)
    parts_u = rng.integers(0, k, size=g.num_u).astype(np.int32)
    parts_v = partition_v(_port(g), parts_u, k, sweeps=2)
    want = j_evaluate_device(g, parts_u, parts_v, k)
    got = tr.evaluate_device(_port(g), parts_u, parts_v, k, device="cpu")
    _assert_metrics_equal(got, want)


def test_evaluate_device_rowwise_branch_matches_jax(monkeypatch):
    """Above _M_BCAST_MAX_WORDS the intersection matrix is built one server
    row at a time; the limit is patched to 0 to take that branch."""
    monkeypatch.setattr(tr, "_M_BCAST_MAX_WORDS", 0)
    rng = np.random.default_rng(11)
    g = _random_graph(rng, 333, 901, 5000, isolate_frac=0.1)
    parts_u = rng.integers(0, 16, size=g.num_u).astype(np.int32)
    parts_v = partition_v(_port(g), parts_u, 16, sweeps=2)
    want = j_evaluate_device(g, parts_u, parts_v, 16)
    got = tr.evaluate_device(_port(g), parts_u, parts_v, 16, device="cpu")
    _assert_metrics_equal(got, want)


def test_evaluate_device_parts_v_none_matches_jax():
    g = j_text_like(300, 600, mean_len=15, seed=2)
    parts_u = partition_u_impl(g, 8).parts_u
    want = j_evaluate_device(g, parts_u, None, 8)
    got = tr.evaluate_device(_port(g), parts_u, None, 8, device="cpu")
    _assert_metrics_equal(got, want)
