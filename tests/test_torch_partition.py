"""The port's blocked partitioner against the JAX package: packing, block
rebuild, and ``parts_u`` / ``s_masks`` of ``device_scan`` and
``host_blocked_oracle``, bit for bit, on the CPU path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core.bipartite import from_edges as j_from_edges
from repro.core.jax_partition import _rebuild_nbr as j_rebuild_nbr
from repro.core.jax_partition import pack_graph_blocks as j_pack
from repro.graphs import text_like as j_text_like
from repro_torch.convert import graph_from_numpy
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.core.partition import (
    blocked_partition_u_hostloop_impl,
    blocked_partition_u_impl,
    pack_graph_blocks,
)
from repro_torch.kernels.parsa_cost import rebuild_block


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _random_graph(seed):
    rng = np.random.default_rng(seed)
    nu, nv = int(rng.integers(50, 900)), int(rng.integers(30, 400))
    ne = int(rng.integers(1, 6000))
    return j_from_edges(nu, nv, rng.integers(0, nu, ne), rng.integers(0, nv, ne))


def _jax_sets(g, k, block, seed=0, backend="device_scan", init_sets=None,
              **kw):
    r = j_partition(g, JConfig(k=k, backend=backend, block_size=block,
                               seed=seed, refine_v=False, **kw),
                    init_sets=init_sets)
    return r.parts_u, r.s_masks


def _both(g, k, block, seed=0, init_sets=None, cap=48):
    """(port device_scan, port host_blocked_oracle) on the CPU path."""
    gt = _port(g)
    scan = blocked_partition_u_impl(gt, k, block, init_sets=init_sets,
                                    seed=seed, cap=cap, device="cpu")
    loop = blocked_partition_u_hostloop_impl(gt, k, block, init_sets=init_sets,
                                             seed=seed, device="cpu")
    return [(p.numpy(), s.numpy()) for p, s in (scan, loop)]


@pytest.mark.parametrize("seed,k,block", [
    (0, 4, 128), (1, 16, 128), (2, 8, 256), (3, 16, 64), (4, 3, 104),
])
def test_scan_and_hostloop_match_jax(seed, k, block):
    g = _random_graph(seed)
    want_p, want_s = _jax_sets(g, k, block, seed=seed)
    for p, s in _both(g, k, block, seed=seed):
        assert np.array_equal(p, want_p)
        assert np.array_equal(s, want_s)


def test_scan_matches_jax_kernel_path_interpret():
    """The JAX fused-select Pallas kernel (interpret mode) gives the same."""
    g = j_text_like(150, 300, mean_len=10, seed=0)
    want_p, want_s = _jax_sets(g, 4, 64, use_kernel=True, interpret=True)
    (p, s), _ = _both(g, 4, 64)
    assert np.array_equal(p, want_p) and np.array_equal(s, want_s)


def test_truncated_rows_match_jax():
    """cap small enough that many rows ride the dense side channel."""
    g = j_text_like(400, 600, mean_len=25, seed=5)
    want_p, want_s = _jax_sets(g, 4, 128, cap=3)
    (p, s), (p2, s2) = _both(g, 4, 128, cap=3)
    assert np.array_equal(p, want_p) and np.array_equal(s, want_s)
    assert np.array_equal(p2, want_p) and np.array_equal(s2, want_s)


@pytest.mark.parametrize("packed", [False, True])
def test_init_sets_match_jax(packed):
    g = j_text_like(300, 500, mean_len=15, seed=6)
    S0 = np.random.default_rng(1).random((8, g.num_v)) < 0.1
    if packed:
        from repro.kernels.parsa_cost import pack_bitmask

        S0 = pack_bitmask(S0, g.num_v)
    before = S0.copy()
    want_p, want_s = _jax_sets(g, 8, 128, seed=2, init_sets=S0)
    for p, s in _both(g, 8, 128, seed=2, init_sets=S0):
        assert np.array_equal(p, want_p) and np.array_equal(s, want_s)
    assert np.array_equal(S0, before)  # the caller's sets are never mutated


@pytest.mark.parametrize("k", [5, 8])
def test_k_not_dividing_u_balanced_and_matches_jax(k):
    g = j_text_like(777, 700, mean_len=18, seed=3)
    assert g.num_u % k
    want_p, _ = _jax_sets(g, k, 128)
    (p, _), _ = _both(g, k, 128)
    assert np.array_equal(p, want_p)
    sizes = np.bincount(p, minlength=k)
    assert (p >= 0).all() and sizes.max() - sizes.min() <= 1


def test_pack_graph_blocks_and_rebuild_match_jax():
    g = j_text_like(700, 900, mean_len=30, seed=4)
    order = np.random.default_rng(0).permutation(g.num_u)
    want = j_pack(g, 256, order=order, cap=4)   # tiny cap → truncated rows
    got = pack_graph_blocks(_port(g), 256, order=order, cap=4)
    for name in want._fields:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert want.trunc.any()
    for b in range(want.valid.shape[0]):
        nbr_j = np.asarray(j_rebuild_nbr(*(jnp.asarray(x[b]) for x in (
            want.widx, want.vals, want.tr_ids, want.tr_masks))))
        nbr_t = rebuild_block(*(torch.from_numpy(x[b]) for x in (
            got.widx, got.vals, got.tr_ids, got.tr_masks)))
        assert np.array_equal(nbr_t[:256].numpy(), nbr_j)
        assert not nbr_t[256].any()   # the sink row stays zero


def test_empty_graph():
    g = _port(j_from_edges(0, 70, np.zeros(0, np.int64), np.zeros(0, np.int64)))
    p, s = blocked_partition_u_impl(g, 4, 64, device="cpu")
    assert p.shape == (0,) and s.shape == (4, 3) and not s.any()


def test_dispatch_counter_one_scan_per_call():
    g = _port(j_text_like(300, 300, mean_len=10, seed=0))  # 5 blocks @ 64
    with dispatch_counter() as outer:
        blocked_partition_u_impl(g, 4, 64, device="cpu")
        with dispatch_counter() as inner:
            blocked_partition_u_impl(g, 4, 64, device="cpu")
    assert inner == {"partition_scan": 1}
    assert outer == {"partition_scan": 2}
    assert outer.records[0].meta == {"k": 4, "blocks": 5}
    # the CPU path launches no kernel; the phase is still recorded
    assert outer.launches == {"partition_scan": {}}
