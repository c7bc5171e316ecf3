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


# ------------------------------------------------- dispatch bytes, resets
def test_bytes_by_phase_matches_jax():
    """``DispatchLog.bytes_by_phase`` of the facade's device_scan with the
    device refine, phase by phase, against JAX's on the same graph."""
    from repro.core.jax_partition import dispatch_counter as j_counter
    from repro_torch.api import ParsaConfig, partition

    g = j_text_like(700, 900, mean_len=14, seed=5)
    kw = dict(k=8, backend="device_scan", refine_backend="device",
              block_size=128)
    with j_counter() as want:
        j_partition(g, JConfig(**kw))
    with dispatch_counter() as got:
        partition(_port(g), ParsaConfig(**kw), device="cpu")
    assert dict(got) == dict(want)
    assert got.bytes_by_phase() == want.bytes_by_phase()
    assert got.bytes_by_phase()["partition_scan"] == 4 * (8 * 29 + 8)


def test_reset_dispatch_counts_zeroes_every_log():
    from repro_torch.core.dispatch import reset_dispatch_counts

    g = _port(j_text_like(300, 300, mean_len=10, seed=0))
    with dispatch_counter() as outer:
        with dispatch_counter() as inner:
            blocked_partition_u_impl(g, 4, 64, device="cpu")
            reset_dispatch_counts()
            assert inner == outer == {"partition_scan": 0}
            assert not inner.records and not outer.records
            assert inner.launches == outer.launches == {}
            assert inner.bytes_by_phase() == {}
            blocked_partition_u_impl(g, 4, 64, device="cpu")
    assert inner == outer == {"partition_scan": 1}
    assert len(outer.records) == 1
    reset_dispatch_counts()   # no log active: nothing to do
    assert outer == {"partition_scan": 1}


# ------------------------------------------------------------ the packers
@pytest.mark.parametrize("seed", range(6))
def test_packers_match_jax(seed):
    """``pack_bitmask_csr``, ``pack_bitmask_csr_compact`` and
    ``compact_row_words`` on the inputs of JAX's own packing tests
    (``tests/test_jax_partition.py``): bit-equal arrays."""
    from repro.kernels.parsa_cost import ops as jops
    from repro_torch.kernels import parsa_cost as tk

    g = _random_graph(seed)
    rng = np.random.default_rng(seed + 100)
    args = (g.u_indptr, g.u_indices, g.num_v)
    perm = rng.permutation(g.num_u)
    for rows in (None, perm):
        got = tk.pack_bitmask_csr(*args, rows=rows)
        assert got.dtype == np.int32
        assert np.array_equal(got, jops.pack_bitmask_csr(*args, rows=rows))
    cap = int(rng.integers(2, 12))
    got = tk.pack_bitmask_csr_compact(*args, rows=perm, cap=cap)
    want = jops.pack_bitmask_csr_compact(*args, rows=perm, cap=cap)
    masks = jops.pack_bitmask_csr(*args, rows=perm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tk.compact_row_words(masks, cap),
                    jops.compact_row_words(masks, cap)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    g2 = j_text_like(200, 600, mean_len=25, seed=2)
    m2 = jops.pack_bitmask_csr(g2.u_indptr, g2.u_indices, g2.num_v)
    for a, b in zip(tk.compact_row_words(m2, 8), jops.compact_row_words(m2, 8)):
        assert np.array_equal(a, b)


# ------------------------------------------------------- shard_parsa_step
def _jax_shard_step(packed, k, W, select):
    """JAX's body through ``shard_map`` on a 1-wide data axis (one host
    device), as ``tests/test_jax_partition.py`` runs it."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.jax_partition import shard_parsa_step as j_step

    body = j_step(k, axis="data", use_kernel=False, select=select)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = shard_map(body, mesh=mesh, in_specs=(P(),) * 8,
                   out_specs=(P(), P(), P()), check_vma=False)
    out = fn(*(jnp.asarray(getattr(packed, f)) for f in
               ("valid", "widx", "vals", "trunc", "tr_ids", "tr_masks")),
             jnp.zeros((k, W), jnp.int32), jnp.zeros((k,), jnp.int32))
    return [np.asarray(a) for a in out]


def _port_shard_step(packed, k, W, select, workers=1):
    from repro_torch.core.partition import shard_parsa_step

    def stack(a):
        return torch.from_numpy(np.ascontiguousarray(a))[None]

    body = shard_parsa_step(k, select=select)
    args = [stack(getattr(packed, f)) for f in
            ("valid", "widx", "vals", "trunc", "tr_ids", "tr_masks")]
    s0 = torch.zeros((k, W), dtype=torch.int32)
    z0 = torch.zeros(k, dtype=torch.int32)
    parts, merged, sizes = body(*args, s0, z0)
    assert not s0.any() and not z0.any()   # the arguments are left alone
    return parts[0].numpy(), merged.numpy(), sizes.numpy()


@pytest.mark.parametrize("select", ["rounds", "seq"])
@pytest.mark.parametrize("case", ["full", "padded"])
def test_shard_parsa_step_matches_jax(case, select):
    """One worker, bit for bit against JAX's body on the graphs of JAX's
    own tests (``tests/test_jax_partition.py``): 256 rows in blocks of 64,
    and 150 rows (the last block padded: padding never enters S or the
    sizes).  ``parts``, ``merged`` and ``sizes``."""
    g = (j_text_like(256, 400, mean_len=12, seed=8) if case == "full"
         else j_text_like(150, 300, mean_len=10, seed=3))
    k, W = 4, (g.num_v + 31) // 32
    packed = j_pack(g, 64)
    want = _jax_shard_step(packed, k, W, select)
    got = _port_shard_step(pack_graph_blocks(_port(g), 64), k, W, select)
    for name, a, b in zip(("parts", "merged", "sizes"), got, want):
        assert np.array_equal(a, b), name
    parts = got[0].reshape(-1)
    assert (parts[: g.num_u] >= 0).all() and (parts[g.num_u:] == -1).all()
    assert np.array_equal(got[2], np.bincount(parts[: g.num_u], minlength=k))


def test_shard_parsa_step_refuses_a_bad_select():
    from repro_torch.core.partition import shard_parsa_step

    with pytest.raises(ValueError, match="select"):
        shard_parsa_step(4, select="greedy")
