"""The port's kernel layer against the JAX package: the plain PyTorch
versions (the CPU path of every wrapper) are bit-identical to the JAX
oracles, the wrappers check their inputs, and — on a card only — each CUDA
kernel equals its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import parsa_cost as jk
from repro_torch.kernels import parsa_cost as tk
from repro_torch.kernels.parsa_cost import ops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _full_range_words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def test_popcount32_counts_bit31():
    rng = np.random.default_rng(0)
    w = _full_range_words(rng, (257,))
    w[:3] = [-1, -(2**31), 2**31 - 1]
    want = np.array([bin(int(x)).count("1") for x in w.view(np.uint32)])
    assert np.array_equal(tk.popcount32(_t(w)).numpy(), want)


# ------------------------------------------------------------- parsa_cost
@pytest.mark.parametrize("num_v", [33, 256, 1000])
@pytest.mark.parametrize("U,K", [(7, 3), (64, 16), (130, 8)])
def test_parsa_cost_ref_matches_jax(num_v, U, K):
    rng = np.random.default_rng(U * K + num_v)
    nbr = jk.pack_bitmask([rng.choice(num_v, size=rng.integers(0, min(50, num_v)),
                                      replace=False) for _ in range(U)], num_v)
    s = jk.pack_bitmask(rng.random((K, num_v)) < 0.3, num_v)
    want = np.asarray(jk.parsa_cost_ref(jnp.asarray(nbr), jnp.asarray(s)))
    assert np.array_equal(tk.parsa_cost_ref(_t(nbr), _t(s)).numpy(), want)
    assert np.array_equal(ops.parsa_cost(_t(nbr), _t(s)).numpy(), want)


def test_parsa_cost_full_range_words_match_jax():
    """Words with bit 31 set are negative int32: counted, never compared."""
    rng = np.random.default_rng(3)
    nbr, s = _full_range_words(rng, (33, 9)), _full_range_words(rng, (5, 9))
    want = np.asarray(jk.parsa_cost_ref(jnp.asarray(nbr), jnp.asarray(s)))
    assert np.array_equal(ops.parsa_cost(_t(nbr), _t(s)).numpy(), want)


def test_parsa_cost_empty_sets():
    nbr = _t(tk.pack_bitmask([np.arange(10)], 64))
    s = _t(tk.pack_bitmask(np.zeros((2, 64), bool), 64))
    assert (ops.parsa_cost(nbr, s) == 10).all()



@pytest.mark.parametrize("W", [1, 2, 33, 47])
def test_parsa_cost_down_date_matches_jax(W):
    """The host_blocked_oracle's K=1 down-date, ``parsa_cost(nbr, ~(mask_u
    & ~s_i))``: an almost all-ones complement mask, at W not a multiple of
    4, equals the JAX ``parsa_cost_ref`` and |N(v) ∩ (N(u) \\ S_i)|."""
    rng = np.random.default_rng(W)
    num_v = 32 * W
    nbr = jk.pack_bitmask([rng.choice(num_v, size=rng.integers(0, min(40, num_v)),
                                      replace=False) for _ in range(37)], num_v)
    nbr[3] = -1                        # a dense row, every bit set
    s_i = jk.pack_bitmask(rng.random((1, num_v)) < 0.3, num_v)
    comp = ~(nbr[5:6] & ~s_i)
    assert (comp != 0).mean() > 0.5
    want = np.asarray(jk.parsa_cost_ref(jnp.asarray(nbr), jnp.asarray(comp)))
    got = ops.parsa_cost(_t(nbr), _t(comp))
    assert got.shape == (37, 1)
    assert np.array_equal(got.numpy(), want)
    direct = tk.popcount32(_t(nbr & nbr[5] & ~s_i)).sum(1)
    assert torch.equal(got[:, 0], direct)


@pytest.mark.parametrize("K", [1, 17, 64])
def test_parsa_cost_zero_and_dense_rows_match_jax(K):
    """All-zero rows, all-ones rows and full-range words beside sparse rows,
    at K on either side of a warp's 32 lanes and W = 47."""
    rng = np.random.default_rng(K)
    W = 47
    nbr = _full_range_words(rng, (11, W))
    nbr[0] = 0
    nbr[1] = -1
    nbr[2] = jk.pack_bitmask([rng.choice(32 * W, size=5, replace=False)],
                             32 * W)[0]
    s = _full_range_words(rng, (K, W)) & _full_range_words(rng, (K, W))
    want = np.asarray(jk.parsa_cost_ref(jnp.asarray(nbr), jnp.asarray(s)))
    got = ops.parsa_cost(_t(nbr), _t(s))
    assert np.array_equal(got.numpy(), want)
    assert (got[0] == 0).all()
    tile = ops.parsa_select_tile(_t(nbr), _t(s))
    assert np.array_equal(tile.numpy(), want.T)


def test_parsa_cost_past_select_max_k_matches_jax():
    """parsa_cost takes any K, past the select's ``SELECT_MAX_K``; the
    select tile does not."""
    rng = np.random.default_rng(11)
    K = ops.SELECT_MAX_K + 77
    nbr = _full_range_words(rng, (9, 5))
    nbr[0] = 0
    s = _full_range_words(rng, (K, 5)) & _full_range_words(rng, (K, 5))
    want = np.asarray(jk.parsa_cost_ref(jnp.asarray(nbr), jnp.asarray(s)))
    got = ops.parsa_cost(_t(nbr), _t(s))
    assert got.shape == (9, K)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="k <="):
        ops.parsa_select_tile(_t(nbr), _t(s))


# ------------------------------------------------- fused cost + select
@pytest.mark.parametrize("B", [256, 1024])
@pytest.mark.parametrize("k", [8, 32, 64])
def test_select_matches_jax(B, k):
    rng = np.random.default_rng(B * k)
    num_v = int(rng.integers(100, 3000))
    nbr = jk.pack_bitmask([rng.choice(num_v, size=rng.integers(0, min(60, num_v)),
                                      replace=False) for _ in range(B)], num_v)
    s = jk.pack_bitmask(rng.random((k, num_v)) < 0.25, num_v)
    retired = rng.random(B) < 0.3
    order = rng.permutation(k).astype(np.int32)
    enabled = rng.random(k) < 0.8
    jn, js, jr = jnp.asarray(nbr), jnp.asarray(s), jnp.asarray(retired)
    m2, a2 = jk.parsa_select_ref(jn, js, jr)
    m1, a1 = ops.parsa_cost_select(_t(nbr), _t(s), _t(retired))
    assert np.array_equal(m1.numpy(), np.asarray(m2))
    assert np.array_equal(a1.numpy(), np.asarray(a2))
    u2, c2 = jk.parsa_select_greedy_ref(jn, js, jr, jnp.asarray(order),
                                        jnp.asarray(enabled))
    u1, c1 = ops.parsa_cost_select(_t(nbr), _t(s), _t(retired),
                                   order=_t(order), enabled=_t(enabled))
    assert np.array_equal(u1.numpy(), np.asarray(u2))
    assert np.array_equal(c1.numpy(), np.asarray(c2))


def test_select_conflict_chain_matches_jax():
    """All-identical columns force the worst-case collision cascade."""
    B, k, num_v = 128, 16, 500
    rng = np.random.default_rng(7)
    nbr = jk.pack_bitmask(
        [rng.choice(num_v, size=20, replace=False) for _ in range(B)], num_v)
    s = np.zeros((k, (num_v + 31) // 32), np.int32)
    retired = np.zeros(B, bool)
    order = np.arange(k, dtype=np.int32)
    enabled = np.ones(k, bool)
    u2, c2 = jk.parsa_select_greedy_ref(
        jnp.asarray(nbr), jnp.asarray(s), jnp.asarray(retired),
        jnp.asarray(order), jnp.asarray(enabled))
    u1, c1 = ops.parsa_cost_select(_t(nbr), _t(s), _t(retired),
                                   order=_t(order), enabled=_t(enabled))
    assert np.array_equal(u1.numpy(), np.asarray(u2))
    assert np.array_equal(c1.numpy(), np.asarray(c2))
    assert len(set(u1.tolist())) == k and (c1 < tk.BIG).all()


def test_select_empty_and_disabled_slots():
    """Every row retired → (-1, BIG) in greedy mode, (BIG, 0) independent."""
    nbr = _t(tk.pack_bitmask([np.arange(5)] * 4, 64))
    s = torch.zeros((3, 2), dtype=torch.int32)
    retired = torch.ones(4, dtype=torch.bool)
    u, c = ops.parsa_cost_select(nbr, s, retired,
                                 order=torch.arange(3, dtype=torch.int32))
    assert u.tolist() == [-1] * 3 and c.tolist() == [tk.BIG] * 3
    m, a = ops.parsa_cost_select(nbr, s, retired)
    assert m.tolist() == [tk.BIG] * 3 and a.tolist() == [0] * 3
    u, c = ops.parsa_cost_select(
        nbr, s, torch.zeros(4, dtype=torch.bool),
        order=torch.arange(3, dtype=torch.int32),
        enabled=torch.tensor([False, True, False]))
    assert u.tolist() == [-1, 0, -1] and c.tolist() == [tk.BIG, 5, tk.BIG]


# ----------------------------------------------------------- refine sweep
@pytest.mark.parametrize("k,cw", [(4, 2), (8, 4), (16, 2), (32, 1), (64, 3)])
def test_refine_sweep_ref_matches_jax(k, cw):
    rng = np.random.default_rng(k * 10 + cw)
    C = cw * 32
    words = rng.integers(0, 2**31, size=(k, cw), dtype=np.int64).astype(np.int32)
    words[:, -1] &= rng.integers(0, 2**16, dtype=np.int64)  # empty columns
    words[0, 0] |= np.int32(-(2**31))                         # bit 31
    bits = ((words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32))
            & 1).reshape(k, C)
    prev = np.full(C, -1, np.int32)
    for j in range(C):  # a consistent partial previous assignment
        nz = np.flatnonzero(bits[:, j])
        if nz.size and rng.random() < 0.6:
            prev[j] = rng.choice(nz)
    cost = rng.integers(0, 500, k).astype(np.int32)
    c_ref, p_ref = jk.refine_sweep_ref(jnp.asarray(words), jnp.asarray(prev),
                                       jnp.asarray(cost))
    c_t, p_t = ops.refine_sweep_chunk(_t(words), _t(prev), _t(cost))
    assert np.array_equal(c_t.numpy(), np.asarray(c_ref))
    assert np.array_equal(p_t.numpy(), np.asarray(p_ref))


# ------------------------------------------------------------- the wrappers
def test_wrappers_check_inputs():
    nbr = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.parsa_cost(nbr.long(), nbr)
    with pytest.raises(ValueError, match="word widths"):
        ops.parsa_cost(nbr, torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.parsa_cost(nbr.T, nbr.T)
    big_k = torch.zeros((ops.SELECT_MAX_K + 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 1024"):
        ops.parsa_cost_select(nbr, big_k, torch.zeros(8, dtype=torch.bool))
    ok_k = torch.zeros((ops.SELECT_MAX_K, 4), dtype=torch.int32)
    m, a = ops.parsa_cost_select(nbr, ok_k, torch.zeros(8, dtype=torch.bool))
    assert m.shape == (ops.SELECT_MAX_K,)
    with pytest.raises(ValueError, match="k <= 1024"):
        ops.refine_sweep_chunk(
            torch.zeros((ops.REFINE_MAX_K + 1, 1), dtype=torch.int32),
            torch.full((32,), -1, dtype=torch.int32),
            torch.zeros(ops.REFINE_MAX_K + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="prev must have"):
        ops.refine_sweep_chunk(torch.zeros((4, 2), dtype=torch.int32),
                               torch.zeros(32, dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32))


def test_cpu_wrappers_launch_nothing():
    ops.reset_launch_counts()
    nbr = torch.zeros((8, 4), dtype=torch.int32)
    ops.parsa_cost(nbr, nbr)
    ops.parsa_cost_select(nbr, nbr, torch.zeros(8, dtype=torch.bool))
    assert all(v == 0 for v in ops.LAUNCHES.values())


# ------------------------------------------------- the card (skipped here)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    rng = np.random.default_rng(1)
    nbr = _t(_full_range_words(rng, (300, 70))).to(cuda_device)
    s = _t(_full_range_words(rng, (20, 70))).to(cuda_device)
    assert torch.equal(ops.parsa_cost(nbr, s), tk.parsa_cost_ref(nbr, s))
    retired = _t(rng.random(300) < 0.3).to(cuda_device)
    order = _t(rng.permutation(20).astype(np.int32)).to(cuda_device)
    enabled = _t(rng.random(20) < 0.8).to(cuda_device)
    for got, want in zip(
            ops.parsa_cost_select(nbr, s, retired, order=order,
                                  enabled=enabled),
            tk.parsa_select_greedy_ref(nbr, s, retired, order, enabled)):
        assert torch.equal(got, want)
    words = _t(_full_range_words(rng, (40, 4))).to(cuda_device)
    prev = torch.full((128,), -1, dtype=torch.int32, device=cuda_device)
    cost = torch.zeros(40, dtype=torch.int32, device=cuda_device)
    for got, want in zip(ops.refine_sweep_chunk(words, prev, cost),
                         tk.refine_sweep_ref(words, prev, cost)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 33, 2047, 2048])
def test_cuda_cost_tile_equals_plain_version(cuda_device, W):
    """The cost tile (parsa_cost and parsa_select_tile) against its plain
    version: K of 1, 17, 64 and 1,024; U not a multiple of the rows a CTA
    takes; all-zero, all-ones, full-range and sparse rows; the K=1
    down-date against an almost all-ones complement mask; a row-major and a
    misaligned (16-byte loads off) block."""
    rng = np.random.default_rng(W)
    num_v = 32 * W
    U = 259
    sparse = jk.pack_bitmask([rng.choice(num_v, size=rng.integers(0, min(40, num_v)),
                                         replace=False) for _ in range(U)], num_v)
    sparse[0] = 0
    sparse[1] = -1
    sparse[2] = _full_range_words(rng, (W,))
    nbr = _t(sparse).to(cuda_device)
    for K in (1, 17, 64, 1024):
        s = _t(_full_range_words(rng, (K, W))
               & _full_range_words(rng, (K, W))).to(cuda_device)
        want = tk.parsa_cost_ref(nbr, s)
        assert torch.equal(ops.parsa_cost(nbr, s), want)
        assert torch.equal(ops.parsa_select_tile(nbr, s), want.T.contiguous())
    comp = ~(nbr[5:6] & ~s[:1])
    assert torch.equal(ops.parsa_cost(nbr, comp), tk.parsa_cost_ref(nbr, comp))
    off = torch.empty(U * W + 1, dtype=torch.int32, device=cuda_device)
    shifted = off[1:].view(U, W)
    shifted.copy_(nbr)
    assert torch.equal(ops.parsa_cost(shifted, s), tk.parsa_cost_ref(nbr, s))


@pytest.mark.cuda
@pytest.mark.parametrize("U,K,W", [(7, 2100, 33), (131, 2100, 2048),
                                   (33, 1025, 2047)])
def test_cuda_parsa_cost_past_1024_partitions(cuda_device, U, K, W):
    """parsa_cost past 1,024 partitions, where the tile reads each row again
    for every further group of 1,024, against its plain version."""
    rng = np.random.default_rng(K + W)
    nbr = _full_range_words(rng, (U, W))
    nbr[0] = 0
    nbr[-1] = -1
    nbr = _t(nbr).to(cuda_device)
    s = _t(_full_range_words(rng, (K, W))
           & _full_range_words(rng, (K, W))).to(cuda_device)
    assert torch.equal(ops.parsa_cost(nbr, s), tk.parsa_cost_ref(nbr, s))


@pytest.mark.cuda
def test_cuda_select_tile_at_per_round_shape(cuda_device):
    """parsa_select_tile at the per-round route's shape, B=1,024, k=64,
    W=2,048, on sparse rows."""
    rng = np.random.default_rng(5)
    num_v = 32 * 2048
    nbr = _t(jk.pack_bitmask([rng.choice(num_v, size=rng.integers(0, 60),
                                         replace=False) for _ in range(1024)],
                             num_v)).to(cuda_device)
    s = _t(jk.pack_bitmask(rng.random((64, num_v)) < 0.25, num_v)).to(
        cuda_device)
    assert torch.equal(ops.parsa_select_tile(nbr, s),
                       tk.parsa_cost_ref(nbr, s).T.contiguous())
