"""The port's Algorithm 4 workers against the JAX package: kernel 5's plain
versions (``packed_union_delta``, ``merge_worker_sets``), the block-sharding
helpers, and the ``parallel_device`` backend — at one worker in process,
and at 4 and 8 workers against JAX ``parallel_device`` run on 8 forced host
devices in a subprocess.  Every comparison is bit for bit (tolerance 0:
the program is integer)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core import jax_partition as jp
from repro.graphs import ctr_like as j_ctr_like
from repro.graphs import text_like as j_text_like
from repro.kernels import parsa_cost as jk
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import graph_from_numpy
from repro_torch.core import partition as tp
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.kernels import parsa_cost as tk
from repro_torch.kernels.parsa_cost import ops
from torch_dist_ranks import run_jax

METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
TRAFFIC_FIELDS = ("pushed_bytes", "pulled_bytes", "tasks",
                  "stale_pushes_missed", "migration_bytes")
SKETCH_KW = dict(set_repr="sketch", sketch_hot_bits=1024,
                 sketch_bucket_bits=512)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _full_range_words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


# ------------------------------------------------- kernel 5, plain version
@pytest.mark.parametrize("W", [1, 37, 512, 1000])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_packed_union_delta_matches_jax(k, W):
    rng = np.random.default_rng(k * 1000 + W)
    new, old = _full_range_words(rng, (k, W)), _full_range_words(rng, (k, W))
    new[:, 0] |= np.int32(-2**31)   # bit 31 set: a negative int32 word
    old[0, :] = 0
    ju, jd = jk.packed_union_delta(jnp.asarray(new), jnp.asarray(old),
                                   use_kernel=True, interpret=True)
    u, d = ops.packed_union_delta(_t(new), _t(old))
    assert np.array_equal(u.numpy(), np.asarray(ju))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(u.numpy(), tk.packed_union(new, old))
    assert np.array_equal(d.numpy(), tk.packed_delta(new, old))
    assert np.array_equal(tk.packed_union(new, old), jk.packed_union(new, old))
    assert np.array_equal(tk.packed_delta(new, old), jk.packed_delta(new, old))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_merge_worker_sets_matches_numpy(n):
    """The server merge of n workers that grew their copies from ``old``:
    the OR-merge, the changed words they push, the merged sizes and the
    merged state written back into every worker's copy, against a numpy
    loop; words with bit 31 set, sizes that wrap in int32."""
    rng = np.random.default_rng(n)
    k, W = 5, 77
    old = _full_range_words(rng, (k, W)) & _full_range_words(rng, (k, W))
    old[:, 0] |= np.int32(-2**31)
    grow = [_full_range_words(rng, (k, W)) * (rng.random((k, W)) < 0.3)
            for _ in range(n)]
    local = np.stack([old | g.astype(np.int32) for g in grow])
    sz_old = rng.integers(0, 1000, k).astype(np.int32)
    sz_old[0] = 2**31 - 2                     # the sum wraps in int32
    sz_loc = sz_old + rng.integers(0, 20, (n, k)).astype(np.int32)
    pushed = torch.full((1,), 7, dtype=torch.int64)
    l_t, zl_t = _t(local.copy()), _t(sz_loc.copy())   # written back
    merged, sizes = ops.merge_worker_sets(l_t, _t(old), zl_t, _t(sz_old),
                                          pushed)
    want = old.copy()
    for w in range(n):
        want = jk.packed_union(want, local[w])
    n_words = sum(int(np.count_nonzero(jk.packed_delta(local[w], old)))
                  for w in range(n))
    want_sz = (sz_old.astype(np.int64)
               + (sz_loc.astype(np.int64) - sz_old).sum(0))
    want_sz = ((want_sz + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert np.array_equal(merged.numpy(), want)
    assert np.array_equal(sizes.numpy(), want_sz)
    assert int(pushed) == 7 + n_words and n_words > 0
    assert all(np.array_equal(l_t[w].numpy(), want) for w in range(n))
    assert all(np.array_equal(zl_t[w].numpy(), want_sz) for w in range(n))
    l2, zl2 = _t(local.copy()), _t(sz_loc.copy())
    m2, s2, c2 = tk.merge_worker_sets_ref(l2, _t(old), zl2, _t(sz_old))
    assert torch.equal(m2, merged) and torch.equal(s2, sizes)
    assert int(c2) == n_words
    assert torch.equal(l2, l_t) and torch.equal(zl2, zl_t)


def test_union_delta_wrappers_check_inputs():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.packed_union_delta(a, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="must be a 2-D"):
        ops.packed_union_delta(a.long(), a.long())
    sz = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be"):
        ops.merge_worker_sets(a[None], a, sz[None], sz,
                              torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        ops.merge_worker_sets(a[None], a, sz[None], sz,
                              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="sz_local"):
        ops.merge_worker_sets(a[None], a, sz[None, :1], sz,
                              torch.zeros(1, dtype=torch.int64))
    ops.reset_launch_counts()
    ops.merge_worker_sets(a[None], a, sz[None].clone(), sz,
                          torch.zeros(1, dtype=torch.int64))
    assert ops.LAUNCHES["packed_union_delta"] == 0   # the CPU launches none


# --------------------------------------------------- block-sharding helpers
@pytest.mark.parametrize("seed", range(3))
def test_sharding_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    workers, nb = int(rng.integers(2, 9)), int(rng.integers(5, 60))
    w = rng.random(workers) * (rng.random(workers) < 0.8) + 1e-3
    t_j = jp._weighted_block_targets(w, nb)
    t_t = tp._weighted_block_targets(w, nb)
    assert np.array_equal(t_t, t_j) and t_t.sum() == nb
    nb_per = -(-int(t_t.max()) // 3) * 3
    for shuffle in (None, 11 + seed):
        rj = None if shuffle is None else np.random.default_rng(shuffle)
        rt = None if shuffle is None else np.random.default_rng(shuffle)
        assert np.array_equal(tp._biased_perm(t_t, nb, nb_per, rt),
                              jp._biased_perm(t_j, nb, nb_per, rj))
    g = j_text_like(300, 700, mean_len=40, seed=seed)
    pk_j = jp.pack_graph_blocks(g, 64, cap=4)       # truncated rows
    pk_t = tp.pack_graph_blocks(_port(g), 64, cap=4)
    total = pk_j.valid.shape[0] + int(rng.integers(0, 7))
    got, want = tp._pad_block_stack(pk_t, total), jp._pad_block_stack(pk_j,
                                                                      total)
    for name in want._fields:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


# ------------------------------------------------------ one worker, in process
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("merge_every", [1, 3])
def test_one_worker_equals_device_scan(merge_every, warm):
    """W=1 collapses to the sequential scan for any merge cadence, cold and
    warm, as in JAX; and both equal JAX at W=1 (one host device)."""
    g = j_text_like(500, 800, mean_len=20, seed=9)
    k, kw = 8, dict(block=128, seed=2)
    S0 = (np.random.default_rng(1).random((k, g.num_v)) < 0.1) if warm \
        else None
    want_p, want_s = tp.blocked_partition_u_impl(
        _port(g), k, init_sets=S0, device="cpu", **kw)
    got_p, got_s, traffic = tp.parallel_blocked_partition_u_impl(
        _port(g), k, workers=1, merge_every=merge_every, init_sets=S0,
        device="cpu", **kw)
    assert torch.equal(got_p, want_p) and torch.equal(got_s, want_s)
    jpu, jsm, jtr = jp.parallel_blocked_partition_u_impl(
        g, k, workers=1, merge_every=merge_every, init_sets=S0,
        use_kernel=False, **kw)
    assert np.array_equal(got_p.numpy(), jpu)
    assert np.array_equal(got_s.numpy(), jsm)
    assert traffic == jtr
    assert traffic["stale_pushes_missed"] == 0 and traffic["pushed_bytes"] > 0


def test_devices_override_workers_and_dispatch_is_counted():
    g = _port(j_text_like(400, 600, mean_len=12, seed=3))
    cfg = ParsaConfig(k=4, backend="parallel_device", block_size=64,
                      workers=2, devices=4, merge_every=2, refine_v=False)
    with dispatch_counter() as counts:
        a = partition(g, cfg, device="cpu")
    b = partition(g, cfg.replace(workers=4, devices=None), device="cpu")
    assert np.array_equal(a.parts_u, b.parts_u) and a.traffic == b.traffic
    assert a.traffic.tasks == 4 * 1   # 7 blocks → 2 a worker, 1 merge
    assert counts["parallel_partition_scan"] == 1
    assert counts.records[-1].meta == {"k": 4, "workers": 4, "blocks": 8}
    assert counts.launches == {"parallel_partition_scan": {}}


def test_workers_and_merge_every_are_checked():
    g = _port(j_text_like(50, 60, mean_len=5, seed=0))
    for kw, match in ((dict(workers=0), "workers"),
                      (dict(merge_every=0), "merge_every")):
        with pytest.raises(ValueError, match=match):
            tp.parallel_blocked_partition_u_impl(g, 4, device="cpu", **kw)


# ------------------------------------- many workers, against JAX on 8 devices
def _facade_cases():
    """name → (graph generator kwargs, config kwargs)."""
    g1 = ("text", dict(num_docs=1200, vocab=2000, mean_len=15, seed=4))
    base = dict(block_size=64, refine_backend="device", sweeps=2, seed=0)
    return {
        "w4m1": (g1, dict(k=8, workers=4, merge_every=1, **base)),
        "w8m2": (g1, dict(k=8, workers=8, merge_every=2, **base)),
        "k3w4": (("text", dict(num_docs=997, vocab=1500, mean_len=12,
                               seed=0)),
                 dict(k=3, workers=4, merge_every=1, **base)),
        "ginit": (g1, dict(k=8, workers=4, merge_every=2,
                           global_init_frac=0.05, **base)),
        "sketch": (("ctr", dict(num_impressions=800, num_features=4000,
                                nnz_per_row=15, seed=2)),
                   dict(k=8, workers=4, merge_every=1,
                        **dict(base, block_size=128), **SKETCH_KW)),
    }


# the low-level scans: (worker_weights, shuffle seed) on g1 at B=64, k=8,
# workers=4, merge_every=2
SCAN_CASES = {"shuffle": (None, 7), "weights": ([1.0, 2.0, 0.5, 3.0], None),
              "weights_shuffle": ([1.0, 2.0, 0.5, 3.0], 7)}

# shard_parsa_step at 4 workers on the same graph, 20 blocks of 64 (the
# last 1.25 padding): (select, warm S and sizes)
SHARD_CASES = {"shard_rounds": ("rounds", False), "shard_seq": ("seq", False),
               "shard_rounds_warm": ("rounds", True)}

_JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.api import ParsaConfig, partition
from repro.core import jax_partition as jp
from repro.graphs import ctr_like, text_like

facade, scans, shard, out_path = json.loads(sys.argv[1])
gen = {"text": text_like, "ctr": ctr_like}
out = {}
for name, ((kind, gkw), ckw) in facade.items():
    g = gen[kind](**gkw)
    r = partition(g, ParsaConfig(backend="parallel_device", **ckw))
    out[name + "/parts_u"] = r.parts_u
    out[name + "/s_masks"] = r.s_masks
    out[name + "/parts_v"] = r.parts_v
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        out[name + "/m_" + f] = getattr(r.metrics, f)
    for f in ("pushed_bytes", "pulled_bytes", "tasks", "stale_pushes_missed",
              "migration_bytes"):
        out[name + "/t_" + f] = getattr(r.traffic, f)
g = text_like(1200, 2000, mean_len=15, seed=4)
order = np.random.default_rng(0).permutation(g.num_u)
packed = jp.pack_graph_blocks(g, 64, order=order)
W = (g.num_v + 31) // 32
for name, (weights, shuffle) in scans.items():
    parts, s, sz, traffic, perm = jp._run_parallel_packed_scan(
        packed, jnp.zeros((8, W), jnp.int32), jnp.zeros(8, jnp.int32), k=8,
        workers=4, merge_every=2, use_kernel=False, interpret=None,
        shuffle_rng=None if shuffle is None else np.random.default_rng(shuffle),
        worker_weights=None if weights is None else np.asarray(weights))
    out[name + "/parts"] = np.asarray(parts)
    out[name + "/s"] = np.asarray(s)
    out[name + "/sizes"] = np.asarray(sz)
    out[name + "/perm"] = perm
    for f, v in traffic.items():
        out[name + "/t_" + f] = v
# shard_parsa_step's body under shard_map at 4 workers: the blocks
# sharded over "data", S and sizes replicated (zero, or warm)
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
stack = jp._pad_block_stack(packed, 20)
for name, (select, warm) in shard.items():
    body = jp.shard_parsa_step(8, axis="data", use_kernel=False,
                               select=select)
    fn = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 6 + (P(), P()),
                   out_specs=(P("data"), P(), P()), check_vma=False)
    rng = np.random.default_rng(5)
    s0 = (rng.integers(0, 2**31, (8, W)) * (rng.random((8, W)) < 0.05)
          if warm else np.zeros((8, W))).astype(np.int32)
    z0 = (rng.integers(0, 5, 8) if warm else np.zeros(8)).astype(np.int32)
    parts, merged, sizes = fn(
        *(jnp.asarray(getattr(stack, f)) for f in
          ("valid", "widx", "vals", "trunc", "tr_ids", "tr_masks")),
        jnp.asarray(s0), jnp.asarray(z0))
    out[name + "/parts"] = np.asarray(parts)
    out[name + "/merged"] = np.asarray(merged)
    out[name + "/sizes"] = np.asarray(sizes)
    out[name + "/s0"] = s0
    out[name + "/z0"] = z0
np.savez(out_path, **out)
print("JAX_PARALLEL_DONE")
"""


@pytest.fixture(scope="module")
def jax_parallel(tmp_path_factory):
    """JAX ``parallel_device`` results on 8 forced host devices, computed
    once in a subprocess (the device count is fixed when JAX starts)."""
    path = tmp_path_factory.mktemp("jax_parallel") / "out.npz"
    arg = json.dumps([_facade_cases(), SCAN_CASES, SHARD_CASES, str(path)])
    run_jax(_JAX_SCRIPT, arg, "JAX_PARALLEL_DONE")
    return dict(np.load(path, allow_pickle=True))


@pytest.mark.parametrize("name", list(_facade_cases()))
def test_parallel_device_matches_jax(jax_parallel, name):
    (kind, gkw), ckw = _facade_cases()[name]
    g = (j_text_like if kind == "text" else j_ctr_like)(**gkw)
    got = partition(_port(g), ParsaConfig(backend="parallel_device", **ckw),
                    device="cpu")
    want = {k.split("/", 1)[1]: v for k, v in jax_parallel.items()
            if k.startswith(name + "/")}
    for f in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(got, f), want[f]), f
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(got.metrics, f), want["m_" + f]), f
    for f in TRAFFIC_FIELDS:
        assert getattr(got.traffic, f) == int(want["t_" + f]), f
    sizes = np.bincount(got.parts_u, minlength=ckw["k"])
    assert sizes.max() - sizes.min() <= ckw["workers"]
    assert got.traffic.stale_pushes_missed > 0


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_run_parallel_packed_scan_matches_jax(jax_parallel, name):
    """Shuffled and weighted block→worker orders: the sharded parts, the
    merged state, the traffic and the permutation."""
    weights, shuffle = SCAN_CASES[name]
    g = _port(j_text_like(1200, 2000, mean_len=15, seed=4))
    order = np.random.default_rng(0).permutation(g.num_u)
    packed = tp.pack_graph_blocks(g, 64, order=order)
    W = (g.num_v + 31) // 32
    parts, s, sz, traffic, perm = tp._run_parallel_packed_scan(
        packed, torch.zeros((8, W), dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), k=8, workers=4, merge_every=2,
        shuffle_rng=None if shuffle is None else np.random.default_rng(shuffle),
        worker_weights=None if weights is None else np.asarray(weights))
    assert np.array_equal(parts.numpy(), jax_parallel[name + "/parts"])
    assert np.array_equal(s.numpy(), jax_parallel[name + "/s"])
    assert np.array_equal(sz.numpy(), jax_parallel[name + "/sizes"])
    assert np.array_equal(perm, jax_parallel[name + "/perm"])
    for f, v in traffic.items():
        assert v == int(jax_parallel[name + "/t_" + f]), f
    # stack order: every real row assigned exactly once
    flat = parts.reshape(-1, 64).numpy()[np.argsort(perm)]
    assert (flat.reshape(-1)[: g.num_u] >= 0).all()


@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_shard_parsa_step_matches_jax_at_4_workers(jax_parallel, name):
    """The port's ``shard_parsa_step`` body with the 4 workers as a
    leading axis against JAX's under ``shard_map`` on 4 host devices: the
    same blocks a worker, ``parts``, ``merged`` and ``sizes`` bit for bit
    (the sizes are JAX's ``psum`` of every worker's copy, so warm sizes
    count 4 times)."""
    select, warm = SHARD_CASES[name]
    g = _port(j_text_like(1200, 2000, mean_len=15, seed=4))
    order = np.random.default_rng(0).permutation(g.num_u)
    stack = tp._pad_block_stack(tp.pack_graph_blocks(g, 64, order=order), 20)
    body = tp.shard_parsa_step(8, select=select)
    args = [_t(getattr(stack, f)).reshape((4, 5) + getattr(stack, f).shape[1:])
            for f in ("valid", "widx", "vals", "trunc", "tr_ids", "tr_masks")]
    s0, z0 = (_t(jax_parallel[f"{name}/{f}"]) for f in ("s0", "z0"))
    parts, merged, sizes = body(*args, s0, z0)
    assert np.array_equal(parts.reshape(20, 64).numpy(),
                          jax_parallel[name + "/parts"])
    assert np.array_equal(merged.numpy(), jax_parallel[name + "/merged"])
    assert np.array_equal(sizes.numpy(), jax_parallel[name + "/sizes"])
    real = parts.reshape(-1).numpy()[: g.num_u]
    assert (real >= 0).all()
    assert int(sizes.sum()) == g.num_u + 4 * int(z0.sum())
    assert bool((merged | s0 == merged).all())   # S only grows


# ------------------------------------------------- the card (skipped here)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_union_delta_equals_plain_version(cuda_device):
    rng = np.random.default_rng(2)
    for k, W in ((1, 1), (3, 37), (16, 2048), (8, 1000)):
        new = _t(_full_range_words(rng, (k, W))).to(cuda_device)
        old = _t(_full_range_words(rng, (k, W))).to(cuda_device)
        for got, want in zip(ops.packed_union_delta(new, old),
                             tk.packed_union_delta_ref(new, old)):
            assert torch.equal(got, want)
    for n in (1, 2, 4, 8):
        for k, W in ((16, 2048), (3, 37)):
            old = _t(_full_range_words(rng, (k, W))).to(cuda_device)
            local = old | _t(_full_range_words(rng, (n, k, W))).to(
                cuda_device)
            sz_old = torch.arange(k, dtype=torch.int32, device=cuda_device)
            sz_loc = sz_old + _t(rng.integers(0, 9, (n, k)).astype(
                np.int32)).to(cuda_device)
            pushed = torch.zeros(1, dtype=torch.int64, device=cuda_device)
            l2, z2 = local.clone(), sz_loc.clone()
            merged, sizes = ops.merge_worker_sets(local, old, sz_loc, sz_old,
                                                  pushed)
            want, want_sz, n_words = tk.merge_worker_sets_ref(l2, old, z2,
                                                              sz_old)
            assert torch.equal(merged, want) and torch.equal(sizes, want_sz)
            assert int(pushed) == int(n_words)
            assert torch.equal(local, l2) and torch.equal(sz_loc, z2)
