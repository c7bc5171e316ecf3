"""The port's blocked greedy scan and its refine as the kernels see them:
``parsa_scan``'s plain version ``parsa_scan_ref`` (the CPU path of
``_partition_scan`` and ``_parallel_scan``) against the JAX
``_partition_scan`` and ``parallel_device``, and ``refine_scan_ref`` (the
CPU path of the one-launch refine) against the JAX ``_refine_scan``.
Every comparison is bit for bit (tolerance 0: the program is integer):
parts, packed sets and sizes.  The inputs are made with numpy from a seed:
truncated rows (a small ``cap``), blocks of padding rows only, words with
bit 31 set, entering sets, entering sizes unequal by one (the catch-up
round), sketched widths, and 1, 4 and 8 workers."""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core import jax_partition as jp
from repro.core import jax_refine as jr
from repro.core.bipartite import from_edges as j_from_edges
from repro.graphs import ctr_like as j_ctr_like
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import graph_from_numpy
from repro_torch.core import partition as tp
from repro_torch.core import refine as tr
from repro_torch.kernels.parsa_cost import ops, parsa_scan_ref, refine_scan_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
SKETCH_KW = dict(set_repr="sketch", sketch_hot_bits=1024,
                 sketch_bucket_bits=512)


def _t(a):
    """A CPU tensor holding a copy of ``a`` (the scans write in place)."""
    return torch.from_numpy(np.array(a, order="C"))


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _graph(seed, num_u, words, max_len=40):
    """A random graph on 32·``words`` columns; every third row lies on
    columns ≡ 31 (mod 32), so its words have bit 31 set."""
    rng = np.random.default_rng(seed)
    num_v = 32 * words
    us, vs = [], []
    for u in range(num_u):
        cols = rng.choice(num_v, size=int(rng.integers(0, max_len)),
                          replace=False)
        if u % 3 == 0:
            cols = np.unique(cols | 31)
        us.append(np.full(cols.size, u))
        vs.append(cols)
    return j_from_edges(num_u, num_v, np.concatenate(us), np.concatenate(vs))


def _state(seed, k, words, *, init, unequal, workers=None):
    """Entering (k, W) sets (sparse random words, or zeros) and (k,) sizes
    (3, or 3 and 4 mixed), with a leading worker axis if ``workers``."""
    rng = np.random.default_rng(seed + 1000)
    shape = (k, words) if workers is None else (workers, k, words)
    s = np.zeros(shape, np.int32)
    if init:
        bits = rng.random(shape + (32,)) < 0.05
        s = np.packbits(bits, axis=-1, bitorder="little").view(
            np.int32)[..., 0].copy()
    sizes = np.full(shape[:-1], 3, np.int32)
    if unequal:
        sizes += (rng.random(shape[:-1]) < 0.5).astype(np.int32)
    return s, sizes


def _packed(g, B, cap, pad_blocks=0, seed=0):
    """The graph packed by the JAX packer in the scan's vertex order, with
    ``pad_blocks`` blocks of padding rows only appended."""
    order = np.random.default_rng(seed).permutation(g.num_u)
    pk = jp.pack_graph_blocks(g, B, order=order, cap=cap)
    return jp._pad_block_stack(pk, pk.valid.shape[0] + pad_blocks)


def _jax_scan(pk, s, sizes, k):
    parts, s_out, sz_out = jp._partition_scan(
        *(jnp.asarray(x) for x in (pk.valid, pk.widx, pk.vals, pk.trunc,
                                   pk.tr_ids, pk.tr_masks)),
        jnp.asarray(s), jnp.asarray(sizes), k=k, use_kernel=False,
        interpret=None)
    return [np.asarray(x) for x in (parts, s_out, sz_out)]


def _port_arrays(pk, workers=1):
    """The packed stack as (workers, nb / workers, ...) CPU tensors."""
    return [_t(x.reshape((workers, -1) + x.shape[1:])) for x in (
        pk.widx, pk.vals, pk.tr_ids, pk.tr_masks, pk.valid)]


# ------------------------------------------------ parsa_scan, plain version
@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("B", [8, 40, 128])
def test_parsa_scan_ref_matches_jax_scan(B, k):
    """Truncated rows, bit-31 words, two padding blocks, entering sets and
    sizes unequal by one; ``parsa_scan_ref`` and the port's
    ``_partition_scan`` (its CPU route) equal the JAX scan."""
    words = 12
    g = _graph(B * 10 + k, 3 * B - B // 3, words)
    pk = _packed(g, B, cap=4, pad_blocks=2)
    assert pk.trunc.any() and not pk.valid[-2:].any()
    s0, sz0 = _state(B + k, k, words, init=True, unequal=True)
    want = _jax_scan(pk, s0, sz0, k)
    arrays = _port_arrays(pk)
    s, sz = _t(s0[None]), _t(sz0[None])
    parts = torch.full(pk.valid[None].shape, -1, dtype=torch.int32)
    parsa_scan_ref(*arrays, s, sz, parts)
    for got, w in zip((parts[0], s[0], sz[0]), want):
        assert np.array_equal(got.numpy(), w)
    s2, sz2 = _t(s0), _t(sz0)
    p2 = tp._partition_scan(*(a[0] for a in arrays), s2, sz2)
    for got, w in zip((p2, s2, sz2), want):
        assert np.array_equal(got.numpy(), w)
    assert (want[0][-2:] == -1).all()     # padding blocks pick nothing


def test_parsa_scan_ref_block_ranges_compose():
    """Scanning blocks [0, 2) and then [2, nb) equals one scan of all, per
    worker, and ``ops.parsa_scan`` on the CPU is the plain version."""
    g = _graph(5, 700, 8)
    pk = _packed(g, 64, cap=6, pad_blocks=-(-(-700 // 64)) % 4 + 4)
    arrays = _port_arrays(pk, workers=4)
    s0, sz0 = _state(5, 8, 8, init=True, unequal=True, workers=4)
    nb = arrays[0].shape[1]

    def run(ranges, fn):
        s, sz = _t(s0), _t(sz0)
        parts = torch.full(arrays[4].shape, -1, dtype=torch.int32)
        for b0, n in ranges:
            fn(*arrays, s, sz, parts, b0, n)
        return parts, s, sz

    whole = run([(0, nb)], parsa_scan_ref)
    split = run([(0, 2), (2, nb - 2)], parsa_scan_ref)
    ops.reset_launch_counts()
    wrapped = run([(0, 2), (2, nb - 2)], lambda *a: ops.parsa_scan(
        *a[:8], b0=a[8], nblk=a[9]))
    assert ops.LAUNCHES["parsa_scan"] == 0          # the CPU launches none
    for a, b, c in zip(whole, split, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_worker_batched_super_step_matches_jax(workers):
    """One super-step of Algorithm 4, all workers in one plain call: each
    worker's blocks against its own stale sets and sizes equal the JAX scan
    of those blocks from the same state."""
    B, k, words, m = 40, 3, 10, 3
    g = _graph(workers, workers * m * B - 17, words)
    pk = _packed(g, B, cap=5, pad_blocks=workers * m - (-(-g.num_u // B)))
    assert pk.valid.shape[0] == workers * m and pk.trunc.any()
    s0, sz0 = _state(workers, k, words, init=True, unequal=True,
                     workers=workers)
    arrays = _port_arrays(pk, workers)
    s, sz = _t(s0), _t(sz0)
    parts = torch.full(arrays[4].shape, -1, dtype=torch.int32)
    parsa_scan_ref(*arrays, s, sz, parts, 0, m)
    for w in range(workers):
        sl = slice(w * m, (w + 1) * m)
        sub = jp.PackedBlocks(*(x[sl] if i < 6 else x
                                for i, x in enumerate(pk)))
        want = _jax_scan(sub, s0[w], sz0[w], k)
        for got, ww in zip((parts[w], s[w], sz[w]), want):
            assert np.array_equal(got.numpy(), ww)


# ----------------------------------------- the whole parallel scan, vs JAX
# (workers, merge_every, cap, init, graph seed) on 1,100 rows at B=64, k=8
PAR_CASES = {"w1": (1, 3, 4, True, 0), "w4": (4, 2, 4, True, 1),
             "w8": (8, 1, 6, False, 2)}

_JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.core import jax_partition as jp
from repro.core.bipartite import from_edges

cases, in_path, out_path = json.loads(sys.argv[1])
data = np.load(in_path)
out = {}
for name, (workers, m, cap) in cases.items():
    g = from_edges(1100, 32 * 12, data[name + "/us"], data[name + "/vs"])
    order = np.random.default_rng(0).permutation(g.num_u)
    pk = jp.pack_graph_blocks(g, 64, order=order, cap=cap)
    parts, s, sz, traffic, _ = jp._run_parallel_packed_scan(
        pk, jnp.asarray(data[name + "/s0"]), jnp.zeros(8, jnp.int32),
        k=8, workers=workers, merge_every=m, use_kernel=False,
        interpret=None)
    out[name + "/parts"] = np.asarray(parts)
    out[name + "/s"] = np.asarray(s)
    out[name + "/sizes"] = np.asarray(sz)
    for f, v in traffic.items():
        out[name + "/t_" + f] = v
np.savez(out_path, **out)
print("JAX_SCAN_DONE")
"""


def _par_inputs(name):
    """The case's graph and entering sets."""
    _, _, _, init, seed = PAR_CASES[name]
    g = _graph(100 + seed, 1100, 12)
    s0, _ = _state(seed, 8, 12, init=init, unequal=False)
    return g, s0


@pytest.fixture(scope="module")
def jax_parallel_scans(tmp_path_factory):
    """JAX ``parallel_device`` scans on 8 forced host devices, computed
    once in a subprocess (the device count is fixed when JAX starts)."""
    tmp = tmp_path_factory.mktemp("jax_scan")
    data = {}
    for name in PAR_CASES:
        g, s0 = _par_inputs(name)
        data[name + "/us"] = np.repeat(np.arange(g.num_u), np.diff(g.u_indptr))
        data[name + "/vs"] = g.u_indices
        data[name + "/s0"] = s0
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([{n: c[:3] for n, c in PAR_CASES.items()},
                      str(tmp / "in.npz"), str(tmp / "out.npz")])
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, arg], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "JAX_SCAN_DONE" in out.stdout, out.stdout + out.stderr
    return dict(np.load(tmp / "out.npz", allow_pickle=True))


@pytest.mark.parametrize("name", list(PAR_CASES))
def test_parallel_scan_matches_jax_parallel_device(jax_parallel_scans, name):
    """The port's Algorithm 4 scan (one plain ``parsa_scan`` call a
    super-step, then the merge) against JAX ``parallel_device``, with
    truncated rows, padding blocks and entering sets."""
    workers, m, cap = PAR_CASES[name][:3]
    g, s0 = _par_inputs(name)
    order = np.random.default_rng(0).permutation(g.num_u)
    pk = tp.pack_graph_blocks(_port(g), 64, order=order, cap=cap)
    assert pk.trunc.any()
    parts, s, sz, traffic, _ = tp._run_parallel_packed_scan(
        pk, _t(s0), torch.zeros(8, dtype=torch.int32),
        k=8, workers=workers, merge_every=m)
    want = {k.split("/", 1)[1]: v for k, v in jax_parallel_scans.items()
            if k.startswith(name + "/")}
    assert np.array_equal(parts.numpy(), want["parts"])
    assert np.array_equal(s.numpy(), want["s"])
    assert np.array_equal(sz.numpy(), want["sizes"])
    for f, v in traffic.items():
        assert v == int(want["t_" + f]), f


@pytest.mark.parametrize("backend", ["device_scan", "parallel_device"])
def test_sketched_scans_match_jax(backend):
    """Sketched widths through the facade: the compressing sketch of a
    CTR graph, with a warm start, equals JAX (one worker of
    parallel_device is device_scan bit for bit)."""
    g = j_ctr_like(num_impressions=700, num_features=6000, nnz_per_row=40,
                   seed=5)
    base = dict(k=8, block_size=64, refine_backend="device", sweeps=2,
                seed=1, **SKETCH_KW)
    want = j_partition(g, JConfig(backend="device_scan", **base))
    extra = (dict(workers=1, merge_every=3) if backend == "parallel_device"
             else {})
    got = partition(_port(g), ParsaConfig(backend=backend, **base, **extra),
                    device="cpu")
    assert want.sketch is not None and not want.sketch.is_exact
    for f in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), f


# ------------------------------------------------------- the shape routes
def test_scan_route_by_shape():
    """A tile past parsa_scan's shared memory goes to the per-round route
    on the card, by shape; the CPU always runs the plain version."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ops.scan_smem_bytes(256, 16) == 18720
    assert ops.parsa_scan_fits(256, 16) and ops.parsa_scan_fits(1024, 16)
    assert ops.parsa_scan_fits(1024, 50)
    assert not ops.parsa_scan_fits(1024, 64)     # 4·1024·64 = 256 KiB tile
    assert ops.scan_smem_bytes(1024, 64) > ops.SCAN_MAX_SMEM_BYTES
    assert not ops.parsa_scan_fits(ops.SELECT_MAX_B + 1, 1)
    assert not ops.parsa_scan_fits(8, ops.SELECT_MAX_K + 1)
    assert tp._scan_route(cuda, 1024, 64) == "per_round"
    assert tp._scan_route(cuda, 256, 16) == "parsa_scan"
    assert tp._scan_route(cpu, 1024, 64) == "parsa_scan"
    # the largest B at k=16 within the limit, and one past it
    B = max(b for b in range(1, 4000) if ops.parsa_scan_fits(b, 16))
    assert ops.scan_smem_bytes(B, 16) <= ops.SCAN_MAX_SMEM_BYTES
    assert ops.scan_smem_bytes(B + 1, 16) > ops.SCAN_MAX_SMEM_BYTES


@pytest.mark.parametrize("sketch", [False, True])
def test_per_round_route_matches_jax(sketch):
    """The per-round route (one select a round, committed by tensor ops)
    runs its CPU path here and gives the JAX scan's bits, with truncated
    rows and both select wrappers."""
    B, k, words = 64, 8, 16
    g = _graph(7 + sketch, 250, words)
    pk = _packed(g, B, cap=3, pad_blocks=1)
    s0, sz0 = _state(7, k, words, init=True, unequal=True)
    want = _jax_scan(pk, s0, sz0, k)
    arrays = _port_arrays(pk)
    s, sz = _t(s0[None]), _t(sz0[None])
    parts = torch.full(arrays[4].shape, -1, dtype=torch.int32)
    tp._scan_per_round(*arrays, s, sz, parts, 0, arrays[0].shape[1], sketch)
    for got, w in zip((parts[0], s[0], sz[0]), want):
        assert np.array_equal(got.numpy(), w)


def test_parsa_scan_checks_inputs():
    g = _graph(1, 100, 4)
    arrays = _port_arrays(_packed(g, 32, cap=4))
    s, sz = torch.zeros((1, 4, 4), dtype=torch.int32), torch.zeros(
        (1, 4), dtype=torch.int32)
    parts = torch.full(arrays[4].shape, -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes disagree"):
        ops.parsa_scan(*arrays, s, sz[:, :3].contiguous(), parts)
    with pytest.raises(ValueError, match="outside"):
        ops.parsa_scan(*arrays, s, sz, parts, b0=1, nblk=arrays[0].shape[1])
    with pytest.raises(ValueError, match="int32"):
        ops.parsa_scan(*arrays, s.long(), sz, parts)
    lw, lv, n = ops.truncated_lists(arrays[3])
    with pytest.raises(ValueError, match="tr_lists"):
        ops.parsa_scan(*arrays, s, sz, parts, tr_lists=(lw, lv, n[..., :-1]))


def test_truncated_lists_hold_each_rows_nonzero_words():
    """``parsa_scan``'s lists of the truncated rows: each row's nonzero
    words first, in column order, with their count; bit-31 words kept."""
    rng = np.random.default_rng(3)
    masks = np.where(rng.random((2, 3, 4, 40)) < 0.3,
                     rng.integers(-2**31, 2**31, (2, 3, 4, 40)),
                     0).astype(np.int32)
    masks[0, 0, 0] = 0                       # an empty slot
    masks[1, 2, 3, 0] = np.int32(-2**31)     # bit 31 only
    lw, lv, n = ops.truncated_lists(torch.from_numpy(masks))
    assert lw.dtype == lv.dtype == n.dtype == torch.int32
    for idx in np.ndindex(masks.shape[:-1]):
        cols = np.flatnonzero(masks[idx])
        assert n[idx] == cols.size
        assert np.array_equal(lw[idx][: cols.size].numpy(), cols)
        assert np.array_equal(lv[idx][: cols.size].numpy(), masks[idx][cols])
        assert not lv[idx][cols.size:].any()


# ------------------------------------------------------------ the refine
@pytest.mark.parametrize("k", [1, 16, 33])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_refine_scan_ref_matches_jax(sweeps, k):
    """All sweeps × chunks: ``refine_scan_ref``, ``ops.refine_scan`` (in
    place and not) and the port's ``_refine_scan`` against the JAX
    ``_refine_scan``, from a partial previous assignment."""
    rng = np.random.default_rng(sweeps * 100 + k)
    n, cw = 3, 2
    C = 32 * cw
    bits = rng.random((k, n * C)) < 0.3
    bits[:, -5:] = False                        # parameters nobody needs
    bits[0, 31] = True                          # bit 31 of word 0
    need = np.packbits(bits, axis=-1, bitorder="little").view(np.int32)
    need = need.reshape(k, n * cw)
    prev = np.full(n * C, -1, np.int32)
    for j in range(n * C):
        nz = np.flatnonzero(bits[:, j])
        if nz.size and rng.random() < 0.5:
            prev[j] = rng.choice(nz)
    cost = rng.integers(0, 400, k).astype(np.int32)
    wc, wp = jr._refine_scan(jnp.asarray(need), jnp.asarray(cost),
                             jnp.asarray(prev.reshape(n, C)), k=k,
                             sweeps=sweeps, cw=cw, use_kernel=False,
                             interpret=None)
    wc, wp = np.asarray(wc), np.asarray(wp)
    words = _t(need.reshape(k, n, cw).transpose(1, 0, 2))
    p0 = _t(prev.reshape(n, C))
    c, p = refine_scan_ref(words, p0, _t(cost), sweeps)
    assert np.array_equal(c.numpy(), wc) and np.array_equal(p.numpy(), wp)
    c2, p2 = ops.refine_scan(words, p0, _t(cost), sweeps)
    assert torch.equal(c2, c) and torch.equal(p2, p)
    inplace = p0.clone()
    c3 = tr._refine_scan(words, _t(cost), inplace, sweeps)
    assert torch.equal(c3, c) and torch.equal(inplace, p)
    assert torch.equal(p0, _t(prev.reshape(n, C)))   # prev is not written


def test_refine_scan_checks_inputs():
    w = torch.zeros((2, 4, 1), dtype=torch.int32)
    p = torch.full((2, 32), -1, dtype=torch.int32)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="sweeps >= 1"):
        ops.refine_scan(w, p, c, 0)
    with pytest.raises(ValueError, match="prev must have"):
        ops.refine_scan(w, p[:1].contiguous(), c, 1)
    with pytest.raises(ValueError, match="out must have"):
        ops.refine_scan(w, p, c, 1, out=p[:1].contiguous())
    ops.reset_launch_counts()
    ops.refine_scan(w, p, c, 2)
    assert ops.LAUNCHES["refine_sweep"] == 0   # the CPU launches none


# ------------------------------------------------- the card (skipped here)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_parsa_scan_equals_plain_version(cuda_device):
    g = _graph(3, 500, 64)
    pk = _packed(g, 40, cap=6, pad_blocks=-(-(-500 // 40)) % 4 + 4)
    arrays = [a.to(cuda_device) for a in _port_arrays(pk, workers=4)]
    s0, sz0 = _state(3, 16, 64, init=True, unequal=True, workers=4)
    out = []
    for fn in (ops.parsa_scan, parsa_scan_ref):
        s, sz = _t(s0).to(cuda_device), _t(sz0).to(cuda_device)
        parts = torch.full(arrays[4].shape, -1, dtype=torch.int32,
                           device=cuda_device)
        if fn is ops.parsa_scan:
            fn(*arrays, s, sz, parts)
        else:
            fn(*arrays, s, sz, parts)
        out.append((parts, s, sz))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_refine_scan_equals_plain_version(cuda_device):
    rng = np.random.default_rng(4)
    words = _t(rng.integers(0, 2**32, (3, 16, 2), dtype=np.uint64).astype(
        np.uint32).view(np.int32)).to(cuda_device)
    prev = torch.full((3, 64), -1, dtype=torch.int32, device=cuda_device)
    cost = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    for got, want in zip(ops.refine_scan(words, prev, cost, 2),
                         refine_scan_ref(words, prev, cost, 2)):
        assert torch.equal(got, want)
