"""The list route of the port's ``sketch_select``: each row of a block as
its compact (word index, word) pairs, the form the scan keeps, with the
rows truncated past ``cap`` read from the dense block.  Its plain version
``sketch_select_rows_ref`` and the wrapper's ``rows=`` path are held to
the dense plain version ``sketch_select_ref`` and to the JAX
``sketch_cost_select``, bit for bit (tolerance 0: the program is
integer); the scans pass their lists to ``parsa_scan``, and the sketched
``partition()`` still equals JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.graphs import ctr_like as j_ctr_like
from repro.kernels import parsa_cost as jk
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import graph_from_numpy
from repro_torch.core import partition as tp
from repro_torch.kernels.parsa_cost import (
    BIG,
    ROWS_BUILT,
    compact_rows,
    ops,
    sketch_select_ref,
    sketch_select_rows_ref,
)

SKETCH_KW = dict(set_repr="sketch", sketch_hot_bits=1024,
                 sketch_bucket_bits=512)
WIDTH_WORDS = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(rng, B, cap):
    """A (B, WIDTH_WORDS) block of mixed rows, packed twice by the JAX
    package's packers: dense, and as compact lists of ``cap`` pairs.
    Rows cycle through: empty; a few words; more than ``cap`` words, each
    with bit 31 set (truncated, negative int32 words); under ``cap`` words
    with bit 31 set; and about ``cap`` words of random bits."""
    num_v = 32 * WIDTH_WORDS
    rows = []
    for u in range(B):
        kind = u % 5
        if kind == 0:
            cols = np.zeros(0, np.int64)
        elif kind == 1:
            cols = rng.choice(num_v, size=rng.integers(1, 8), replace=False)
        elif kind == 2:
            n = min(WIDTH_WORDS, cap + 1 + int(rng.integers(0, 5)))
            cols = 32 * rng.choice(WIDTH_WORDS, size=n, replace=False) + 31
        elif kind == 3:
            n = int(rng.integers(1, min(cap, WIDTH_WORDS) + 1))
            cols = 32 * rng.choice(WIDTH_WORDS, size=n, replace=False) + 31
        else:
            cols = rng.choice(num_v, size=rng.integers(10, max(11, 4 * cap)),
                              replace=False)
        rows.append(np.sort(cols))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate(rows).astype(np.int32)
    dense = jk.pack_bitmask(rows, num_v)
    _, _, widx, vals, trunc = jk.pack_bitmask_csr_sparse(
        indptr, indices, num_v, cap=cap)[:5]
    return dense, widx, vals, trunc


def _select_args(rng, B, k, retired_kind):
    if retired_kind == "some":
        retired = rng.random(B) < 0.3
    else:  # all but k - 3 rows: greedy rounds run out, slots come up empty
        retired = np.ones(B, bool)
        retired[rng.choice(B, size=k - 3, replace=False)] = False
    order = rng.permutation(k).astype(np.int32)
    enabled = rng.random(k) < 0.8
    return retired, order, enabled


@pytest.mark.parametrize("cap", [6, 48])
@pytest.mark.parametrize("retired_kind", ["some", "most"])
@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("B", [256, 1024])
def test_list_route_matches_dense_and_jax(B, k, greedy, retired_kind, cap):
    """sketch_select_rows_ref and sketch_cost_select(rows=) against the
    dense plain version and JAX sketch_cost_select, with truncated rows,
    bit-31 words, padding pairs, retired rows, disabled and empty slots.
    At cap=6 most rows are truncated; (B=1024, k=64) is past the kernel's
    shared-memory guard (on the card it routes to parsa_select)."""
    rng = np.random.default_rng(B + k + 2 * greedy + cap)
    dense, widx, vals, trunc = _block(rng, B, cap)
    assert trunc.any() and (~trunc).any()
    assert (vals == 0).any() and (vals < 0).any()
    s = jk.pack_bitmask(rng.random((k, 32 * WIDTH_WORDS)) < 0.15,
                        32 * WIDTH_WORDS)
    s[:, ::3] |= np.int32(-2**31)
    retired, order, enabled = _select_args(rng, B, k, retired_kind)
    jkw = dict(order=jnp.asarray(order),
               enabled=jnp.asarray(enabled)) if greedy else {}
    tkw = dict(order=_t(order), enabled=_t(enabled)) if greedy else {}
    want = jk.sketch_cost_select(jnp.asarray(dense), jnp.asarray(s),
                                 jnp.asarray(retired), use_kernel=False,
                                 **jkw)
    rows = (_t(widx), _t(vals), _t(trunc))
    got = ops.sketch_cost_select(_t(dense), _t(s), _t(retired), rows=rows,
                                 **tkw)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32 and g_.shape == (k,)
        assert np.array_equal(g_.numpy(), np.asarray(w_))
    u, c = sketch_select_rows_ref(_t(dense), *rows, _t(s), _t(retired),
                                  *tkw.values(), greedy=greedy)
    ud, cd = sketch_select_ref(_t(dense), _t(s), _t(retired), *tkw.values(),
                               greedy=greedy)
    assert torch.equal(u, ud) and torch.equal(c, cd)
    if greedy and retired_kind == "most":
        assert int((c == BIG).sum()) >= 3     # empty slots
        assert bool((u[c == BIG] == -1).all())


@pytest.mark.parametrize("cap", [1, 6, 48])
def test_compact_rows_equals_the_packer(cap):
    """The lists the wrapper builds from a dense block on the device are
    the scan's packer's: the first ``cap`` nonzero words in column order,
    padded with (0, 0), and the truncation flag."""
    rng = np.random.default_rng(cap)
    dense, widx, vals, trunc = _block(rng, 300, cap)
    w, v, t = compact_rows(_t(dense), cap)
    assert w.dtype == v.dtype == torch.int32 and t.dtype == torch.bool
    assert np.array_equal(w.numpy(), widx)
    assert np.array_equal(v.numpy(), vals)
    assert np.array_equal(t.numpy(), trunc)


def test_compact_rows_narrower_than_cap():
    """W < cap: every row fits, the lists are padded to ``cap``."""
    rng = np.random.default_rng(3)
    dense = rng.integers(-2**31, 2**31, size=(17, 5), dtype=np.int64).astype(
        np.int32)
    dense[::4] = 0
    w, v, t = compact_rows(_t(dense), 8)
    assert w.shape == v.shape == (17, 8) and not t.any()
    rebuilt = np.zeros_like(dense)
    np.add.at(rebuilt, (np.arange(17)[:, None], w.numpy()), v.numpy())
    assert np.array_equal(rebuilt, dense)


def test_rows_are_checked():
    rng = np.random.default_rng(0)
    dense, widx, vals, trunc = _block(rng, 64, 6)
    s = _t(np.zeros((4, WIDTH_WORDS), np.int32))
    retired = torch.zeros(64, dtype=torch.bool)
    bad = [
        ((_t(widx).long(), _t(vals), _t(trunc)), "widx"),
        ((_t(widx), _t(vals), _t(trunc).int()), "trunc"),
        ((_t(widx[:5]), _t(vals[:5]), _t(trunc[:5])), "rows must be"),
        ((_t(widx), _t(vals[:, :3]), _t(trunc)), "rows must be"),
    ]
    for rows, match in bad:
        with pytest.raises(ValueError, match=match):
            ops.sketch_cost_select(_t(dense), s, retired, rows=rows)


def _spy(monkeypatch):
    """Record, for every ``parsa_scan`` call of the sketched scans, that it
    was given the packed block stack's compact lists (not a dense block)
    and which blocks it scanned."""
    calls = []
    real = tp.parsa_scan

    def spy(widx, vals, tr_ids, tr_masks, valid, s, sizes, parts, *, b0=0,
            nblk=None, tr_lists=None):
        calls.append((widx.dim() == 4 and vals.shape == widx.shape
                      and tr_masks.shape[-1] == s.shape[-1], b0, nblk))
        return real(widx, vals, tr_ids, tr_masks, valid, s, sizes, parts,
                    b0=b0, nblk=nblk, tr_lists=tr_lists)

    monkeypatch.setattr(tp, "parsa_scan", spy)
    return calls


@pytest.mark.parametrize("backend", ["device_scan", "parallel_device"])
def test_sketched_scans_pass_their_lists_and_match_jax(monkeypatch, backend):
    """Both scans hand ``parsa_scan`` the block stack's lists: one call
    over every block for device_scan, one a super-step for
    parallel_device; the sketched partition equals JAX's (one worker of
    parallel_device is device_scan bit for bit)."""
    g = j_ctr_like(num_impressions=900, num_features=5000, nnz_per_row=60,
                   seed=3)
    base = dict(k=8, block_size=128, refine_backend="device", sweeps=2,
                seed=0, **SKETCH_KW)
    want = j_partition(g, JConfig(backend="device_scan", **base))
    calls = _spy(monkeypatch)
    extra = dict(workers=1, merge_every=2) if backend == "parallel_device" \
        else {}
    got = partition(graph_from_numpy(g.num_u, g.num_v, g.u_indptr,
                                     g.u_indices),
                    ParsaConfig(backend=backend, **base, **extra),
                    device="cpu")
    n_blocks = -(-g.num_u // 128)
    if backend == "device_scan":
        assert calls == [(True, 0, n_blocks)]
    else:
        assert calls == [(True, b, 2) for b in range(0, n_blocks, 2)]
    for f in ("parts_u", "s_masks", "parts_v"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_scan_truncation_flags_come_from_the_side_channel():
    """_trunc_flags marks exactly the packer's truncated rows of a block;
    the side channel's padding ids (== B) land in the sink."""
    g = graph_from_numpy(*(lambda h: (h.num_u, h.num_v, h.u_indptr,
                                      h.u_indices))(
        j_ctr_like(num_impressions=700, num_features=8000, nnz_per_row=70,
                   seed=1)))
    packed = tp.pack_graph_blocks(g, 128, cap=16)
    assert packed.trunc.any()
    for b in range(packed.valid.shape[0]):
        flags = tp._trunc_flags(_t(packed.tr_ids[b]), 128)
        assert np.array_equal(flags.numpy(), packed.trunc[b])


# --------------------------------------------- the card (skipped here)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [6, 48])
def test_cuda_list_route_equals_plain_versions(cuda_device, cap):
    """The kernel on the lists against both plain versions, and on the
    dense block alone (the wrapper builds the lists, counted in
    ROWS_BUILT)."""
    rng = np.random.default_rng(cap)
    for B, k in ((256, 16), (1024, 16), (256, 64)):
        dense, widx, vals, trunc = _block(rng, B, cap)
        s = _t(jk.pack_bitmask(rng.random((k, 32 * WIDTH_WORDS)) < 0.15,
                               32 * WIDTH_WORDS)).to(cuda_device)
        nbr = _t(dense).to(cuda_device)
        rows = tuple(_t(a).to(cuda_device) for a in (widx, vals, trunc))
        retired, order, enabled = (_t(a).to(cuda_device) for a in
                                   _select_args(rng, B, k, "some"))
        for kw, greedy in ((dict(order=order, enabled=enabled), True),
                           ({}, False)):
            before = (ops.LAUNCHES["sketch_select"],
                      ROWS_BUILT["sketch_select"])
            got = ops.sketch_cost_select(nbr, s, retired, rows=rows, **kw)
            built = ops.sketch_cost_select(nbr, s, retired, **kw)
            torch.cuda.synchronize()
            assert (ops.LAUNCHES["sketch_select"],
                    ROWS_BUILT["sketch_select"]) == (before[0] + 2,
                                                     before[1] + 1)
            u, c = sketch_select_rows_ref(nbr, *rows, s, retired,
                                          *kw.values(), greedy=greedy)
            ud, cd = sketch_select_ref(nbr, s, retired, *kw.values(),
                                       greedy=greedy)
            want = (u[0], c[0]) if greedy else (c[0], u[0])
            dwant = (ud[0], cd[0]) if greedy else (cd[0], ud[0])
            for g_, b_, w_, d_ in zip(got, built, want, dwant):
                assert torch.equal(g_, w_) and torch.equal(b_, d_)
                assert torch.equal(w_, d_)
