"""Algorithm 4 across processes: the port's ``parallel_device`` with one
worker a rank of a ``torch.distributed`` group, against the JAX package.

One 4-rank gloo group (``spawn``, a ``file://`` store under ``tmp_path``,
one intra-op thread a rank) runs every case of
``torch_dist_ranks.dist_cases`` once for the module, while JAX
``parallel_device`` at 4 workers runs the same graphs on 8 forced host
devices in a subprocess.  Held bit for bit (tolerance 0: the program is
integer): ``parts_u``, ``s_masks``, ``parts_v``, the metrics and the
traffic counters on every rank; every rank against every other; the
sketched route and two parallel ``StreamSession`` feeds and a repair
against the in-process route; a group of one rank against
``device_scan``; the refusals; ``launch.mesh`` against JAX's meshes.  The
NCCL route at world size 1 needs a card and skips here."""
import json

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.api import ParsaConfig, partition
from repro_torch.core import partition as tp
from repro_torch.launch import mesh as M

WORLD = 4

_JAX_SCRIPT = r"""
import json, os, sys
import jax, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.api import ParsaConfig, partition
from repro.graphs import ctr_like, text_like
from repro.launch import mesh as M

facade, meshes, out_path = json.loads(sys.argv[1])
gen = {"text": text_like, "ctr": ctr_like}
out = {}
for name, ((kind, gkw), ckw) in facade.items():
    r = partition(gen[kind](**gkw),
                  ParsaConfig(backend="parallel_device", **ckw))
    for f in ("parts_u", "s_masks", "parts_v"):
        out[f"{name}/{f}"] = getattr(r, f)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        out[f"{name}/m_{f}"] = getattr(r.metrics, f)
    for f in ("pushed_bytes", "pulled_bytes", "tasks", "stale_pushes_missed",
              "migration_bytes"):
        out[f"{name}/t_{f}"] = getattr(r.traffic, f)
for spec in meshes:
    os.environ["REPRO_MESH"] = spec
    m = M.make_production_mesh()
    assert m.devices.size == 4, m
    out[f"mesh{spec}/names"] = np.asarray(m.axis_names)
    out[f"mesh{spec}/shape"] = np.asarray([m.shape[a] for a in m.axis_names])
    out[f"mesh{spec}/name"] = np.asarray(M.mesh_name(m))
    out[f"mesh{spec}/dp_axes"] = np.asarray(M.dp_axes(m), dtype=str)
    out[f"mesh{spec}/tp_axis"] = np.asarray(M.tp_axis(m))
    out[f"mesh{spec}/dp_size"] = np.int64(M.dp_size(m))
np.savez(out_path, **out)
print("JAX_DIST_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays): the JAX subprocess and the four
    ranks run side by side, once for the module."""
    tmp = tmp_path_factory.mktemp("dist")
    jax_proc = R.start_jax(_JAX_SCRIPT, json.dumps(
        [R.FACADE, list(R.MESHES), str(tmp / "jax.npz")]))
    try:
        ranks = R.run_ranks(R.dist_cases, WORLD, tmp / "ranks")
    finally:
        R.finish_jax(jax_proc, "JAX_DIST_DONE")
    return dict(np.load(tmp / "jax.npz")), ranks


def _fields(arrays: dict, prefix: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for f in want:
        assert np.array_equal(got[f], want[f]), f"{what}: {f}"


# --------------------------------------------- 4 ranks against JAX at 4 workers
@pytest.mark.parametrize("name", list(R.FACADE))
def test_group_partition_matches_jax(runs, name):
    jax_out, ranks = runs
    want = _fields(jax_out, name)
    (kind, _), ckw = R.FACADE[name]
    for r, got in enumerate(ranks):
        _same({f: v for f, v in _fields(got, name).items()
               if f in want}, want, f"{name} rank {r}")
    res = _fields(ranks[0], name)
    sizes = np.bincount(res["parts_u"], minlength=ckw["k"])
    assert sizes.max() - sizes.min() <= WORLD
    assert res["t_stale_pushes_missed"] > 0
    if kind == "ctr":
        assert (res["s_masks"] < 0).any()   # words with bit 31 set


@pytest.mark.parametrize("name", list(R.FACADE))
def test_group_gathers_are_counted(runs, name):
    """One scan dispatch and one ``parallel_merge_gather`` dispatch a
    partition, the latter with the bytes a rank receives: the sets and
    sizes of every rank at each merge, and the parts once."""
    gspec, ckw = R.FACADE[name]
    g = R.make_graph(gspec)
    B, m, k = ckw["block_size"], ckw["merge_every"], ckw["k"]
    nb_per = -(-(-(-g.num_u // B)) // WORLD)
    nb_per = -(-nb_per // m) * m
    W = (g.num_v + 31) // 32
    want = 4 * WORLD * (nb_per // m * (k * W + k) + nb_per * B)
    for got in runs[1]:
        assert int(got[f"{name}/scan_dispatches"]) == 1
        assert int(got[f"{name}/gather_dispatches"]) == 1
        assert int(got[f"{name}/gather_bytes"]) == want


@pytest.mark.parametrize("rank", range(1, WORLD))
def test_every_rank_returns_the_same(runs, rank):
    ranks = runs[1]
    _same(ranks[rank], ranks[0], f"rank {rank} against rank 0")


# --------------------------------------------- against the in-process route
def test_group_sketch_equals_in_process(runs):
    """``set_repr="sketch"`` (held to JAX in test_torch_parallel.py)."""
    gspec, ckw = R.SKETCH
    want = R.result_arrays(partition(
        R.make_graph(gspec), ParsaConfig(backend="parallel_device", **ckw),
        device="cpu"), "sketch")
    for r, got in enumerate(runs[1]):
        _same(_fields(got, "sketch"), _fields(want, "sketch"),
              f"sketch rank {r}")


def test_group_stream_feeds_equal_in_process(runs):
    """Two shuffled parallel feeds (the second weighted toward workers 1
    and 3) and an explicit repartition: parts, metrics, live state,
    traffic and the repair's plan; the group route's feeds count one
    ``parallel_merge_gather`` dispatch more."""
    want = R.stream_run(None)
    for r, got in enumerate(runs[1]):
        got = _fields(got, "stream")
        for i in range(len(R.STREAM_CUTS) - 1):
            key = f"feed{i}/dispatches"
            d = list(got.pop(key))
            assert "parallel_merge_gather=1" in d, d
            d.remove("parallel_merge_gather=1")
            assert d == list(want[key]), (d, want[key])
        _same(got, {f: v for f, v in want.items()
                    if not f.endswith("/dispatches")}, f"stream rank {r}")
    assert want["feed0/traffic"][0] > 0 and want["feed1/traffic"][0] > 0


def test_group_of_one_equals_device_scan(runs):
    for r, got in enumerate(runs[1]):
        one = {f: v for f, v in _fields(got, "w1").items()
               if not f.startswith("t_")}
        _same(one, _fields(got, "w1_scan"), f"one-rank group, rank {r}")
        assert int(got["w1/t_stale_pushes_missed"]) == 0


# --------------------------------------------- refusals
def test_group_size_mismatch_raises_before_packing(runs):
    for got in runs[1]:
        for key, workers in (("err/size_partition", 2),
                             ("err/size_impl", 8), ("err/size_stream", 2)):
            msg = str(got[key])
            assert f"has {WORLD} ranks but the scan has {workers}" in msg, \
                (key, msg)


def test_group_needs_parallel_device(runs):
    for got in runs[1]:
        assert "needs backend='parallel_device'" in str(got["err/backend"])
        assert "needs base.backend='parallel_device'" in str(
            got["err/backend_stream"])


def test_ranks_with_different_permutations_refuse(runs):
    for got in runs[1]:
        assert "different block→worker plans" in str(got["err/perm"])


def test_resolve_worker_group_checks_size():
    class Group:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    tp.resolve_worker_group(3, Group(3))
    for n in (2, 4):
        with pytest.raises(ValueError, match=f"has {n} ranks"):
            tp.resolve_worker_group(3, Group(n))


# --------------------------------------------- launch.mesh
@pytest.mark.parametrize("spec", R.MESHES)
def test_mesh_matches_jax(runs, spec):
    jax_out, ranks = runs
    want = _fields(jax_out, f"mesh{spec}")
    for r, got in enumerate(ranks):
        _same(_fields(got, f"mesh{spec}"), want, f"mesh {spec} rank {r}")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("override", [None, "2,2", "2,2,2", "8"])
def test_mesh_shape_matches_jax(monkeypatch, multi_pod, override):
    """The shape and axis names JAX's ``make_production_mesh`` hands to
    ``jax.make_mesh`` (captured, so the 256-chip shapes need no devices)
    against ``mesh_shape``."""
    from repro.launch import mesh as JM

    seen = []
    monkeypatch.setattr(JM.jax, "make_mesh",
                        lambda shape, axes: seen.append((shape, axes)))
    if override is None:
        monkeypatch.delenv("REPRO_MESH", raising=False)
    else:
        monkeypatch.setenv("REPRO_MESH", override)
    JM.make_production_mesh(multi_pod=multi_pod)
    assert [M.mesh_shape(multi_pod=multi_pod)] == seen


# --------------------------------------------- the card (skipped here)
@pytest.mark.cuda
def test_nccl_group_of_one_equals_ungrouped(tmp_path):
    """A real NCCL group of one rank on the card: its gathers run, and the
    result equals the ungrouped route and ``device_scan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; NCCL has no CPU mode")
    out = R.run_ranks(R.nccl_one, 1, tmp_path, backend="nccl")[0]
    for ref in ("ungrouped", "scan"):
        _same({f: v for f, v in _fields(out, ref).items()
               if not f.startswith("t_")},
              {f: v for f, v in _fields(out, "nccl").items()
               if not f.startswith("t_")}, f"nccl x1 against {ref}")
    assert int(out["gather_dispatches"]) == 1
