"""Elastic Parsa over a ``torch.distributed`` group: the port's
``ElasticSession(..., group=)`` with one ``parallel_device`` worker a
rank, against the JAX package.

One 4-rank gloo group (``spawn``, a ``file://`` store under ``tmp_path``,
one intra-op thread a rank) runs every case of
``torch_dist_slices.elastic_cases`` once for the module, while JAX's
``ElasticSession`` at ``parallel_device`` with 4 workers replays the same
chaos script on 8 forced host devices in a subprocess.  Held bit for bit
(tolerance 0: the program is integer): after every feed the parts, the
live sets and sizes, the traffic, the straggler weights and ``k``; the
cold repair's parts and sets; every ``ElasticOp`` field but its seconds;
``result(refine_v=True)``; each against JAX, the in-process session at 4
workers and every other rank.  The group's feeds count one
``parallel_merge_gather`` dispatch more than JAX's.  In wall-clock mode
every rank holds the same weights.  Refusals: a group of the wrong size,
a group under ``device_scan``, ranks whose ops differ."""
import json

import numpy as np
import pytest

import torch_dist_ranks as R
import torch_dist_slices as S
from repro_torch import api, elastic, graphs

WORLD = 4

_JAX_SCRIPT = r"""
import sys
import jax, numpy as np
assert len(jax.devices()) == 8, jax.devices()
sys.path.insert(0, sys.argv[1].split("|")[0])
import torch_dist_slices as S
from repro import api, elastic, graphs
out = S.chaos_replay(api, elastic, graphs, base_extra={"use_kernel": False})
np.savez(sys.argv[1].split("|")[1], **out)
print("JAX_DIST_ELASTIC_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays, the in-process session's)."""
    tmp = tmp_path_factory.mktemp("dist_elastic")
    jax_proc = R.start_jax(_JAX_SCRIPT,
                           f"{R.ROOT / 'tests'}|{tmp / 'jax.npz'}")
    try:
        ranks = R.run_ranks(S.elastic_cases, WORLD, tmp / "ranks")
        local = S.chaos_replay(api, elastic, graphs, device="cpu")
    finally:
        R.finish_jax(jax_proc, "JAX_DIST_ELASTIC_DONE")
    return dict(np.load(tmp / "jax.npz")), ranks, local


def _fields(arrays: dict, prefix: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _without_gather(d: str) -> dict:
    counts = json.loads(str(d))
    assert counts.pop("parallel_merge_gather", 0) == 1, counts
    return counts


def _same(got: dict, want: dict, what: str, grouped: bool) -> None:
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for f in want:
        if f.endswith("/dispatches"):
            g = _without_gather(got[f]) if grouped else json.loads(
                str(got[f]))
            assert g == json.loads(str(want[f])), (what, f)
        elif f == "ops":
            assert json.loads(str(got[f])) == json.loads(str(want[f])), what
        else:
            assert np.array_equal(got[f], want[f]), f"{what}: {f}"


@pytest.mark.parametrize("rank", range(WORLD))
def test_group_chaos_replay_matches_jax(runs, rank):
    jax_out, ranks, _ = runs
    _same(_fields(ranks[rank], "chaos"), jax_out, f"rank {rank} vs JAX",
          grouped=True)


@pytest.mark.parametrize("rank", range(WORLD))
def test_group_chaos_replay_equals_in_process(runs, rank):
    _, ranks, local = runs
    _same(_fields(ranks[rank], "chaos"), local,
          f"rank {rank} vs in process", grouped=True)


def test_in_process_replay_matches_jax(runs):
    jax_out, _, local = runs
    _same(local, jax_out, "in process vs JAX", grouped=False)


def test_chaos_replay_ran_every_op(runs):
    """The script's adds, kills and the cold repair all committed, k
    8 -> 12, through grouped feeds (one gather dispatch each)."""
    _, ranks, _ = runs
    got = _fields(ranks[0], "chaos")
    ops = json.loads(str(got["ops"]))
    assert [(o[0], o[8]) for o in ops] == [
        ("grow", ""), ("grow", ""), ("repair", "warm"), ("grow", ""),
        ("grow", ""), ("repair", "warm"), ("repair", "cold")]
    assert all(o[1] for o in ops)
    assert int(got[f"feed{S.CHAOS_CHUNKS - 1}/k"]) == 12
    assert int(ranks[0]["chaos_gathers"]) > S.CHAOS_CHUNKS
    w = got["feed5/weights"]
    assert w.argmin() == 1 and w.max() == w[0]   # the straggler is lane 1


def test_wallclock_weights_agree_across_ranks(runs):
    """Measured walls differ by rank; the group feeds the EWMA their
    largest, so every rank holds the same weights (and plan)."""
    ranks = runs[1]
    base = _fields(ranks[0], "wall")
    for i in range(S.WALL_FEEDS):
        w = base[f"feed{i}/weights"]
        assert w.shape == (WORLD,) and np.isfinite(w).all() and (w > 0).all()
    for r in range(1, WORLD):
        got = _fields(ranks[r], "wall")
        for f in base:
            if not f.endswith("dispatches"):
                assert np.array_equal(got[f], base[f]), (r, f)


def test_group_of_one_equals_ungrouped(runs):
    """A one-rank group at one worker (no block shuffle) against the
    ungrouped one-worker session: every feed's state, the ops and the
    result equal; the steady-state traffic differs (the group route meters
    its merges as Algorithm 4 does, the one-worker feed meters none)."""
    for r, got in enumerate(runs[1]):
        one, ref = _fields(got, "w1"), _fields(got, "w1_ungrouped")
        assert set(one) == set(ref)
        for f in ref:
            if f.endswith(("/traffic", "/dispatches")):
                continue
            if f == "ops":
                assert json.loads(str(one[f])) == json.loads(str(ref[f]))
            else:
                assert np.array_equal(one[f], ref[f]), (r, f)
        assert "parallel_merge_gather" in str(one["feed0/dispatches"])


def test_group_refusals(runs):
    for got in runs[1]:
        assert f"has {WORLD} ranks but the scan has 2 workers" in str(
            got["err/size"])
        assert "needs base.backend='parallel_device'" in str(
            got["err/backend"])
        assert "different elastic states" in str(got["err/diverged"])


def test_jax_and_port_graphs_agree():
    from repro.graphs import text_like as j_text_like

    jg = j_text_like(**S.CHAOS_GRAPH)
    tg = graphs.text_like(**S.CHAOS_GRAPH)
    assert np.array_equal(np.asarray(jg.u_indptr), np.asarray(tg.u_indptr))
    assert np.array_equal(np.asarray(jg.u_indices), np.asarray(tg.u_indices))
