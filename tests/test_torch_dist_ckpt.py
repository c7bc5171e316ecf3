"""Checkpoints of a train state over a (data x model) ``DeviceMesh``: the
port's counterpart of the reference's ``TrainLoop(..., shardings=)``.

One 4-rank gloo group (``torch_dist_ranks.run_ranks``) runs
``torch_dist_ckpt_cases.ckpt_cases`` once for the module, beside one JAX
subprocess on 4 forced host devices whose ``TrainLoop`` (its jitted
``make_train_step(cfg, mesh)`` on a (2, 2) mesh of Auto axes) writes a
checkpoint that the ranks restore.  Cases: the reduced qwen3-14b, the
reduced command-r-35b with ``fsdp=True`` (blocks cut over data too) and
the reduced xlstm-350m (one group of 3 mLSTM blocks and an sLSTM), each
saved over (2, 2) from ``launch.train.build``'s state cut to the
rank's blocks.

  * A save over the mesh writes the logical arrays: its ``shard_0.npz``
    members and its manifest are byte for byte those of a save of the
    whole tree without a mesh.
  * ``TrainLoop(mesh=)`` failing at step 3 of 4 (checkpoints every 2)
    and resumed on the same mesh ends with every rank's blocks bit for
    bit those of an uninterrupted run, restored in place.
  * The (2, 2) checkpoint of step 2 restored on (1, 4), on (4, 1) and
    without a mesh: every block bit-equal to the cut of the logical
    arrays (read from the npz), and the next step's loss and grad_norm
    within 1e-5 relative, and its parameters within 1e-5 relative L2,
    of the no-mesh route's at the same microbatch count
    (``tests/test_torch_dist_train.py``'s tolerance for the dense
    families; the xLSTM case's float32 quantities hold it too).
  * JAX's checkpoint of its mesh run restores into the port's (2, 2)
    ranks through ``convert.train_state_from_jax_checkpoint``; the next
    step is within the same tolerance of JAX's next step after its own
    ``TrainLoop(shardings=)`` restore.
"""
import json
import zipfile

import numpy as np
import pytest

import torch_dist_ckpt_cases as C
import torch_dist_train_cases as T

NAMES = tuple(C.CASES)
TOL = T.TOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's next step, each rank's arrays, the checkpoints' root)."""
    return C.start(tmp_path_factory.mktemp("dist_ckpt"))


def _logical(name, root):
    """The step-``EVERY`` checkpoint's logical arrays as the whole state's
    tree (numpy), read member by member from its npz."""
    from repro_torch.ckpt.checkpoint import read_arrays
    from repro_torch.tree import tree_map_with_path

    arrays, _ = read_arrays(root / name / "loop", C.EVERY)
    like = C._state(C.cfg_of(name), 1)
    return tree_map_with_path(lambda p, _: arrays["::".join(map(str, p))],
                              like)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_save_is_the_whole_save(runs, name):
    root = runs[2] / name
    mesh = root / "mesh0" / "step_0"
    whole = root / "whole0" / "step_0"
    assert (mesh / "manifest.json").read_text() == \
        (whole / "manifest.json").read_text()
    with zipfile.ZipFile(mesh / "shard_0.npz") as a, \
            zipfile.ZipFile(whole / "shard_0.npz") as b:
        assert a.namelist() == b.namelist()
        assert a.namelist()
        for member in a.namelist():
            assert a.read(member) == b.read(member), member
    assert not list(root.glob("*/*.tmp"))


@pytest.mark.parametrize("rank", range(C.WORLD))
@pytest.mark.parametrize("name", NAMES)
def test_resume_on_the_same_mesh_is_bitwise(runs, name, rank):
    got = C.fields(runs[1][rank], name)
    assert bool(got["raised"]) and int(got["start"]) == C.EVERY
    assert bool(got["in_place"])
    want = C.fields(got, "uninterrupted")
    resumed = C.fields(got, "resumed")
    assert set(resumed) == set(want) and want
    for k in want:
        assert resumed[k].dtype == want[k].dtype, k
        assert np.array_equal(resumed[k], want[k]), k
    timings = json.loads(str(got["timings"]))
    assert timings["step"] == C.EVERY and timings["gather_s"] >= 0
    if rank == 0:
        assert timings["bytes"] > 0 and timings["write_s"] >= 0


@pytest.mark.parametrize("rank", range(C.WORLD))
@pytest.mark.parametrize("shape", C.REMESH)
@pytest.mark.parametrize("name", NAMES)
def test_restore_onto_another_mesh_is_the_cut(runs, name, shape, rank):
    tag = "x".join(map(str, shape))
    got = C.fields(C.fields(runs[1][rank], name), f"restored/{tag}")
    want = C.cut(name, _logical(name, runs[2]), shape, rank)
    assert set(got) == set(want) and want
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_restore_without_a_mesh_is_the_logical_state(runs, name):
    from repro_torch.tree import tree_leaves_with_path

    got = C.fields(C.fields(runs[1][0], name), "restored/none")
    want = {"/".join(map(str, p)): v for p, v in
            tree_leaves_with_path(_logical(name, runs[2]))}
    assert set(got) == set(want) and want
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k


@pytest.mark.parametrize("rank", range(C.WORLD))
@pytest.mark.parametrize("shape", C.REMESH)
@pytest.mark.parametrize("name", NAMES)
def test_next_step_after_a_remesh_matches_no_mesh(runs, name, shape, rank):
    from repro_torch.tree import tree_map_with_path

    tag = "x".join(map(str, shape))
    got = C.fields(runs[1][rank], f"{name}/next/{tag}")
    ref = C.fields(runs[1][0],
                   f"{name}/next/none{C.microbatches(name, shape)}")
    for k in ("loss", "grad_norm"):
        assert T.rel(got[k], ref[k]) <= TOL, (k, got[k], ref[k])
    whole = C.fields(ref, "params")
    like = C._state(C.cfg_of(name), 1)["params"]
    tree = {"params": tree_map_with_path(
        lambda p, _: whole["/".join(map(str, p))], like)}
    want = C.cut(name, tree, shape, rank)
    mine = {k: v for k, v in got.items() if k.startswith("params/")}
    assert T.rel_l2(mine, want) <= TOL


@pytest.mark.parametrize("rank", range(C.WORLD))
def test_jax_mesh_checkpoint_restores_into_the_ranks(runs, rank):
    jax_out, ranks, _ = runs
    got = C.fields(ranks[rank], "jax")
    assert int(got["step"]) == C.JAX_STEPS
    for k in ("loss", "grad_norm"):
        assert T.rel(got[k], jax_out[k]) <= TOL, (k, got[k], jax_out[k])
    # the reduced qwen3-14b on (2, 2): torch_dist_train_cases' own case
    want = T.jax_blocks("qwen_2x2", jax_out["params"], "params", rank)
    mine = {k: v for k, v in got.items() if k.startswith("params/")}
    assert T.rel_l2(mine, want) <= TOL
