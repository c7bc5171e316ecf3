"""The train step over a (data x model) ``DeviceMesh``: the dense, MoE,
MLA, encoder-decoder and VLM families.

``launch.steps.make_train_step(cfg, "cpu", mesh=)`` on the blocks of
``launch.sharding.shard_params``, two steps from the JAX ``init_state``'s
weights (the one-valued vectors perturbed, so that a wrong slice shows),
against the JAX package's jitted ``make_train_step(cfg, mesh)`` on 4
forced host devices (the parameters placed by its ``param_pspecs``), the
same seeded global batches (B = 4, S = 8; each config's own
microbatches).  One 4-rank gloo group (``spawn``, a ``file://`` store,
one intra-op thread a rank) runs every case of
``torch_dist_train_cases.DENSE`` once for the module, beside the JAX
subprocess (``torch_dist_train_cases.start``).  Cases: qwen3-14b on (2,
2) and (1, 4) (k and v cut by head_dim), codeqwen1.5-7b (biases, MHA),
a head_dim cut of q and o with the score reduced over head_dim, context
parallel, mixtral-8x22b on (2, 2) (expert parallel), deepseek-v2-236b on
(1, 4) (MLA and MoE, bf16 moments), whisper-medium with frames,
internvl2-76b with patches, and one case with ``grad_compress=True``.

Tolerances: each rank's loss and grad_norm of each step within 1e-5
relative of JAX's; its blocks of m and v after step 1 (the gradients,
scaled) and of the parameters after step 2 within 1e-5 relative L2 over
the rank's blocks (bf16 moments within 2**-8, one bf16 step, as
``tests/test_torch_train.py``); the VLM's within 4 times JAX's own
distance to its runs from weights moved by half an ulp, floored at 1e-5
and capped at 1e-2 (``tests/torch_lm_family.py``: its gradients are
steeper than float32's last bit in JAX itself).  Every rank equals rank
0's in-process emulation of its place (``launch.mesh.emulate_mesh``) bit
for bit, and every leaf that several ranks hold
(``launch.sharding.replica_axes``) is equal bit for bit on them after
every step.
"""
import numpy as np
import pytest

import torch_dist_train_cases as T

NAMES = T.DENSE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each rank's arrays)."""
    return T.start(tmp_path_factory.mktemp("dist_train"), NAMES)


@pytest.mark.parametrize("rank", range(T.WORLD))
@pytest.mark.parametrize("name", NAMES)
def test_train_steps_over_mesh_match_jax(runs, name, rank):
    jax_out, ranks = runs
    rows = T.against_jax(name, jax_out, T.fields(ranks[rank], name), rank)
    for what, err, bound in rows:
        assert err <= bound, (name, rank, what, err, bound)


@pytest.mark.parametrize("rank", range(T.WORLD))
def test_ranks_equal_the_emulation_bit_for_bit(runs, rank):
    ranks = runs[1]
    for name in NAMES:
        want = T.fields(ranks[0], f"emu{rank}/{name}")
        got = T.fields(ranks[rank], name)
        assert set(got) == set(want) and want, name
        for k in want:
            if "/gathered_" in k:
                continue     # counted over a process group only
            assert np.array_equal(got[k], want[k]), (name, rank, k)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_equal_on_every_rank(runs, name):
    ranks = runs[1]
    for leaf, groups in T.replicas(name).items():
        for step in range(1, T.STEPS + 1):
            key = f"{name}/p{step}/{leaf}"
            for g in groups:
                for r in g[1:]:
                    assert np.array_equal(ranks[r][key], ranks[g[0]][key]), \
                        (key, g)


def test_backward_gathers_are_counted_apart(runs):
    """Over a cut model axis the backward gathers (``enter``'s ordered
    sums) and the forward's are counted under their own keys; without
    remat nothing is rerun."""
    for name in NAMES:
        for rank in runs[1]:
            got = T.fields(rank, name)
            assert got["step0/gathered_bytes"] > 0, name
            assert got["step0/gathered_bwd_bytes"] > 0, name
            assert got["step0/gathered_remat_bytes"] == 0, name
