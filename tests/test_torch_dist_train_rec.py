"""The train step over a (data x model) ``DeviceMesh``: the recurrent
families (xlstm, hybrid) and pure data parallelism.

As ``tests/test_torch_dist_train.py`` (its docstring has the setup and
the tolerances), for ``torch_dist_train_cases.RECURRENT``: qwen3-14b and
mixtral-8x22b on (4, 1) (the batch split 4 ways; the MoE's local route
gathers every place's tokens over the batch axes); xlstm-350m at one
group (n_m = 3) and at ``xlstm_group=3`` (n_m = 2), each on (1, 4) and
(2, 2) (the mLSTM value dim, the sLSTM ``wo`` rows); zamba2-2.7b on (1,
4) and (2, 2) (Mamba2's heads, the shared attention).  The recurrent
cases' gradient-derived quantities are held within 4 times JAX's own
half-ulp spread (floored at 1e-5, capped at 1e-2).
"""
import numpy as np
import pytest

import torch_dist_train_cases as T

NAMES = T.RECURRENT


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each rank's arrays)."""
    return T.start(tmp_path_factory.mktemp("dist_train_rec"), NAMES)


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


def test_the_gradient_sum_over_data_is_gathered(runs):
    """Pure data parallelism gathers only the loss's sums and the
    gradients (one ordered sum of them all, flattened) in the forward
    path's counter, and nothing in the backward: no model axis to enter."""
    for name in ("qwen_4x1",):
        for rank in runs[1]:
            got = T.fields(rank, name)
            assert got["step0/gathered_bwd_bytes"] == 0, name
            assert got["step0/gathered_bytes"] > 0, name
