"""The train step over a (data x model) ``DeviceMesh`` with FSDP of the
dense weights (``fsdp=True``): every dim a parameter's spec names
``data`` cut over the data axis (``launch.sharding.fsdp_plan``), each
block of parameters gathered whole over data where a layer reads it
(``launch.mesh.gather_weight``, the embedding looked up from its d_model
blocks by ``lookup_cut``), its gradient reduce-scattered in rank order in
the backward, and the batch-axes sum skipping the data axis for it.

``launch.steps.make_train_step(cfg, "cpu", mesh=)`` on the blocks of
``launch.sharding.shard_params``, two steps from the JAX ``init_state``'s
weights (the one-valued vectors perturbed, so that a wrong slice shows),
against the JAX package's jitted ``make_train_step(cfg, mesh)`` on 4
forced host devices (the parameters placed by its ``param_pspecs``, the
same cut), the same seeded global batches (B = 4, S = 8; each config's
own microbatches).  One 4-rank gloo group runs every case of
``torch_dist_train_cases.FSDP`` once for the module, beside two JAX
subprocesses that share the cases (``torch_dist_train_cases.start``).  Cases, each
``reduced(fsdp=True)``: command-r-35b on (2, 2) and (4, 1) (the tied
embed, layernorm, 2 microbatches on (2, 2)), nemotron-4-340b (squared
ReLU, an untied ``lm_head``, bf16 moments), mixtral-8x22b (the experts
and the router over data), deepseek-v2-236b (MLA's ranks over data, a
shared expert), internvl2-76b (patches), xlstm-350m and zamba2-2.7b.

Tolerances, those of ``tests/test_torch_dist_train.py``: each rank's
loss and grad_norm of each step within 1e-5 relative of JAX's; its
blocks of m and v after step 1 and of the parameters after step 2
within 1e-5 relative L2 over the rank's blocks (bf16 moments within
2**-8); the VLM's and the recurrent families' within 4 times JAX's own
distance to its runs from weights moved by half an ulp, floored at 1e-5
and capped at 1e-2.  Every rank equals rank 0's in-process emulation of
its place (``launch.mesh.emulate_mesh``) bit for bit, every leaf that
several ranks hold (``launch.sharding.replica_axes``: the norms over
data) is equal bit for bit on them after every step, and the FSDP
gathers and reduce-scatters are counted under their own keys.
"""
import numpy as np
import pytest

import torch_dist_train_cases as T

NAMES = T.FSDP


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each rank's arrays); JAX in two subprocesses."""
    return T.start(tmp_path_factory.mktemp("dist_fsdp"), NAMES, jax_procs=2)


@pytest.mark.parametrize("rank", range(T.WORLD))
@pytest.mark.parametrize("name", NAMES)
def test_fsdp_train_steps_match_jax(runs, name, rank):
    jax_out, ranks = runs
    rows = T.against_jax(name, jax_out, T.fields(ranks[rank], name), rank)
    for what, err, bound in rows:
        assert err <= bound, (name, rank, what, err, bound)


@pytest.mark.parametrize("rank", range(T.WORLD))
def test_fsdp_ranks_equal_the_emulation_bit_for_bit(runs, rank):
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
def test_fsdp_replicated_leaves_equal_on_every_rank(runs, name):
    ranks = runs[1]
    groups_of = T.replicas(name)
    assert any(groups_of.values()), name
    for leaf, groups in groups_of.items():
        for step in range(1, T.STEPS + 1):
            key = f"{name}/p{step}/{leaf}"
            for g in groups:
                for r in g[1:]:
                    assert np.array_equal(ranks[r][key], ranks[g[0]][key]), \
                        (key, g)


@pytest.mark.parametrize("name", NAMES)
def test_fsdp_blocks_are_cut_over_data(runs, name):
    """Each rank holds its blocks over data (the embedding's d_model
    among them), never the whole weight: the leaves' sizes a rank add up
    to less than the whole tree's over the model axis alone."""
    import torch

    from repro_torch.launch.sharding import fsdp_plan
    from repro_torch.models.model import Model

    cfg = T.cfg_of(name)
    shape = T.CASES[name]["mesh"]
    plan = fsdp_plan(cfg, T.stand_in(shape))
    assert "embed" in plan and any(k.startswith("stack/") for k in plan)
    got = T.fields(runs[1][0], name)
    shapes = {k: v.shape for k, v in got.items() if k.startswith("p2/")}
    whole = Model(cfg, torch.device("meta")).init(master=True)
    assert shapes["p2/embed"][1] == whole["embed"].shape[1] // shape[0]


def test_fsdp_gathers_are_counted_apart(runs):
    """The FSDP gathers of the forward ("fsdp_bytes") and the ordered
    reduce-scatters of the backward ("fsdp_bwd_bytes") are counted under
    their own keys on every rank; remat (none here) reruns nothing."""
    for name in NAMES:
        for rank in runs[1]:
            got = T.fields(rank, name)
            assert got["step0/gathered_fsdp_bytes"] > 0, name
            assert got["step0/gathered_fsdp_calls"] > 0, name
            assert got["step0/gathered_fsdp_bwd_bytes"] > 0, name
            assert got["step0/gathered_remat_bytes"] == 0, name
