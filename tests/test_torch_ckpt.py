"""The port's checkpoints and checkpointed training loop against the JAX
package's (mirrors ``tests/test_fault.py``'s restart, atomicity and
reshard tests).

The restart is bitwise: a run that fails at step 6 and resumes from its
step-6 checkpoint ends with the same bits as an uninterrupted run.  A
checkpoint directory the JAX package's ``TrainLoop`` wrote restores in the
port with the reference's exact arrays, and the next step's loss and
parameters agree with the JAX run's within 1e-5 (float32, sums in another
order)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMData as JData
from repro.launch.steps import make_train_step as j_make_train
from repro.runtime import FaultConfig as JFault
from repro.runtime import TrainLoop as JLoop
from repro_torch.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax_checkpoint
from repro_torch.data import SyntheticLMData
from repro_torch.launch.steps import make_train_step
from repro_torch.runtime import FaultConfig, SimulatedFailure, TrainLoop
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map
from test_torch_train import TOL, _np, _rel, _rel_l2


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-14b").reduced()
    model, train_step, init_state, _ = make_train_step(cfg, "cpu")
    data = SyntheticLMData(cfg.vocab_size, 2, 16, seed=3)
    return cfg, train_step, init_state, data


def _batches(data, lo, hi):
    return [data.batch_at(t) for t in range(lo, hi)]


def _same_bits(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x.cpu(), y.cpu()), path


def test_restart_bitwise_exact(setup, tmp_path):
    cfg, train_step, init_state, data = setup
    # uninterrupted reference
    p_ref, o_ref = init_state(0)
    for b in _batches(data, 0, 8):
        p_ref, o_ref, _ = train_step(p_ref, o_ref, b)

    # run with failure injected at step 6, checkpoints every 2
    fault = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2, fail_at_step=6)
    loop = TrainLoop(train_step, fault)
    p, o = init_state(0)
    with pytest.raises(SimulatedFailure):
        loop.run(p, o, _batches(data, 0, 8))
    # recover: resume from the latest checkpoint and replay the data stream
    step = latest_step(tmp_path)
    assert step == 6
    fault2 = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2)
    loop2 = TrainLoop(train_step, fault2)
    start, p2, o2 = loop2.resume_or(lambda: init_state(0))
    assert start == 6
    p2, o2, _ = loop2.run(p2, o2, _batches(data, start, 8), start_step=start)
    _same_bits(p_ref, p2)
    _same_bits(o_ref, o2)
    assert latest_step(tmp_path) == 8
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_atomic_and_gc(tmp_path):
    tree = {"w": torch.arange(10.0), "nested": {"b": torch.ones((3, 3))}}
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, tree)
    assert latest_step(tmp_path) == 4
    out = restore_checkpoint(tmp_path, 4, tree)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(10.0))
    # tmp dirs never linger
    assert not list(tmp_path.glob("*.tmp"))
    # a save cut short leaves only its .tmp, which latest_step ignores
    (tmp_path / "step_9.tmp").mkdir()
    assert latest_step(tmp_path) == 4
    # garbage collection down to ``keep`` complete checkpoints, as the
    # reference's manager leaves them (blocking saves: an async save that
    # is still in flight when the manager collects is not yet counted)
    from repro.ckpt import CheckpointManager as JManager
    names = []
    for Manager, t, sub in ((CheckpointManager, tree, "m"),
                            (JManager, {"w": jnp.arange(10.0)}, "j")):
        mgr = Manager(tmp_path / sub, every=2, keep=2)
        assert [mgr.maybe_save(s, t, blocking=True)
                for s in range(1, 9)] == [False, True] * 4
        names.append(sorted(p.name for p in (tmp_path / sub).iterdir()))
    assert names[0] == names[1] == ["step_6", "step_8"]


def test_async_save_copies_to_the_host_before_the_thread(tmp_path):
    """A step that updates the parameters in place right after a
    non-blocking save does not tear the checkpoint."""
    tree = {"p": torch.arange(1000.0), "s": torch.tensor(3, dtype=torch.int32)}
    t = save_checkpoint(tmp_path, 1, tree, blocking=False)
    tree["p"].add_(1.0)
    tree["s"].add_(1)
    t.join()
    out = restore_checkpoint(tmp_path, 1, tree)
    np.testing.assert_array_equal(out["p"].numpy(), np.arange(1000.0))
    assert int(out["s"]) == 3 and out["s"].dtype == torch.int32


def test_format_is_the_reference_format(tmp_path):
    """``step_<n>/manifest.json`` and ``shard_0.npz`` with ``::`` keys: the
    port's files read with ``np.load``, bf16 as its 16-bit patterns under
    the manifest dtype ``bfloat16``; the JAX package's files restore in
    the port, its bf16 leaves included."""
    tree = {"a": [torch.arange(4.0).reshape(2, 2),
                  {"m": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}],
            "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path, 5, tree)
    man = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert man["step"] == 5 and man["format"] == 1
    assert man["arrays"] == {
        "a::0": {"shape": [2, 2], "dtype": "float32"},
        "a::1::m": {"shape": [2], "dtype": "bfloat16"},
        "step": {"shape": [], "dtype": "int32"}}
    data = np.load(tmp_path / "step_5" / "shard_0.npz")
    np.testing.assert_array_equal(data["a::0"], [[0, 1], [2, 3]])
    assert data["step"].shape == () and int(data["step"]) == 7
    assert data["a::1::m"].view(np.uint16).tolist() == [0x3FC0, 0xC000]
    _same_bits(restore_checkpoint(tmp_path, 5, tree), tree)

    from repro.ckpt import save_checkpoint as j_save
    j_save(tmp_path / "j", 2, {"w": jnp.arange(6.0).reshape(2, 3),
                               "h": jnp.asarray([0.5, 3.0], jnp.bfloat16)})
    like = {"w": torch.zeros(2, 3), "h": torch.zeros(2, dtype=torch.bfloat16)}
    out = restore_checkpoint(tmp_path / "j", 2, like)
    assert out["h"].dtype == torch.bfloat16
    assert out["h"].tolist() == [0.5, 3.0]
    np.testing.assert_array_equal(out["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    with pytest.raises(KeyError, match="missing array"):
        restore_checkpoint(tmp_path / "j", 2, {"x": torch.zeros(1)})


def _reshard_roundtrip(tmp_path, device):
    """Save on the CPU, restore onto ``device`` (the reference restores
    onto other shardings): the same values, on ``device``, from real like
    leaves and from ``meta`` ones."""
    tree = {"w": torch.arange(16.0).reshape(4, 4),
            "o": {"m": torch.ones(3, dtype=torch.bfloat16)}}
    save_checkpoint(tmp_path, 1, tree)
    for like, kw in ((tree, {"device": device}),
                     (tree_map(lambda t: t.to("meta"), tree),
                      {"device": device})):
        out = restore_checkpoint(tmp_path, 1, like, **kw)
        for x in tree_leaves(out):
            assert x.device.type == torch.device(device).type
        _same_bits(out, tree)


def test_elastic_reshard_roundtrip(tmp_path):
    _reshard_roundtrip(tmp_path, "cpu")


def test_resume_onto_a_device_and_in_place(setup, tmp_path):
    """``TrainLoop(device=...)`` restores onto that device; without one,
    into the tensors ``init_fn`` built (no second copy)."""
    cfg, train_step, init_state, data = setup
    loop = TrainLoop(train_step, FaultConfig(ckpt_dir=str(tmp_path),
                                             ckpt_every=1))
    p, o = init_state(0)
    p, o, _ = loop.run(p, o, _batches(data, 0, 1))
    built = []

    def init_fn():
        built.append(init_state(0))
        return built[-1]

    start, p1, o1 = loop.resume_or(init_fn)
    assert start == 1 and p1 is built[-1][0] and o1 is built[-1][1]
    _same_bits(p1, p)
    _same_bits(o1, o)
    loop_dev = TrainLoop(train_step, FaultConfig(ckpt_dir=str(tmp_path)),
                         device="cpu")
    _, p2, o2 = loop_dev.resume_or(init_fn)
    assert p2 is not built[-1][0]
    _same_bits(p2, p)
    _same_bits(o2, o)


@pytest.mark.parametrize("arch", ["qwen3-14b", "nemotron-4-340b"])
def test_jax_checkpoint_restores_in_port(arch, tmp_path):
    """The JAX package's ``TrainLoop`` trains 2 steps and checkpoints;
    ``convert.train_state_from_jax_checkpoint`` maps its stacked ``stack``
    keys onto the port's per-layer list: the arrays equal the JAX state's
    (nemotron-4-340b's bf16 moments bit for bit), and the next step's
    loss, grad_norm and parameters equal the JAX run's within 1e-5."""
    jc = jax_config(arch).reduced(microbatches=1)
    tc = get_config(arch).reduced(microbatches=1)
    _, jstep, jinit, _ = j_make_train(jc)
    jstep = jax.jit(jstep)
    data = JData(jc.vocab_size, 2, 16, seed=4)
    jb = [{k: jnp.asarray(v) for k, v in data.batch_at(t).items()}
          for t in range(3)]
    loop = JLoop(jstep, JFault(ckpt_dir=str(tmp_path), ckpt_every=2))
    jp, jo = jinit(jax.random.PRNGKey(0))
    jp, jo, _ = loop.run(jp, jo, jb[:2])
    step, tp, to = train_state_from_jax_checkpoint(tc, tmp_path,
                                                   device="cpu")
    assert step == 2 and int(to["step"]) == 2
    assert to["step"].dtype == torch.int32
    md = getattr(torch, tc.opt_dtype)
    assert all(x.dtype == md for x in tree_leaves(to["m"]))
    assert all(x.dtype == torch.float32 for x in tree_leaves(tp))
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(
                jax.tree.map(lambda x: np.asarray(x, np.float32), want))):
            np.testing.assert_array_equal(a, b)
    _, tstep, _, _ = make_train_step(tc, "cpu")
    jp, jo, jm = jstep(jp, jo, jb[2])
    tp, to, tm = tstep(tp, to, data.batch_at(2))
    assert _rel(tm["loss"], jm["loss"]) <= TOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= TOL
    assert _rel_l2(_np(tp), jax.tree.map(np.asarray, jp)) <= TOL


def test_port_checkpoint_state_resumes_in_the_port(setup, tmp_path):
    """The port's own checkpoint of a training state restores into the
    structure ``init_state`` builds, every leaf's dtype kept (int32 step,
    float32 masters and moments)."""
    cfg, train_step, init_state, data = setup
    p, o = init_state(0)
    p, o, _ = train_step(p, o, data.batch_at(0))
    save_checkpoint(tmp_path, 1, {"params": p, "opt": o})
    keys = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert "params::stack::1::attn::wq" in keys["arrays"]
    assert keys["arrays"]["opt::step"] == {"shape": [], "dtype": "int32"}
    like = dict(zip(("params", "opt"), init_state(1)))
    out = restore_checkpoint(tmp_path, 1, like)
    _same_bits(out["params"], p)
    _same_bits(out["opt"], o)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_elastic_reshard_roundtrip_onto_the_card(cuda_device, tmp_path):
    _reshard_roundtrip(tmp_path, cuda_device)
