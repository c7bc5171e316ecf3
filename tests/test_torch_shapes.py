"""The reference's workload shapes and roofline arithmetic in the port
(``repro_torch.models.model``: ``SHAPES``, ``shape_applicable``,
``input_specs``; ``repro_torch.launch.roofline``) against the JAX
package's, for every registered configuration.  Everything is integer or
a closed-form float: tolerance 0."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_configs as jax_list
from repro.launch import mesh as JMESH
from repro.launch import roofline as JR
from repro.models import model as JM
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import roofline as TR
from repro_torch.models import model as TM
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list_configs()
_DT = {torch.int32: jnp.int32, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}


def test_registry_and_shapes_are_jax_s():
    assert ARCHS == jax_list() and len(ARCHS) == 10
    assert TM.SHAPES == JM.SHAPES
    with pytest.raises(KeyError):
        TM.shape_applicable(get_config("qwen3-14b"), "decode_1m")


def _as_jax(tree):
    """A port tree of meta tensors as a tree of ``jax.ShapeDtypeStruct`` in
    the JAX layout: every list (per layer, per group) stacked on a new
    leading axis, dicts and tuples kept."""
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return jax.ShapeDtypeStruct(tuple(tree.shape), _DT[tree.dtype])
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_jax(v) for v in tree)
    if isinstance(tree, list):
        items = [_as_jax(v) for v in tree]
        return jax.tree.map(lambda *xs: jax.ShapeDtypeStruct(
            (len(xs),) + xs[0].shape, xs[0].dtype), *items)
    raise TypeError(type(tree))


@pytest.mark.parametrize("shape", list(JM.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    """``shape_applicable`` and, leaf for leaf, the paths, shapes and
    dtypes of ``input_specs`` against JAX's ``ShapeDtypeStruct`` tree; all
    on the meta device (``decode_32k`` is B=128 x 32,768)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert TM.shape_applicable(cfg, shape) == JM.shape_applicable(jcfg, shape)
    got = TM.input_specs(cfg, shape)
    want = JM.input_specs(jcfg, shape)
    gl = jax.tree.leaves_with_path(_as_jax(got))
    wl = jax.tree.leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == \
        [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), \
            jax.tree_util.keystr(path)
    if JM.SHAPES[shape]["kind"] == "decode":
        assert got["pos"].shape == () and got["pos"].dtype == torch.int32
        if cfg.swa_window and shape == "long_500k" and not cfg.mla:
            assert got["cache"]["kpos"].shape[1] == cfg.swa_window


def test_input_specs_allocate_nothing():
    cfg = get_config("nemotron-4-340b")
    spec = TM.input_specs(cfg, "decode_32k")
    k = spec["cache"]["k"]
    assert k.device.type == "meta" and k.shape[:3] == (
        cfg.num_layers, 128, 32768)
    assert k.numel() * k.element_size() > 1e12     # a terabyte, not made


# ------------------------------------------------------------------ roofline
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    got, want = TR.count_params(cfg), JR.count_params(jcfg)
    assert got == want and all(isinstance(v, float) for v in got)
    for info in JM.SHAPES.values():
        assert TR.model_flops(cfg, info, *got) == \
            JR.model_flops(jcfg, info, *want)
    red = TR.count_params(cfg.reduced())
    assert red == JR.count_params(jcfg.reduced())


def test_roofline_as_dict_matches_jax(monkeypatch, tmp_path):
    """``Roofline`` with the port's ``HW`` set to the JAX table, at
    compute-, memory- and collective-bound inputs; ``save_report`` writes
    what JAX's writes."""
    monkeypatch.setattr(TR, "HW", dict(JMESH.HW))
    coll = {"all-reduce": {"wire_bytes": 2.5e9, "count": 3}}
    rows = []
    for flops, nbytes, wire, chips in ((4e15, 1e11, 0.0, 1),
                                       (1e12, 8e11, 1e8, 4),
                                       (1e12, 1e9, 5e11, 256),
                                       (0.0, 0.0, 0.0, 1)):
        kw = dict(arch="qwen3-14b", shape="train_4k", mesh="16x16",
                  chips=chips, flops_per_device=flops,
                  bytes_per_device=nbytes, wire_bytes_per_device=wire,
                  collectives=coll, model_flops=3.3e15,
                  peak_memory_per_device=7.5e10)
        got, want = TR.Roofline(**kw).as_dict(), JR.Roofline(**kw).as_dict()
        assert got == want
        rows.append(got)
    assert {r["bottleneck"] for r in rows} == {"compute", "memory",
                                               "collective"}
    TR.save_report(str(tmp_path / "a.json"), rows)
    JR.save_report(str(tmp_path / "b.json"), rows)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()


def test_hw_is_the_h100():
    assert TR.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                     "ici_bw": 900e9}
    r = TR.Roofline("qwen3-14b", "decode_32k", "1", 1, 1e12, 3.35e12, 0.0,
                    {}, 1e12, 0.0)
    assert r.t_memory == 1.0 and r.t_collective == 0.0
    assert r.bottleneck == "memory"


# the leaves count_params leaves out: norm scales and biases, the
# recurrent cells' per-head vectors and the Mamba2 conv weights
_UNCOUNTED = {"scale", "bias", "bq", "bk", "bv", "bi", "bd", "q_norm",
              "k_norm", "q_a_norm", "kv_a_norm", "b_f", "b_i", "b_o", "b_z",
              "out_norm", "A_log", "D_skip", "dt_bias", "conv_x", "conv_B",
              "conv_C"}


def _matrices(p) -> int:
    return sum(v.numel() for k, v in p.items() if k not in _UNCOUNTED)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_against_count_params(arch):
    """The built reduced model's ``param_count`` against ``count_params``
    (the reference's arithmetic, equal to JAX's): the gap is the leaves it
    leaves out (``_UNCOUNTED``), less what it counts twice: an
    encoder layer as two attentions (whisper), and the hybrid's
    weight-tied attention layer and MLP once a group."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg, "cpu").init(0)
    left_out = sum(leaf.numel() for path, leaf in
                   tree_leaves_with_path(params) if path[-1] in _UNCOUNTED)
    twice = 0
    if cfg.family == "encdec":
        twice = cfg.encoder_layers * _matrices(params["enc"][0]["attn"])
    if cfg.family == "hybrid":
        shared = params["stack"]["shared_attn"]
        twice = (cfg.num_layers // cfg.hybrid_group - 1) * (
            _matrices(shared["attn"]) + _matrices(shared["mlp"]))
    total, active = TR.count_params(cfg)
    n = build_model(cfg, "cpu").param_count(params)
    assert n == int(total) + left_out - twice, (n, total, left_out, twice)
    assert left_out > 0
    assert active <= total
    if cfg.num_experts:
        assert active < total
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_config(arch).reduced())


def test_new_modules_import_no_jax_or_repro():
    """The roofline arithmetic and the elementwise kernels load neither
    JAX nor the JAX package, in a fresh process."""
    code = ("import sys, repro_torch.launch.roofline, "
            "repro_torch.kernels.elementwise, repro_torch.models.model; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
