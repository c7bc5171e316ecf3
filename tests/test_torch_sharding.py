"""The port's sharding rules (``launch/sharding.py``, the rules of
``models/shardctx.py``) against the JAX package's, with no ranks.

Every registered configuration at full size, on stand-in meshes with the
production shapes (16, 16) and (2, 16, 16) and the test shape (2, 2):
every leaf of ``param_pspecs`` (the reference's leading scan dims dropped:
the port holds a list of layers there), ``opt_pspecs``, ``batch_specs``
and ``cache_specs`` of every applicable shape, and ``activation_rules``,
held equal to JAX's element by element.  Parameter trees are shapes only:
JAX's ``eval_shape`` and the port's model on the meta device.
"""
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import sharding as JS
from repro.models import model as JM
from repro.models import shardctx as JC
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import model as TM
from repro_torch.models import shardctx as TC
from repro_torch.tree import tree_leaves_with_path

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
ARCHS = list_configs()
_JAX_SHAPES: dict = {}
_PORT_PARAMS: dict = {}


def _stand_in(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _jax_params(arch):
    if arch not in _JAX_SHAPES:
        m = JM.build_model(jax_config(arch))
        _JAX_SHAPES[arch] = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    return _JAX_SHAPES[arch]


def _port_params(arch):
    if arch not in _PORT_PARAMS:
        _PORT_PARAMS[arch] = TM.Model(get_config(arch), "meta").init()
    return _PORT_PARAMS[arch]


def _jax_leaves(tree, is_leaf=None):
    """{reference path: leaf} of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {JS._path_str(kp): leaf for kp, leaf in flat}


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _port_spec_leaves(specs):
    """[(path, spec)] of a port spec tree: its tuples of axis entries are
    leaves, not nodes."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list) or (
                isinstance(t, tuple) and t and isinstance(t[0], tuple)
                and not all(isinstance(a, str) for a in t[0])):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))
    walk(specs, ())
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_pspecs_match_jax(arch, mesh_name):
    cfg, jcfg, mesh = get_config(arch), jax_config(arch), _stand_in(mesh_name)
    jshapes = _jax_leaves(_jax_params(arch))
    jspecs = _jax_leaves(JS.param_pspecs(jcfg, _jax_params(arch), mesh),
                         is_leaf=_is_spec)
    params = _port_params(arch)
    specs = TS.param_pspecs(cfg, params, mesh)
    seen = set()
    n = 0
    for path, leaf in tree_leaves_with_path(params):
        key = TS._path_str(path, keep_index=False)
        lead = sum(isinstance(k, int) for k in path)
        assert key in jspecs, key
        assert lead == JS._leading_scan_dims(key, jcfg), key
        assert tuple(leaf.shape) == tuple(jshapes[key].shape[lead:]), key
        spec = specs
        for k in path:
            spec = spec[k]
        want = tuple(jspecs[key])
        assert want[:lead] == (None,) * lead, key
        assert spec == want[lead:], (key, spec, want)
        seen.add(key)
        n += 1
    assert seen == set(jspecs), set(jspecs) ^ seen
    assert n >= len(jspecs)
    opt = TS.opt_pspecs(cfg, params, mesh)
    assert opt["m"] == specs and opt["v"] == specs and opt["step"] == ()
    assert tuple(JS.opt_pspecs(jcfg, _jax_params(arch), mesh)["step"]) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh_name):
    cfg, jcfg, mesh = get_config(arch), jax_config(arch), _stand_in(mesh_name)
    checked = 0
    for shape in TM.SHAPES:
        if not JM.shape_applicable(jcfg, shape)[0]:
            assert not TM.shape_applicable(cfg, shape)[0]
            continue
        jin = JM.input_specs(jcfg, shape)
        tin = TM.input_specs(cfg, shape)
        want = _jax_leaves(JS.batch_specs(jcfg, jin, mesh), is_leaf=_is_spec)
        got = dict((TS._path_str(p), s) for p, s in
                   _port_spec_leaves(TS.batch_specs(cfg, tin, mesh)))
        assert set(got) == set(want), (shape, set(got) ^ set(want))
        for k, w in want.items():
            assert got[k] == tuple(w), (shape, k, got[k], w)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_match_jax(arch, mesh_name):
    cfg, jcfg, mesh = get_config(arch), jax_config(arch), _stand_in(mesh_name)
    for batch in (1, 2, 4, 16, 32, 128, 256):
        assert TS.activation_rules(cfg, mesh, batch) == \
            JS.activation_rules(jcfg, mesh, batch), batch


def test_mixtral_rules_at_16x16():
    """The reference's production rules for mixtral-8x22b: 8 experts on
    16 model ranks do not divide, so the MoE layer takes the hidden-sharded
    branch there (and the expert-parallel one on (2, 2))."""
    cfg = get_config("mixtral-8x22b")
    assert TS.activation_rules(cfg, _stand_in("16x16"), 256) == {
        "batch": "data", "vocab": "model", "expert": None, "tp": "model",
        "fsdp": "data"}
    assert TS.activation_rules(cfg, _stand_in("2x2"), 2)["expert"] == "model"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_context_matches_jax(mesh_name):
    """``current_rules``, ``resolve`` and ``axis_size`` under
    ``logical_axis_rules`` equal JAX's; ``constrain`` is the identity
    (a rank already holds its shard)."""
    mesh = _stand_in(mesh_name)
    cfg, jcfg = get_config("mixtral-8x22b"), jax_config("mixtral-8x22b")
    rules = TS.activation_rules(cfg, mesh, 32)
    axes = [("batch", None, "vocab"), ("batch", None, None), ("tp",),
            ("fsdp", "expert"), (None,)]
    assert TC.current_rules() is None and TC.resolve(("batch",)) is None
    assert TC.axis_size("tp") == 1
    with TC.logical_axis_rules(mesh, rules), \
            JC.logical_axis_rules(mesh, JS.activation_rules(jcfg, mesh, 32)):
        assert TC.current_rules()[1] == JC.current_rules()[1]
        for a in axes:
            assert TC.resolve(a) == tuple(JC.resolve(a)), a
        for name in ("batch", "vocab", "expert", "tp", "fsdp", "none"):
            assert TC.axis_size(name) == JC.axis_size(name), name
        x = torch.ones(2, 3)
        assert TC.constrain(x, "batch", None) is x
    assert TC.current_rules() is None
    assert axis_sizes(mesh) == dict(mesh.shape)


def test_shard_tree_cuts_the_rank_block():
    """``shard_tree`` gives each place the block of a ``NamedSharding``
    (row-major over a dim's axes, the first major); ``shard_params`` cuts
    only the expert weights."""
    mesh = _stand_in("2x16x16")
    sizes = dict(mesh.shape)
    t = torch.arange(4 * 32 * 6).reshape(4, 32, 6)
    spec = (None, ("pod", "data"), None)
    blocks = [TS.shard_tree({"w": t}, {"w": spec}, mesh,
                            coords=dict(pod=p, data=d, model=0))["w"]
              for p in range(2) for d in range(16)]
    assert all(b.shape == (4, 1, 6) for b in blocks)
    assert torch.equal(torch.cat(blocks, dim=1), t)
    b = TS.shard_tree({"w": t}, {"w": ("data", None, None)},
                      _stand_in("2x2"), coords=dict(data=1, model=0))["w"]
    assert torch.equal(b, t[2:]) and b.untyped_storage().data_ptr() != \
        t.untyped_storage().data_ptr()
    cfg = get_config("mixtral-8x22b").reduced(fsdp=True)
    params = TM.Model(cfg, "cpu").init(0)
    mesh = _stand_in("2x2")
    mine = TS.shard_params(cfg, params, mesh, coords=dict(data=1, model=0))
    moe, full = mine["stack"][0]["moe"], params["stack"][0]["moe"]
    assert torch.equal(moe["wg"], full["wg"][:2, :, 64:])
    assert torch.equal(moe["wd"], full["wd"][:2, 64:, :])
    assert mine["stack"][0]["attn"]["wq"] is params["stack"][0]["attn"]["wq"]
    assert mine["embed"] is params["embed"]
    rows = TS.batch_rows(mesh, TS.activation_rules(cfg, mesh, 4), 4,
                         coords=dict(data=1, model=1))
    assert rows == slice(2, 4)
    np.testing.assert_array_equal(
        [TS.batch_rows(mesh, {"batch": None}, 3, dict(data=1, model=0))
         .stop], [3])


def test_new_modules_import_no_jax_or_repro():
    """The rules, the placement, the mesh groups and the grouped elastic
    session load neither JAX nor the reference package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.launch.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.steps, "
            "repro_torch.models.shardctx, repro_torch.models.moe, "
            "repro_torch.elastic.session;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
