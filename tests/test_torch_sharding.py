"""The port's sharding rules (``launch/sharding.py``, the rules of
``models/shardctx.py``) against the JAX package's, with no ranks.

Every registered configuration at full size, on stand-in meshes with the
production shapes (16, 16) and (2, 16, 16) and the test shape (2, 2):
every leaf of ``param_pspecs`` (the reference's leading scan dims dropped:
the port holds a list of layers there), ``opt_pspecs``, ``batch_specs``
and ``cache_specs`` of every applicable shape, and ``activation_rules``,
held equal to JAX's element by element.  Parameter trees are shapes only:
JAX's ``eval_shape`` and the port's model on the meta device.

``shard_params``' blocks on meshes (1, 4), (2, 2) and (16, 16), at every
place, against ``NamedSharding(mesh, param_pspecs(...))
.devices_indices_map`` computed by JAX on 256 forced host devices in one
subprocess, the FSDP cut over ``data`` included; ``Model.init(keep=)``
(the blocks drawn a leaf at a time) against the whole tree cut, and the
data axis's gather plan (``fsdp_plan``, ``shardctx.Fsdp``).
"""
import os
import pathlib
import re
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
    the expert weights over both axes, and with ``fsdp=True`` the dense
    weights too: over the model axis as tensor parallelism reads them and
    over data where their spec names it (FSDP)."""
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
    # dense tensor parallelism: the attention heads and the vocab rows are
    # cut over the model axis; FSDP: d_model over data (place 1 of 2 holds
    # rows 32..63 of 64); the norms stay whole
    wq = params["stack"][0]["attn"]["wq"]
    assert torch.equal(mine["stack"][0]["attn"]["wq"], wq[32:, :2])
    assert torch.equal(mine["embed"], params["embed"][:128, 32:])
    assert torch.equal(mine["lm_head"], params["lm_head"][32:, :128])
    assert mine["final_norm"]["scale"] is params["final_norm"]["scale"]
    rows = TS.batch_rows(mesh, TS.activation_rules(cfg, mesh, 4), 4,
                         coords=dict(data=1, model=1))
    assert rows == slice(2, 4)
    np.testing.assert_array_equal(
        [TS.batch_rows(mesh, {"batch": None}, 3, dict(data=1, model=0))
         .stop], [3])


BLOCK_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "16x16": (16, 16)}

_JAX_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.launch import sharding as JS
from repro.models.model import build_model

archs, meshes, out_path = json.loads(sys.argv[1])
devs = np.asarray(jax.devices())
out = {}
for arch in archs:
    cfg = get_config(arch)
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for name, shape in meshes.items():
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                    ("data", "model"))
        specs = jax.tree_util.tree_flatten_with_path(
            JS.param_pspecs(cfg, shapes, mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        for (kp, leaf), (_, spec) in zip(leaves, specs):
            idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            arr = np.zeros((mesh.devices.size, len(leaf.shape), 2), np.int64)
            for i, dev in enumerate(mesh.devices.flat):
                for d, sl in enumerate(idx[dev]):
                    arr[i, d] = sl.indices(leaf.shape[d])[:2]
            out[f"{arch}|{name}|{JS._path_str(kp)}"] = arr
np.savez(out_path, **out)
print("JAX_BLOCKS_DONE")
"""


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    """{arch|mesh|reference path: (places, dims, 2) start and stop}: JAX's
    blocks of every parameter at every place (row-major over the mesh)."""
    import json

    import torch_dist_ranks as R

    out = tmp_path_factory.mktemp("blocks") / "blocks.npz"
    R.run_jax(_JAX_BLOCKS, json.dumps([ARCHS, BLOCK_MESHES, str(out)]),
              "JAX_BLOCKS_DONE", devices=256)
    return dict(np.load(out))


@pytest.mark.parametrize("mesh_name", list(BLOCK_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_blocks_match_jax(jax_blocks, arch, mesh_name):
    """Each place's block of every parameter under ``shard_params``'s cut
    (``shard_spec``, ``block_slices``) is JAX's ``NamedSharding`` block of
    the same leaf (its per-layer dims; the stacked layer dims whole),
    the data axis's cut (FSDP) included: MLA's, the mLSTM's, the sLSTM's
    and Mamba2's leaves too."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    dm, mm = BLOCK_MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape={"data": dm, "model": mm},
                                 axis_names=("data", "model"))
    sizes = dict(mesh.shape)
    jspecs = _jax_leaves(JS.param_pspecs(jcfg, _jax_params(arch), mesh),
                         is_leaf=_is_spec)
    cut_over_model = 0
    for path, leaf in tree_leaves_with_path(_port_params(arch)):
        key = TS._path_str(path, keep_index=False)
        lead = sum(isinstance(k, int) for k in path)
        want_all = jax_blocks[f"{arch}|{mesh_name}|{key}"]
        spec = TS.shard_spec(cfg, key, tuple(leaf.shape), mesh)
        for place in range(dm * mm):
            coords = {"data": place // mm, "model": place % mm}
            got = TS.block_slices(tuple(leaf.shape), spec, sizes, coords)
            want = want_all[place]
            assert all(tuple(w) == (0, jshape) for w, jshape in zip(
                want[:lead], want_all[0, :lead, 1])), key
            want = [tuple(int(v) for v in w) for w in want[lead:]]
            assert list(got) == want, (key, coords, got, want)
        cut_over_model += "model" in spec
    if mm > 1:
        assert cut_over_model > 0


# the recurrent and MLA roles of ``tp_layout``: leaf (its key's end) ->
# (role, the dim the role cuts); a role True cuts that dim
_CUT_ROLES = {
    "attn/wq_b": ("mla", 1), "attn/wk_b": ("mla", 1),
    "attn/wv_b": ("mla", 1),
    "mlstm/cell/wv": ("mlstm", 2), "mlstm/cell/wz": ("mlstm", 2),
    "mlstm/cell/out_norm": ("mlstm", 1), "mlstm/cell/wo": ("mlstm", 1),
    "slstm/cell/wo": ("slstm", 1),
    "mamba/cell/wz": ("ssm", 1), "mamba/cell/wx": ("ssm", 1),
    "mamba/cell/w_dt": ("ssm", 1), "mamba/cell/dt_bias": ("ssm", 0),
    "mamba/cell/A_log": ("ssm", 0), "mamba/cell/D_skip": ("ssm", 0),
    "mamba/cell/conv_x": ("ssm", 1), "mamba/cell/out_norm": ("ssm", 0),
}
# leaves that every role leaves whole (the layers compute them whole)
_WHOLE = ("attn/wq_a", "attn/wkv_a", "attn/q_a_norm", "attn/kv_a_norm",
          "mlstm/cell/wq", "mlstm/cell/wk", "mlstm/cell/w_i",
          "mlstm/cell/w_f", "mamba/cell/wB", "mamba/cell/wC",
          "mamba/cell/conv_B", "mamba/cell/conv_C")


def _cache_cut(cfg, mesh, name, shape, dim) -> bool:
    tree = {name: torch.empty(shape, device="meta")}
    return TS.cache_specs(cfg, tree, mesh)[name][dim] is not None


@pytest.mark.parametrize("mesh_name", list(BLOCK_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_layout_agrees_with_the_blocks(arch, mesh_name):
    """``tp_layout``, which the layers read, says of every attention
    (MLA's too), MLP, ``embed``, ``lm_head``, mLSTM, sLSTM and Mamba2
    leaf the cut that ``shard_params`` makes of it over the model axis
    (``shard_spec``; the data axis's cut, FSDP, is gathered back before
    a layer reads a leaf), and of the KV cache, MLA's latent cache, the
    mLSTM C, the SSM state and the conv windows the cut that
    ``cache_specs`` makes; the leaves the layers compute whole are whole
    over the model axis."""
    cfg = get_config(arch)
    dm, mm = BLOCK_MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape={"data": dm, "model": mm},
                                 axis_names=("data", "model"))
    sizes = dict(mesh.shape)
    coords = {"data": 0, "model": 0}
    lay = TS.tp_layout(cfg, mesh)
    roles = {"attn/wq": ("q", 1), "attn/wk": ("kv", 1), "attn/wv": ("kv", 1),
             "attn/wo": ("o", 0), "xattn/wq": ("q", 1),
             "xattn/wk": ("kv", 1), "xattn/wv": ("kv", 1),
             "xattn/wo": ("o", 0), "mamba/cell/wo": ("ssm_o", 0)}
    seen = set()
    for path, leaf in tree_leaves_with_path(_port_params(arch)):
        key = TS._path_str(path, keep_index=False)
        shape = tuple(leaf.shape)
        over_model = tuple(None if a == "data" else a for a in
                           TS.shard_spec(cfg, key, shape, mesh))
        block = [b - a for a, b in TS.block_slices(
            shape, over_model, sizes, coords)]
        tail = "/".join(key.split("/")[-2:])
        tail3 = "/".join(key.split("/")[-3:])
        if tail3 in roles or tail in roles:
            role, h = roles[tail3 if tail3 in roles else tail]
            want = ("heads" if block[h] < shape[h]
                    else "hd" if block[h + 1] < shape[h + 1] else None)
            assert lay[role] == want, (key, block, lay)
            seen.add(role)
        elif tail3 in _CUT_ROLES or tail in _CUT_ROLES:
            role, d = _CUT_ROLES[tail3 if tail3 in _CUT_ROLES else tail]
            assert lay[role] == (block[d] < shape[d]), (key, block, lay)
            assert all(block[i] == shape[i] for i in range(len(shape))
                       if i != d), (key, block)
            seen.add(role)
        elif tail3 in _WHOLE or tail in _WHOLE:
            assert block == list(shape), (key, block)
        elif tail in ("mlp/wd", "shared/wd"):
            assert lay[tail.split("/")[0]] == (block[0] < shape[0]), key
            seen.add(tail.split("/")[0])
        elif key == "embed":
            assert lay["embed"] == (block[0] < shape[0])
            if cfg.tie_embeddings:
                assert lay["head"] == lay["embed"]
        elif key == "lm_head":
            assert lay["head"] == (block[1] < shape[1])
    if cfg.mla:
        assert "cache" not in lay
        assert lay["latent"] == _cache_cut(
            cfg, mesh, "c_kv", (1, 1, 1, cfg.kv_lora_rank), 3)
        assert lay["rope"] == _cache_cut(
            cfg, mesh, "k_rope", (1, 1, 1, cfg.rope_head_dim), 3)
        assert {"mla", "o"} <= seen, (arch, seen)
    elif cfg.family != "xlstm":
        spec = TS.cache_specs(cfg, {"k": torch.empty(
            (1, 1, 1, cfg.num_kv_heads, cfg.head_dim), device="meta")},
            mesh)["k"]
        assert lay["cache"] == ("heads" if spec[3] else "hd" if spec[4]
                                else None)
    cache = TM.Model(cfg, "meta").init_cache(1, 1)
    if cfg.family == "xlstm":
        assert not {"q", "kv", "o", "cache"} & set(lay), lay
        assert lay["mlstm"] == (TS.cache_specs(cfg, cache, mesh)["m"][0][4]
                                is not None)
        assert {"mlstm", "slstm"} <= seen, (arch, seen)
    if cfg.family == "hybrid":
        specs = TS.cache_specs(cfg, cache, mesh)
        assert lay["ssm"] == (specs["ssm"][3] is not None)
        assert lay["conv_x"] == (specs["conv"]["x"][4] is not None)
        assert lay["conv_bc"] == (specs["conv"]["B"][4] is not None) == \
            (specs["conv"]["C"][4] is not None)
        assert {"ssm", "ssm_o", "q", "kv", "o"} <= seen, (arch, seen)
    if cfg.family in ("dense", "vlm", "encdec"):
        assert {"q", "kv", "o", "mlp"} <= seen, (arch, seen)


# one configuration of each family, its weights cut over data
_KEEP_ARCHS = ("command-r-35b", "deepseek-v2-236b", "whisper-medium",
               "internvl2-76b", "xlstm-350m", "zamba2-2.7b")


@pytest.mark.parametrize("arch", _KEEP_ARCHS)
def test_init_keep_draws_the_blocks(arch):
    """``Model.init(seed, keep=keep_blocks(...))``, each leaf cut right
    after its draw, gives every place of (2, 2) the blocks of
    ``shard_params(cfg, init(seed))`` bit for bit: the generator makes
    the same calls in the same order.  The data axis cuts every leaf
    its spec names it in (``fsdp=True``), and ``keep`` sees each path
    once."""
    cfg = get_config(arch).reduced(fsdp=True)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model"))
    model = TM.Model(cfg, "cpu")
    whole = model.init(3, master=True)
    n_cut = 0
    for place in range(4):
        coords = {"data": place // 2, "model": place % 2}
        want = TS.shard_params(cfg, whole, mesh, coords=coords)
        seen = []
        keep = TS.keep_blocks(cfg, mesh, coords)

        def spy(path, t, keep=keep, seen=seen):
            seen.append(tuple(path))
            return keep(path, t)

        got = model.init(3, master=True, keep=spy)
        assert len(seen) == len(set(seen)) == len(tree_leaves_with_path(
            whole))
        for (pg, g), (pw, w), (_, t) in zip(tree_leaves_with_path(got),
                                            tree_leaves_with_path(want),
                                            tree_leaves_with_path(whole)):
            assert pg == pw and g.dtype == w.dtype, (pg, pw)
            assert torch.equal(g, w), pg
            n_cut += g.numel() < t.numel()
    assert n_cut > 0


@pytest.mark.parametrize("arch", _KEEP_ARCHS)
def test_fsdp_plan_names_the_dense_leaves_cut_over_data(arch):
    """``fsdp_plan`` lists each dense leaf whose spec names ``data``, with
    that dim, the place's block shape and the dtype the layers read it in
    (the serving tree's); the experts are the MoE layer's; a config
    without ``fsdp``, or a data axis of one place, cuts nothing."""
    cfg = get_config(arch).reduced(fsdp=True)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model"))
    plan = TS.fsdp_plan(cfg, mesh)
    serving = {TS._path_str(p, keep_index=False): t for p, t in
               tree_leaves_with_path(TM.Model(cfg, "meta").init())}
    want = {}
    for key, t in serving.items():
        spec = TS.shard_spec(cfg, key, tuple(t.shape), mesh)
        if "data" in spec and not re.search(r"moe/(wg|wu|wd)$", key):
            block = TS.block_slices(tuple(t.shape), spec, mesh.shape,
                                    {"data": 1, "model": 1})
            want[key] = (spec.index("data"),
                         tuple(b - a for a, b in block), t.dtype)
    assert plan == want and plan
    assert TS.fsdp_plan(get_config(arch).reduced(), mesh) == {}
    one = types.SimpleNamespace(shape={"data": 1, "model": 4},
                                axis_names=("data", "model"))
    assert TS.fsdp_plan(cfg, one) == {}


def test_fsdp_gather_refuses_a_whole_leaf():
    """A place handed a whole weight where the data axis's plan says it
    holds a block raises (``shardctx.Fsdp``), as the experts' check
    does, before any gather: it would otherwise read the weight wrong
    without a word."""
    cfg = get_config("command-r-35b").reduced(fsdp=True)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                 axis_names=("data", "model"))
    calls = []
    fs = TC.Fsdp(TS.fsdp_plan(cfg, mesh),
                 gather=lambda w, dim, dt: calls.append(dim) or w,
                 lookup=lambda b, t, dt: calls.append("lookup") or b[t])
    whole = TM.Model(cfg, "cpu").init(0)
    with pytest.raises(ValueError, match="stack/attn/wq is cut over the "
                       "data axis"):
        fs(whole["stack"][0], "stack")
    with pytest.raises(ValueError, match="embed is cut"):
        fs.lookup(whole["embed"], torch.zeros(2, dtype=torch.long), "embed",
                  torch.float32)
    mine = TS.shard_params(cfg, whole, mesh, coords={"data": 1, "model": 0})
    fs(mine["stack"][0], "stack")
    assert calls and not any(c == "lookup" for c in calls)


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
