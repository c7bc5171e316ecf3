"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's compiled steps.

One JAX subprocess on 4 forced host devices lowers and compiles
(``repro.launch.dryrun.lower_and_compile``, a ``jax.sharding.Mesh`` of
Auto axes passed in directly) the reduced config of each family at each
applicable shape on mesh (2, 2), and two of them on (1, 2, 2); the
port's ``memory.argument_bytes`` and ``memory.output_bytes`` equal the
compiled module's ``argument_size_in_bytes`` and
``output_size_in_bytes`` exactly.  ``status``, ``reason``,
``params_total``, ``params_active`` and ``model_flops`` equal JAX's
``shape_applicable``, ``count_params`` and ``model_flops`` for every
registered config and shape.  ``python -m repro_torch.launch.dryrun
--all --both-meshes`` ends with ``fail=0`` and loads neither ``jax`` nor
``repro``.  On an emulated (2, 2) mesh a place's ``held`` terms equal
the bytes it holds after ``Model.init(keep=)``, ``init_opt_state`` and
``Model.init_cache`` under the mesh's rules."""
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

import torch_dist_ranks as R
from repro_torch.configs import get_config, list_configs
from repro_torch.launch.dryrun import NO_ANALOGUE, run_cell

# family -> (arch, the reduced config's overrides)
FAMILIES = {
    "dense": ("qwen3-14b", {}),
    "dense_fsdp": ("command-r-35b", {"fsdp": True}),
    "moe": ("mixtral-8x22b", {}),
    "mla": ("deepseek-v2-236b", {}),
    "xlstm": ("xlstm-350m", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("internvl2-76b", {}),
}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CELLS = [(fam, shape, (2, 2)) for fam in FAMILIES for shape in SHAPES]
CELLS += [("dense", "train_4k", (1, 2, 2)), ("moe", "decode_32k", (1, 2, 2))]

JAX_SCRIPT = r"""
import json, pickle, sys
import jax, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.models.model import shape_applicable

cells, families, out_path = json.loads(sys.argv[1])
out = {}
for fam, shape, mesh in cells:
    arch, over = families[fam]
    cfg = get_config(arch).reduced(**over)
    if not shape_applicable(cfg, shape)[0]:
        continue
    names = ("pod", "data", "model")[-len(mesh):]
    # Auto axes, passed in directly (not make_production_mesh)
    m = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(mesh), names)
    out[f"{fam}/{shape}/{mesh}"] = D._mem_analysis_dict(
        D.lower_and_compile(cfg, shape, m))
pickle.dump(out, open(out_path, "wb"))
print("JAX_DRYRUN_DONE")
"""


def _cfg(fam):
    arch, over = FAMILIES[fam]
    return get_config(arch).reduced(**over)


@pytest.fixture(scope="module", autouse=True)
def jax_run(tmp_path_factory):
    """JAX's compiles, started with the module: the tests that need no
    JAX run meanwhile, those that compare with it come last."""
    out = tmp_path_factory.mktemp("dryrun") / "jax.pkl"
    proc = R.start_jax(JAX_SCRIPT, json.dumps(
        [[[f, s, list(m)] for f, s, m in CELLS], FAMILIES, str(out)]),
        devices=4)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_mem(jax_run):
    proc, out = jax_run
    R.finish_jax(proc, "JAX_DRYRUN_DONE", timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_configs())
def test_status_and_model_arithmetic_equal_jax(arch, shape):
    from repro.configs import get_config as jax_config
    from repro.launch.roofline import count_params, model_flops
    from repro.models.model import SHAPES as JSHAPES
    from repro.models.model import shape_applicable

    jc = jax_config(arch)
    ok, reason = shape_applicable(jc, shape)
    for multi_pod, mname in ((False, "16x16"), (True, "2x16x16")):
        cell = run_cell(arch, shape, multi_pod, verbose=False)
        assert cell["arch"] == arch and cell["shape"] == shape
        assert cell["mesh"] == mname
        if not ok:
            assert cell["status"] == "skip" and cell["reason"] == reason
            continue
        assert cell["status"] == "ok", cell.get("error")
        total, active = count_params(jc)
        assert (cell["params_total"], cell["params_active"]) == (total,
                                                                 active)
        assert cell["roofline"]["model_flops"] == model_flops(
            jc, JSHAPES[shape], total, active)
        assert cell["units"] == (
            jc.num_layers // jc.xlstm_group if jc.family == "xlstm" else
            jc.num_layers // jc.hybrid_group if jc.family == "hybrid" else
            jc.num_layers)


def test_cli_table_runs_without_jax(tmp_path):
    """``--all --both-meshes`` into ``--out``: every cell ``ok`` or
    ``skip``, the reference's summary line, exit 0, neither ``jax`` nor
    ``repro`` loaded; each ok cell's fields with no counterpart null and
    listed in ``no_analogue``."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--all', '--both-meshes', '--out', "
        f"{str(tmp_path)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(R.ROOT / "src"))
    env.pop("REPRO_MESH", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "LOADED []" in lines
    summary = [x for x in lines if x.startswith("dry-run summary:")]
    assert summary and " fail=0 " in summary[0] + " ", summary
    cells = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(cells) == 2 * len(list_configs()) * len(SHAPES)
    n_ok = 0
    for c in cells:
        assert c["status"] in ("ok", "skip"), c
        if c["status"] == "skip":
            continue
        n_ok += 1
        assert set(c["no_analogue"]) == set(NO_ANALOGUE)
        for k in ("compile_s", "hlo_bytes", "calibration"):
            assert c[k] is None
        for k, v in c["roofline"].items():
            assert (v is None) == (k in NO_ANALOGUE), (k, v)
        assert c["memory"]["argument_bytes"] > 0
    assert f"ok={n_ok} " in summary[0]


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ("command-r-35b", "deepseek-v2-236b"))
def test_held_bytes_are_what_a_place_holds(arch, kind):
    """A reduced ``fsdp=True`` config, every place of an emulated (2, 2)
    mesh: its blocks drawn a leaf at a time (``Model.init(keep=)``), float32 masters and their moments
    for a train step, the compute dtype for serving; a decode's cache
    block under the mesh's rules; the global batch."""
    from repro_torch.launch.mesh import emulate_mesh
    from repro_torch.launch.sharding import (
        activation_rules,
        batch_rows,
        keep_blocks,
        mesh_rules,
    )
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).reduced(fsdp=True)
    info = {"kind": kind, "batch": 4, "seq": 16}
    cell = run_cell(cfg.name, kind, False, verbose=False, cfg_override=cfg,
                    mesh=(2, 2), info=info)
    assert cell["status"] == "ok", cell.get("error")
    held = cell["memory"]["held"]

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if t is not None)

    def place(m):
        model = Model(cfg, torch.device("cpu"))
        params = model.init(0, master=kind == "train",
                            keep=keep_blocks(cfg, m))
        got = {"params": nbytes(params)}
        if kind == "train":
            got["opt"] = nbytes(init_opt_state(params, AdamWConfig(
                moment_dtype=cfg.opt_dtype)))
        if kind == "decode":
            rows = batch_rows(m, activation_rules(cfg, m, 4), 4)
            with mesh_rules(cfg, m, 4):
                got["cache"] = nbytes(model.init_cache(
                    len(range(4)[rows]), 16))
        return got

    for got in emulate_mesh({"data": 2, "model": 2}, place):
        for k, v in got.items():
            assert held[k] == v, (k, held[k], v)
    if kind == "decode":
        assert held["token"] == 4 * 4
    else:
        assert held["batch"] == (2 if kind == "train" else 1) * 4 * 16 * 4


@pytest.mark.parametrize("fam,shape,mesh", CELLS)
def test_argument_and_output_bytes_equal_jax_compiled(jax_mem, fam, shape,
                                                      mesh):
    key = f"{fam}/{shape}/{list(mesh)}"
    cell = run_cell(FAMILIES[fam][0], shape, False, verbose=False,
                    cfg_override=_cfg(fam), mesh=mesh)
    if key not in jax_mem:
        assert cell["status"] == "skip" and cell["reason"]
        return
    assert cell["status"] == "ok", cell.get("error")
    want = jax_mem[key]
    mem = cell["memory"]
    assert mem["argument_bytes"] == want["argument_bytes"], (mem, want)
    assert mem["output_bytes"] == want["output_bytes"], (mem, want)
    assert mem["argument_bytes"] == sum(mem["arguments"].values())
    assert mem["held_bytes"] == sum(mem["held"].values())
    assert mem["peak_estimate_bytes"] == sum(mem["peak_terms"].values())
    assert mem["temp_bytes"] is None
