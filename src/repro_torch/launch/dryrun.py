"""Dry-run of every (arch × shape × mesh) cell without a card: a rank's
memory and the model arithmetic, from the shapes alone.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step with XLA on forced host devices and reads the
compiled module's ``memory_analysis()`` and ``cost_analysis()``.  The
port has no XLA module: it works a cell out from the trees on the meta
device (``Model(cfg, "meta").init``, ``models.model.input_specs``) cut
by ``launch.sharding``'s specs on a stand-in of the production mesh
(``launch.mesh.mesh_shape``, ``REPRO_MESH`` honoured), so it needs no
card and no process group, and every registered config runs at full
width on (16, 16) and (2, 16, 16) in seconds.

Each cell has the reference's keys (``arch``, ``shape``, ``mesh``,
``status``, ``memory``, ``roofline``, ``params_total``,
``params_active``, ``units``; ``reason`` where skipped, ``error`` and
``traceback`` where failed).  ``memory``:

  * ``argument_bytes`` — what the reference's compiled step takes a
    device (its ``argument_size_in_bytes``): each argument's block on
    one place under ``param_pspecs``, ``opt_pspecs`` and
    ``batch_specs`` times its element size (the reference's float32
    parameters; train: parameters, optimizer state, batch; prefill:
    parameters, batch; decode: parameters, token, pos, cache);
  * ``output_bytes`` — what that step returns a device (its
    ``output_size_in_bytes``): the outputs' blocks under its
    ``out_shardings``, and 8 bytes a leaf of a tuple of outputs (XLA's
    table of the tuple's buffers);
  * ``held_bytes`` — what the port's rank holds of the same step's
    inputs, by design more or other than the arguments (``held``, a
    term each): serving keeps the weights in the compute dtype
    (``Model.init``), the steps over a mesh take the global batch (or
    token) on every rank and slice the rank's rows, and a decode's
    ``pos`` is a host int;
  * ``peak_estimate_bytes`` — in place of XLA's ``temp_size_in_bytes``
    (its buffer assignment, which the port has no counterpart of): a sum
    of named terms (``peak_terms``): the held bytes, a train step's
    float32 gradients of the rank's blocks, the logits a rank computes
    at once, and under FSDP a layer's and the head's weights
    gathered whole over data (``fsdp_plan``).

The fields that come from XLA's cost analysis and HLO text are null and
listed in ``no_analogue`` with the reason (the roofline's per-device
FLOPs, bytes, wire bytes and collectives, and what derives from them;
``compile_s``, ``hlo_bytes`` and the calibration pair).  ``roofline``
keeps ``count_params`` and ``model_flops`` (``launch.roofline``).

Cells are written as JSON under ``dryrun_out/`` at the repository's root
(``--out`` elsewhere); the reference's ``benchmarks/out/dryrun/`` is left
to it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import pathlib
import traceback
import types

import torch

from ..configs import get_config, list_configs
from ..models.model import SHAPES, Model, input_specs, shape_applicable
from ..tree import tree_leaves, tree_leaves_with_path
from .mesh import AXES, axis_sizes, mesh_shape
from .roofline import count_params, model_flops
from .sharding import (
    _at,
    _div,
    _dp,
    block_bytes,
    block_shape,
    batch_specs,
    cache_specs,
    fsdp_plan,
    param_pspecs,
)

__all__ = ["OUT_DIR", "NO_ANALOGUE", "stand_in", "cell_memory", "run_cell",
           "cell_path", "main"]

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"

# what the reference reads from XLA and the port cannot: field -> reason
_COST = ("XLA's cost analysis of the compiled module (two unrolled "
         "calibration compiles); the port has no XLA module")
NO_ANALOGUE = {
    "flops_per_device": _COST,
    "bytes_per_device": _COST,
    "wire_bytes_per_device": ("the collectives parsed from the compiled "
                              "HLO text (parse_collectives, not ported)"),
    "collectives": ("the collectives parsed from the compiled HLO text "
                    "(parse_collectives, not ported)"),
    "t_compute_s": "derived from flops_per_device",
    "t_memory_s": "derived from bytes_per_device",
    "t_collective_s": "derived from wire_bytes_per_device",
    "bottleneck": "derived from the three times above",
    "useful_ratio": "derived from flops_per_device",
    "roofline_fraction": "derived from the three times above",
    "peak_memory_per_device": ("XLA's argument + temp bytes; the port's "
                               "is memory.peak_estimate_bytes"),
    "temp_bytes": ("XLA's buffer assignment of the compiled step; the "
                   "port's estimate is memory.peak_estimate_bytes"),
    "compile_s": "the XLA compile the port does not make",
    "hlo_bytes": "the compiled module's HLO text",
    "calibration": "the two unrolled XLA compiles of the calibration fit",
}
# XLA's table of a tuple of outputs: one buffer pointer a leaf
_TUPLE_ENTRY_BYTES = 8
_METRICS = ("loss", "tokens", "grad_norm")     # the train step's, float32


def stand_in(shape: tuple, names: tuple | None = None):
    """A mesh of ``shape`` for ``launch.sharding``'s spec functions, no
    ranks: its axes ``names``, by default the last ``len(shape)`` of
    ("pod", "data", "model"), as ``REPRO_MESH`` names them."""
    names = AXES[-len(shape):] if names is None else tuple(names)
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _units(cfg) -> int:
    """The reference's layer units (its calibration fit's count)."""
    if cfg.family == "xlstm":
        return cfg.num_layers // cfg.xlstm_group
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_group
    return cfg.num_layers


@functools.lru_cache(maxsize=64)
def _meta_params(cfg, master: bool) -> dict:
    """The parameter tree's shapes on the meta device (read only)."""
    return Model(cfg, torch.device("meta")).init(master=master)


def _unread(cfg, kind: str):
    """``unread(path)``: whether the reference's step of ``kind`` leaves
    the argument at ``path`` (a ``tree`` path of ``{"params", "batch"}``)
    unread, so that ``jax.jit`` prunes it from the compiled module's
    arguments (``keep_unused=False``): the dense prefill's labels (and
    the VLM's patches: its prefill reads text only), the xLSTM decode's
    ``pos``, and the encoder-decoder decode's encoder and cross-attention
    key and value projections (the cross (k, v) come in the cache)."""
    unread_batch = set()
    if kind == "prefill" and cfg.family not in ("xlstm", "hybrid"):
        unread_batch |= {"labels", "patches"}
    if kind == "decode" and cfg.family == "xlstm":
        unread_batch.add("pos")

    def unread(path) -> bool:
        if path[0] == "batch":
            return path[1] in unread_batch
        if kind != "decode" or cfg.family != "encdec":
            return False
        return path[1] in ("enc", "enc_norm") or (
            "xattn" in path and path[-1] in ("wk", "wv", "bk", "bv"))

    return unread


def _ref_leaves(tree) -> int:
    """The reference's leaf count of a tree of the port's layout: its
    layer lists are the reference's stacked leading dims."""
    return len({tuple(k for k in p if not isinstance(k, int))
                for p, t in tree_leaves_with_path(tree) if t is not None})


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t is not None)


def _n_leaves(tree) -> int:
    return sum(t is not None for t in tree_leaves(tree))


def _fsdp_gathered(cfg, mesh) -> int:
    """The bytes of a layer's (a recurrent group's) weights and of the
    embedding and head, gathered whole over data at once (``fsdp_plan``,
    a key a leaf path, every layer's alike: the dims cut over data, the
    blocks, the dtypes the layers read them in)."""
    plan = fsdp_plan(cfg, mesh)
    if not plan:
        return 0
    n = axis_sizes(mesh)["data"]
    layer, head = 0, 0
    for key, (dim, block, dtype) in plan.items():
        b = math.prod(block) * n * torch.empty((), dtype=dtype).element_size()
        if key in ("embed", "lm_head"):
            head += b
        else:
            layer += b
    return layer + head


def cell_memory(cfg, info: dict, mesh) -> dict:
    """A rank's memory in a cell: ``cfg`` at ``info`` (a ``SHAPES``
    entry, or one of its form) on ``mesh`` (a stand-in, or anything
    ``axis_sizes`` reads).  The fields of the module docstring."""
    kind = info["kind"]
    master = _meta_params(cfg, True)       # the reference's float32 leaves
    pspec = param_pspecs(cfg, master, mesh)
    inputs = input_specs(cfg, info)
    bspec = batch_specs(cfg, inputs, mesh)
    params = block_bytes(master, pspec, mesh)
    unread = _unread(cfg, kind)
    args = {"params": sum(
        math.prod(block_shape(tuple(t.shape), _at(pspec, p), mesh)) * 4
        for p, t in tree_leaves_with_path(master)
        if not unread(("params",) + p))}
    held = {}
    out = {}
    if kind == "train":
        itemsize = torch.empty((), dtype=getattr(
            torch, cfg.opt_dtype)).element_size()
        moments = block_bytes(master, pspec, mesh, itemsize=itemsize)
        args["opt"] = 2 * moments + 4              # m, v and the int32 step
        held["params"], held["opt"] = params, args["opt"]
        if cfg.grad_compress:
            held["comp"] = params                  # float32 error feedback
        out["params"], out["opt"] = params, args["opt"]
        out["metrics"] = 4 * len(_METRICS)
        n_out = 3 * _ref_leaves(master) + 1 + len(_METRICS)
    else:
        held["params"] = block_bytes(_meta_params(cfg, False), pspec, mesh)
    read = {k: v for k, v in inputs.items() if not unread(("batch", k))}
    args["batch"] = block_bytes(read, bspec, mesh)
    B = info["batch"]
    V = cfg.padded_vocab
    vocab_cut = block_shape((V,), (_div(V, mesh, "model"),), mesh)[0]
    if kind == "decode":
        rows = math.prod(block_shape((B,), bspec["token"][:1], mesh))
        held["token"] = _whole_bytes(inputs["token"])
        held["cache"] = block_bytes(inputs["cache"], bspec["cache"], mesh)
        out["next_token"] = rows * 4
        out["logits"] = rows * vocab_cut * 4
        out["cache"] = held["cache"]
        n_out = 2 + _n_leaves(inputs["cache"])
    else:
        held["batch"] = _whole_bytes(read)
    if kind == "prefill":
        if cfg.family in ("xlstm", "hybrid"):
            out["loss"], n_out = 4, 0              # one array, no tuple
        else:
            rows = math.prod(block_shape((B,), bspec["tokens"][:1], mesh))
            cache = input_specs(cfg, dict(info, kind="decode"))["cache"]
            out["logits"] = rows * vocab_cut * 4
            out["cache"] = block_bytes(cache, cache_specs(cfg, cache, mesh),
                                       mesh)
            n_out = 1 + _n_leaves(cache)
    out["tuple_table"] = _TUPLE_ENTRY_BYTES * n_out
    held_bytes = sum(held.values())
    peak = {"held": held_bytes}
    if kind == "train":
        peak["gradients"] = params
        from .steps import _effective_microbatches

        bs = B // _effective_microbatches(cfg, mesh, B)
        rows = block_shape((bs,), (_dp(mesh, bs),), mesh)[0]
        peak["logits"] = rows * info["seq"] * vocab_cut * 4
    elif kind == "prefill" and cfg.family in ("xlstm", "hybrid"):
        rows = math.prod(block_shape((B,), bspec["tokens"][:1], mesh))
        peak["logits"] = rows * info["seq"] * vocab_cut * 4
    gathered = _fsdp_gathered(cfg, mesh)
    if gathered:
        peak["fsdp_gathered"] = gathered
    return {"argument_bytes": sum(args.values()), "arguments": args,
            "output_bytes": sum(out.values()), "outputs": out,
            "held_bytes": held_bytes, "held": held,
            "peak_estimate_bytes": sum(peak.values()), "peak_terms": peak,
            "temp_bytes": None}


def _roofline(cfg, arch, shape, mname, chips, info) -> tuple[dict, float,
                                                             float]:
    n_total, n_active = count_params(cfg)
    rl = {"arch": arch, "shape": shape, "mesh": mname, "chips": chips,
          "model_flops": model_flops(cfg, info, n_total, n_active)}
    rl.update({k: None for k in NO_ANALOGUE if k not in (
        "temp_bytes", "compile_s", "hlo_bytes", "calibration")})
    return rl, n_total, n_active


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             cfg_override=None, label: str | None = None, *,
             mesh: tuple | None = None, info: dict | None = None) -> dict:
    """One (config × shape × mesh) cell.  ``mesh`` (a shape, its axes the
    last of ("pod", "data", "model")) replaces the production mesh, and
    ``info`` (a ``SHAPES`` entry's form) the shape's batch and sequence,
    for a cell at another scale (the card's checks); a cell never
    reports ``ok`` over an error."""
    cfg = cfg_override or get_config(arch)
    if info is None:
        ok, reason = shape_applicable(cfg, shape)
        info = dict(SHAPES[shape], ring=shape == "long_500k")
    else:
        ok, reason = True, ""
    if mesh is None:
        mesh, names = mesh_shape(multi_pod=multi_pod)
    else:
        names = AXES[-len(mesh):]
    mname = "x".join(map(str, mesh))
    cell = {"arch": label or arch, "shape": shape, "mesh": mname}
    if not ok:
        cell.update(status="skip", reason=reason)
        return cell
    try:
        sm = stand_in(tuple(mesh), names)
        mem = cell_memory(cfg, info, sm)
        rl, n_total, n_active = _roofline(cfg, arch, shape, mname,
                                          math.prod(mesh), info)
        cell.update(status="ok", memory=mem, roofline=rl,
                    params_total=n_total, params_active=n_active,
                    units=_units(cfg), compile_s=None, hlo_bytes=None,
                    calibration=None, no_analogue=dict(NO_ANALOGUE))
        if verbose:
            print(f"[ok] {cell['arch']} × {shape} × {mname}: "
                  f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"held/dev={mem['held_bytes'] / 2**30:.2f}GiB "
                  f"peak-est/dev={mem['peak_estimate_bytes'] / 2**30:.2f}"
                  f"GiB model_flops={rl['model_flops']:.3e}", flush=True)
    except Exception as e:
        cell.update(status="fail", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[FAIL] {cell['arch']} × {shape} × {mname}: "
                  f"{type(e).__name__}: {e}", flush=True)
    return cell


def cell_path(arch: str, shape: str, multi_pod: bool,
              out: pathlib.Path | None = None) -> pathlib.Path:
    mname = "2x16x16" if multi_pod else "16x16"
    if os.environ.get("REPRO_MESH"):
        mname = os.environ["REPRO_MESH"].replace(",", "x")
    return (OUT_DIR if out is None else pathlib.Path(out)) / \
        f"{arch}__{shape}__{mname}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"directory of the cells (default {OUT_DIR})")
    args = ap.parse_args(argv)

    out = OUT_DIR if args.out is None else pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = n_skip = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                p = cell_path(arch, shape, mp, out)
                if p.exists() and not args.force:
                    prev = json.loads(p.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {arch} × {shape} × {prev['mesh']}: "
                              f"{prev['status']}", flush=True)
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skip"
                        continue
                cell = run_cell(arch, shape, mp)
                p.write_text(json.dumps(cell, indent=1))
                n_ok += cell["status"] == "ok"
                n_fail += cell["status"] == "fail"
                n_skip += cell["status"] == "skip"
    print(f"\ndry-run summary: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
