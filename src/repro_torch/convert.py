"""Carry state across from the JAX package.

The system's "weights" are partition state: the assignments and the packed
neighbor sets a run leaves behind, which a later run warm-starts from.
These helpers take plain numpy arrays (never JAX objects), so a result of
``repro.api.partition`` — or arrays saved from one — becomes a port result
whose ``.refine(g2)`` continues from the same sets.  A sketched result also
carries its column map (``sketch_from_numpy``), so its refine continues in
the same sketch space.  For the LM stack, ``model_params_from_numpy``
carries a model's weights across, and ``train_state_from_numpy`` /
``train_state_from_jax_checkpoint`` a training run's state (from numpy
trees, or from a checkpoint directory the JAX package wrote); for the
parameter server,
``ps_state_from_numpy`` carries a DBPG run's state into a port
``PSCluster``, which then continues the run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import ParsaConfig, PartitionResult, TrafficCounters
from .core.bipartite import BipartiteGraph
from .kernels.parsa_cost import coerce_packed_sets
from .sketch import SketchSpec

__all__ = ["graph_from_numpy", "result_from_numpy", "sketch_from_numpy",
           "model_params_from_numpy", "train_state_from_numpy",
           "train_state_from_jax_checkpoint", "ps_state_from_numpy"]

# the state a DBPG run carries between steps, beside the cluster's fixed
# graph, labels, placement and configuration
PS_STATE_KEYS = ("w", "pull_cache", "ef", "hist", "keys_sent", "inner_bytes",
                 "inter_bytes", "per_machine", "rng_state")

# the weight matrices every family uses in the compute dtype (an MoE
# layer's experts and shared experts are wg, wu, wd too; MLA's projections
# are wq_a, wq_b, wkv_a, wk_b, wv_b and wo; cross-attention's ``xattn``
# holds wq, wk, wv, wo; an mLSTM cell's wq, wk, wv, wz, wo and an sLSTM
# cell's wo; a Mamba2 cell's wz, wx, wB, wC, wo and its conv weights):
# stored in the compute dtype; every other leaf stays float32, cast where
# used: norm scales (MLA's q_a_norm and kv_a_norm, the encoder's enc_norm,
# the recurrent cells' out_norm), biases, the MoE router, the mLSTM's
# gates w_i and w_f, the sLSTM's input projections w_{i,f,z,o} and
# recurrent r_*, and the Mamba2's w_dt, dt_bias, A_log and D_skip
_MATRICES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "wg", "wu",
                       "wd", "wi", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
                       "wz", "wx", "wB", "wC", "conv_x", "conv_B", "conv_C"})


def graph_from_numpy(num_u: int, num_v: int, u_indptr, u_indices
                     ) -> BipartiteGraph:
    """The port's CSR graph from CSR arrays (copied, int64 / int32)."""
    g = BipartiteGraph(int(num_u), int(num_v),
                       np.array(u_indptr, dtype=np.int64),
                       np.array(u_indices, dtype=np.int32))
    g.validate()
    return g


def sketch_from_numpy(num_v: int, hot_bits: int, bucket_bits: int,
                      seed: int = 0, hot_ids=None) -> SketchSpec:
    """The port's ``SketchSpec`` from another spec's fields (those of a JAX
    ``SketchSpec``, as plain numbers and a numpy ``hot_ids``): the same
    column map, so a warm start lands in the same sketch space."""
    return SketchSpec(
        num_v=int(num_v), hot_bits=int(hot_bits),
        bucket_bits=int(bucket_bits), seed=int(seed),
        hot_ids=None if hot_ids is None else np.array(hot_ids,
                                                      dtype=np.int64))


def result_from_numpy(parts_u, parts_v, s_masks, k: int, num_v: int,
                      config, *, device: str = "cuda",
                      sketch: SketchSpec | None = None,
                      traffic=None) -> PartitionResult:
    """A port ``PartitionResult`` from another run's arrays.

    ``s_masks`` may be packed (k, W) words or dense (k, num_v) bool sets.
    ``config`` is a port ``ParsaConfig`` or any object with the same field
    names (such as the JAX ``ParsaConfig``); only the fields the port has
    are read.  For a sketched result ``num_v`` is the sketch's width (the
    result's own ``num_v``) and ``sketch`` its column map.  ``traffic`` is
    a ``TrafficCounters`` or any object with its field names (such as the
    JAX one), or None.  ``metrics`` is None: the source graph is not at
    hand.
    """
    if not isinstance(config, ParsaConfig):
        names = [f.name for f in dataclasses.fields(ParsaConfig)]
        config = ParsaConfig(**{n: getattr(config, n) for n in names
                                if hasattr(config, n)})
    if traffic is not None and not isinstance(traffic, TrafficCounters):
        traffic = TrafficCounters(**{
            f.name: int(getattr(traffic, f.name))
            for f in dataclasses.fields(TrafficCounters)
            if hasattr(traffic, f.name)})
    s_masks = np.array(coerce_packed_sets(s_masks, num_v), dtype=np.int32)
    if s_masks.shape[0] != k:
        raise ValueError(f"s_masks has {s_masks.shape[0]} rows, expected {k}")
    return PartitionResult(
        parts_u=np.array(parts_u, dtype=np.int32),
        parts_v=None if parts_v is None else np.array(parts_v, dtype=np.int32),
        s_masks=s_masks,
        num_v=int(num_v),
        k=int(k),
        config=config,
        metrics=None,
        timings={},
        device=device,
        sketch=sketch,
        traffic=traffic,
    )


def model_params_from_numpy(cfg, params, *, device="cuda",
                            master: bool = False) -> dict:
    """The port's parameter dict (``models.model``) from the reference's
    parameter tree as numpy arrays: {"embed", "final_norm", "lm_head",
    "stack"} (and the encoder-decoder's "enc", "enc_norm"), with the
    stack's leaves stacked on a leading layer axis (L, ...).  Returns the
    stack (and ``enc``, of ``encoder_layers``) as a list of per-layer
    dicts (an MoE layer's ``moe`` {router, wg, wu, wd[, shared]} carried
    across whole).  The recurrent families' stacks are stacked by group:
    xLSTM's {"mlstm": (G, n_m, ...), "slstm": (G, ...)} becomes {"mlstm":
    G lists of n_m block dicts, "slstm": G block dicts}, the hybrid's
    {"mamba": (G, n_m, ...), "shared_attn": one layer} becomes {"mamba": G
    lists of n_m block dicts, "shared_attn": the layer's dict}.

    Serving: weight matrices are stored in the config's compute dtype on
    ``device``; the reference keeps float32 masters and casts them to the
    compute dtype at every product, so the stored cast gives the same
    values.  ``master=True`` (training) keeps them float32, cast at every
    product as the reference does.  Norm scales, biases and the MoE router
    stay float32, as the reference casts them where it uses them."""
    dt = getattr(torch, cfg.dtype)
    return _stack_tree(cfg, params, device, lambda name: (
        dt if name in _MATRICES and not master else torch.float32))


def _stack_tree(cfg, params, device, dtype_of) -> dict:
    """A reference parameter-shaped numpy tree as the port's: the stacked
    ``stack`` leaves (and the encoder-decoder's ``enc``) split into lists
    of per-layer dicts (of per-group lists for the recurrent families),
    each leaf a tensor of ``dtype_of(leaf name)`` on ``device``."""
    def leaf(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dtype_of(name))

    def tree(p, index=None):
        return {name: tree(a, index) if isinstance(a, dict)
                else leaf(name, a if index is None else np.asarray(a)[index])
                for name, a in p.items()}

    def lead(p, want, name):
        """``p``'s blocks (the leading axes of its first norm scale),
        checked against the config's ``want``."""
        got = np.asarray(p["ln"]["scale"] if "ln" in p
                         else p["ln1"]["scale"]).shape[:len(want)]
        if got != want:
            raise ValueError(f"{got} blocks in the tree's {name!r}, the "
                             f"config has {want}")
        return want

    stacked = {"stack": cfg.num_layers}
    if cfg.family == "encdec":
        stacked["enc"] = cfg.encoder_layers
    out = {}
    for name, p in params.items():
        if name not in stacked:
            out[name] = tree(p) if isinstance(p, dict) else leaf(name, p)
        elif cfg.family in ("xlstm", "hybrid"):
            group = (cfg.xlstm_group if cfg.family == "xlstm"
                     else cfg.hybrid_group)
            G, n_m = cfg.num_layers // group, group - 1
            cell = "mlstm" if cfg.family == "xlstm" else "mamba"
            lead(p[cell], (G, n_m), f"{name}::{cell}")
            out[name] = {cell: [[tree(p[cell], (g, i)) for i in range(n_m)]
                                for g in range(G)]}
            if cfg.family == "xlstm":
                lead(p["slstm"], (G,), f"{name}::slstm")
                out[name]["slstm"] = [tree(p["slstm"], g) for g in range(G)]
            else:
                out[name]["shared_attn"] = tree(p["shared_attn"])
        else:
            (L,) = lead(p, (stacked[name],), name)
            out[name] = [tree(p, l) for l in range(L)]
    return out


def train_state_from_numpy(cfg, params, opt, *, device="cuda"):
    """The port's training state (``launch.steps.make_train_step``'s
    ``(params, opt_state)``) from the reference's, as numpy trees:
    ``params`` the parameter tree (float32 masters), ``opt`` {"m", "v",
    "step"} and, when ``cfg.grad_compress`` is on, "comp": {"ef"}.  The
    moments keep the config's moment dtype (``cfg.opt_dtype``), ``step``
    is an int32 tensor and the error feedback float32."""
    md = getattr(torch, cfg.opt_dtype)
    state = {"m": _stack_tree(cfg, opt["m"], device, lambda name: md),
             "v": _stack_tree(cfg, opt["v"], device, lambda name: md),
             "step": torch.tensor(int(np.asarray(opt["step"])),
                                  dtype=torch.int32, device=device)}
    if cfg.grad_compress:
        state["comp"] = {"ef": _stack_tree(cfg, opt["comp"]["ef"], device,
                                           lambda name: torch.float32)}
    return (model_params_from_numpy(cfg, params, device=device, master=True),
            state)


def train_state_from_jax_checkpoint(cfg, directory, step: int | None = None,
                                    *, device="cuda"):
    """(step, params, opt_state): the training state of a checkpoint
    directory the JAX package's ``TrainLoop`` wrote (its newest step when
    ``step`` is None), in the port's layout.  The manifest's keys are the
    reference's tree paths joined with ``::``; its ``stack`` leaves are
    stacked on a leading layer axis, which this maps to the port's list
    of per-layer dicts (``params::stack::attn::wq`` (L, ...) becomes
    ``params::stack::<l>::attn::wq``)."""
    from .ckpt import latest_step
    from .ckpt.checkpoint import read_arrays

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    arrays, manifest = read_arrays(directory, step)
    tree: dict = {}
    for key, a in arrays.items():
        if manifest[key]["dtype"] == "bfloat16":   # its 16-bit patterns
            a = (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
                 << 16).view(np.float32)
        node = tree
        *parents, name = key.split("::")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = a
    params, opt = train_state_from_numpy(cfg, tree["params"], tree["opt"],
                                         device=device)
    return step, params, opt


def ps_state_from_numpy(cluster, state: dict):
    """Load another run's DBPG state into the port ``PSCluster``
    ``cluster`` (built on the same graph, labels, placement and
    ``DBPGConfig``) and return it; its next ``step`` continues that run.

    ``state`` holds plain numpy values under ``PS_STATE_KEYS``, as read
    from a JAX ``PSCluster``: ``w`` (V,); ``pull_cache`` and ``ef``, one
    (V,) array a machine; ``hist``, the list of past weight vectors;
    ``keys_sent`` (k, k) bool; the meter's ``inner_bytes``,
    ``inter_bytes`` and ``per_machine``; and ``rng_state``, the
    ``rng.bit_generator.state`` dict of the τ draws."""
    missing = [key for key in PS_STATE_KEYS if key not in state]
    if missing:
        raise ValueError(f"PS state lacks {missing}")
    k = cluster.k
    if len(state["pull_cache"]) != k or len(state["ef"]) != k:
        raise ValueError(f"PS state is for {len(state['pull_cache'])} "
                         f"machines, the cluster has {k}")

    def vec(a):
        return np.array(a, dtype=np.float32)

    cluster.w = torch.tensor(vec(state["w"]), device=cluster.device)
    cluster._pull_cache = [vec(a) for a in state["pull_cache"]]
    cluster._ef = [vec(a) for a in state["ef"]]
    cluster._hist = [vec(a) for a in state["hist"]]
    cluster._keys_sent = np.array(state["keys_sent"], dtype=bool)
    cluster.meter.inner_bytes = int(state["inner_bytes"])
    cluster.meter.inter_bytes = int(state["inter_bytes"])
    cluster.meter.per_machine = np.array(state["per_machine"], dtype=np.int64)
    cluster.rng.bit_generator.state = state["rng_state"]
    return cluster
