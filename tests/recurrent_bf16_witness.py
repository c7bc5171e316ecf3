"""Teacher forcing of the recurrent families in bfloat16, the port against
the JAX package on the CPU, over several seeds.

For each seed: the JAX model's own weights (``init`` at that seed, at the
configuration's full width, its depth cut to ``--groups`` groups) carried
across by ``convert``, and the same tokens.  Each package runs its
parallel form (``_backbone`` and ``_logits``) and its decode steps over
the tokens; the script prints, as JSON lines, how far each package's two
forms part (relative L2 of the logits over every position, and the first
position past 5e-2), and how far the port's logits lie from JAX's in
either form.  Run from the repo's root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/recurrent_bf16_witness.py \\
        --arch xlstm-350m --seeds 0 1 2 3
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models.model import build_model

POS_BOUND = 5e-2


def rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((g - w) ** 2).sum() / max((w ** 2).sum(), 1e-30)))


def first_past(a, b, bound=POS_BOUND):
    """The first position whose logits part by more than ``bound``
    (relative L2 over the batch and vocabulary), or None."""
    for t in range(a.shape[1]):
        if rel_l2(a[:, t], b[:, t]) > bound:
            return t
    return None


def depth(arch, groups):
    cfg = jax_config(arch)
    group = cfg.xlstm_group if cfg.family == "xlstm" else cfg.hybrid_group
    return groups * group


def jax_forms(jm, jp, toks):
    """JAX's (parallel logits, decode-stepped logits), float32 arrays."""
    B, T = toks.shape
    V = jm.cfg.vocab_size
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))

    @jax.jit
    def parallel(p, t):
        x, _, _ = jm._backbone(p, jm._embed(p, t), pos)
        return jm._logits(p, x)

    par = np.asarray(parallel(jp, jnp.asarray(toks)), np.float32)[..., :V]
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, T)
    dec = []
    for t in range(T):
        lt, cache = step(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                              "pos": jnp.asarray(t, jnp.int32),
                              "cache": cache})
        dec.append(np.asarray(lt, np.float32)[:, 0, :V]
                   if lt.ndim == 3 else np.asarray(lt, np.float32)[:, :V])
    return par, np.stack(dec, axis=1)


def port_forms(tm, tp, toks):
    """The port's (parallel logits, decode-stepped logits)."""
    B, T = toks.shape
    V = tm.cfg.vocab_size
    t_ = torch.from_numpy(toks)
    with torch.no_grad():
        pos = torch.arange(T, dtype=torch.int32).expand(B, T)
        x, _, _ = tm._backbone(tp, tm._embed(tp, t_), pos)
        par = tm._logits(tp, x)[..., :V].float().numpy()
        cache = tm.init_cache(B, T)
        dec = []
        for t in range(T):
            lt, cache = tm.decode_step(tp, {"token": t_[:, t:t + 1],
                                            "pos": t, "cache": cache})
            dec.append(lt.reshape(B, -1)[:, :V].float().numpy())
    return par, np.stack(dec, axis=1)


def witness(arch, seed, tokens, batch, groups):
    n = depth(arch, groups)
    jcfg = dataclasses.replace(jax_config(arch), num_layers=n)
    tcfg = dataclasses.replace(get_config(arch), num_layers=n)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jm = jax_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, "cpu")
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (batch, tokens)).astype(np.int32)
    t0 = time.perf_counter()
    jpar, jdec = jax_forms(jm, jp, toks)
    tpar, tdec = port_forms(tm, tp, toks)
    return {"arch": arch, "seed": seed, "layers": n, "d_model": tcfg.d_model,
            "batch": batch, "tokens": tokens,
            "jax_parallel_vs_decode": rel_l2(jdec, jpar),
            "port_parallel_vs_decode": rel_l2(tdec, tpar),
            "jax_first_past": first_past(jdec, jpar),
            "port_first_past": first_past(tdec, tpar),
            "port_vs_jax_parallel": rel_l2(tpar, jpar),
            "port_vs_jax_decode": rel_l2(tdec, jdec),
            "port_vs_jax_first_past_decode": first_past(tdec, jdec),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-350m",
                    choices=["xlstm-350m", "zamba2-2.7b"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--groups", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    rows = []
    for seed in args.seeds:
        rows.append(witness(args.arch, seed, args.tokens, args.batch,
                            args.groups))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
