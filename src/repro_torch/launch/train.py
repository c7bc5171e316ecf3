"""End-to-end training driver.

The port of ``repro/launch/train.py`` on one card, for every family:
config registry -> model -> AdamW -> synthetic data, staged ahead on the
device -> TrainLoop (checkpoint/restart, failure injection).  The flags
are the reference's, with the same meanings (``--width`` and ``--layers``
act only under ``--reduce``).  As in the reference, the VLM's batches
carry zero ``patches`` (the stub front end's input).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --reduce --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --steps 4 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --reduce --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internvl2-76b --reduce --steps 50

It runs on the card; ``main(argv, device="cpu")`` runs the plain PyTorch
path on the CPU (MoE training, ``--arch mixtral-8x22b --reduce``, has been
held to the reference on the CPU only).
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import numpy as np

from ..configs import get_config
from ..data import SyntheticLMData
from ..optim import AdamWConfig
from ..runtime import FaultConfig, TrainLoop
from ..serving import prefetch_batches, stage_batch
from .steps import make_train_step

__all__ = ["build", "main"]


def build(cfg, device="cuda", lr=3e-4, *, mesh=None):
    """(model, train_step, init_state) for ``cfg`` on ``device``; with
    ``mesh`` (a ``DeviceMesh`` of the ranks) the train step over it, on
    the rank's blocks (``launch.steps.make_train_step``).  ``main`` passes
    no mesh, as the reference's ``main`` does.  Over a mesh, checkpoints
    of the rank's blocks go through ``TrainLoop(train_step, fault,
    mesh=mesh, specs=launch.sharding.state_specs(cfg, mesh))``: every rank
    gathers the logical arrays and rank 0 writes them, and ``resume_or
    (lambda: init_state(seed))`` restores each rank's blocks in place,
    onto any mesh."""
    opt_cfg = AdamWConfig(lr=lr, moment_dtype=cfg.opt_dtype)
    model, train_step, init_state, _ = make_train_step(cfg, device, opt_cfg,
                                                       mesh=mesh)
    return model, train_step, init_state


def main(argv=None, *, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduce", action="store_true",
                    help="reduced config of the same family (CPU-runnable)")
    ap.add_argument("--width", type=int, default=None,
                    help="override d_model for --reduce (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        over = {}
        if args.width:
            over.update(d_model=args.width, head_dim=args.width // 4,
                        d_ff=0 if cfg.d_ff == 0 else args.width * 4,
                        vocab_size=8192)
        if args.layers:
            over["num_layers"] = args.layers
        cfg = cfg.reduced(**over)
    model, train_step, init_state = build(cfg, device, lr=args.lr)

    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq, seed=0)

    def host_batches():
        for t in range(start, args.steps):
            b = data.batch_at(t)
            if cfg.family == "vlm":
                b["patches"] = np.zeros(
                    (args.batch, cfg.num_patches, cfg.d_model), np.float32)
            yield b

    def batches():
        # double-buffered staging: batch t+1's host-to-device copy is in
        # flight while the loop computes step t
        yield from prefetch_batches(
            host_batches(), functools.partial(stage_batch, device=device),
            depth=2)

    fault = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        fail_at_step=args.fail_at)
    loop = TrainLoop(train_step, fault)
    if args.resume:
        start, params, opt = loop.resume_or(lambda: init_state(0))
        print(f"resumed at step {start}")
    else:
        start = 0
        params, opt = init_state(0)
    n = model.param_count(params)
    print(f"arch={cfg.name} params={n/1e6:.1f}M steps={start}->{args.steps}")
    t0 = time.time()
    params, opt, hist = loop.run(params, opt, batches(), start_step=start,
                                 log_every=args.log_every)
    dt = time.time() - t0
    steps_done = args.steps - start
    tok = steps_done * args.batch * args.seq
    print(f"done: {steps_done} steps, {dt:.1f}s, {tok/max(dt,1e-9):.0f} tok/s")
    if hist:
        print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
