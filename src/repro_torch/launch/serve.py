"""Serving entry point: batched greedy decoding with a persistent KV cache.

The port of ``repro/launch/serve.py`` for every family (GQA with a full
or SWA ring cache, MLA with its latent cache, whisper's self cache beside
its cross cache, the VLM's text cache, and the recurrent states of xLSTM
and of the Mamba2 hybrid, whose shared attention keeps a KV cache a
group).
Decoding runs through the serving engine: each token step is one engine
request, prompt tokens are staged ahead as ``ReadyHandle`` payloads, and
the engine's latency recorder supplies the tokens/s accounting.
``decode_loop`` is the pre-engine reference loop, kept as the parity
oracle (the engine's tokens are bit-identical to it).  As in the
reference, the loop warms the cache by stepping ``decode_step`` over the
prompt; ``launch.steps.make_prefill_step`` is the one-pass prefill (the
flash kernel's path; the recurrent families have none, and the loop is
how their states are warmed).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --reduce --device cpu --batch 4 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
        --reduce --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --reduce --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --layers 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internvl2-76b --layers 24

It runs on the card unless ``--device cpu`` is given; the weights are
random (``Model.init(0)``).  The full mixtral-8x22b (281 GB of bf16
weights), deepseek-v2-236b (479 GB) and internvl2-76b (141 GB) fit no
card: ``--layers N`` cuts a configuration to N layers at full width
(``--arch deepseek-v2-236b --layers 6``: 49.8 GB; ``--arch internvl2-76b
--layers 24``: 45.3 GB).  The VLM is served on text, as in the
reference (no patches).  As in the reference, the loop decodes the
encoder-decoder without frames: ``_init_cache`` gives it a zero cross
cache of ``encoder_seq`` slots (a prefill with frames fills a real one).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import transformer as TR
from ..models.model import compute_dtype
from ..serving import ReadyHandle, Request, ServingEngine
from .steps import make_serve_step

__all__ = ["decode_loop", "DecodeSource", "decode_loop_engine", "main"]


def _init_cache(model, B: int, cache_seq: int):
    """``model.init_cache(B, cache_seq)``; the encoder-decoder's ``cross``
    is a zero (k, v) of ``encoder_seq`` slots, as the reference's."""
    cfg = model.cfg
    cache = model.init_cache(B, cache_seq)
    if cfg.family == "encdec":
        kv = TR.init_kv_caches(cfg, B, cfg.encoder_seq,
                               torch.device(model.device),
                               dtype=compute_dtype(cfg))
        cache["cross"] = (kv["k"], kv["v"])
    return cache


def decode_loop(model, serve_step, params, prompt, gen: int, cache_seq: int):
    """Pre-engine reference decode (parity oracle for the engine route).
    Returns the generated tokens, (B, gen) numpy int32."""
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=model.device)
    B, S = prompt.shape
    cache = _init_cache(model, B, cache_seq)
    out_tokens = []
    # warm the cache on the prompt
    for t in range(S - 1):
        _, _, cache = serve_step(
            params, {"token": prompt[:, t:t + 1], "pos": t, "cache": cache})
    tok = prompt[:, -1:]
    for t in range(S - 1, S - 1 + gen):
        nxt, _, cache = serve_step(
            params, {"token": tok, "pos": t, "cache": cache})
        tok = nxt[:, None]
        out_tokens.append(tok.cpu().numpy())
    return np.concatenate(out_tokens, axis=1)


class DecodeSource:
    """Greedy decode as an engine request source: one request per token
    step.  Prompt tokens are known ahead, so they are staged when issued;
    generated tokens depend on the previous commit, so their payload is
    read at compute time (the engine commits step t before computing t+1
    in both modes)."""

    def __init__(self, model, serve_step, params, prompt, gen: int,
                 cache_seq: int):
        self.prompt = torch.as_tensor(prompt, dtype=torch.int32,
                                      device=model.device)
        B, S = self.prompt.shape
        self.serve_step = serve_step
        self.params = params
        self.gen = gen
        self.warm_steps = S - 1
        self.num_steps = S - 1 + gen
        self.batch = B
        self.cache = _init_cache(model, B, cache_seq)
        self.tok = self.prompt[:, -1:]
        self.out_tokens: list[np.ndarray] = []
        self._pos = 0

    def on_step(self, t: int) -> None:
        pass

    def next_request(self, t: int) -> Request:
        phase = "prefill" if t < self.warm_steps else "decode"
        return Request(tenant=phase, home=0, rows=None, batch=None,
                       need=None, examples=self.batch, tokens=self.batch)

    def issue(self, req: Request, t: int) -> ReadyHandle:
        if t < self.warm_steps:
            # prompt token known ahead: staged now
            return ReadyHandle(self.prompt[:, t:t + 1])
        return ReadyHandle(None)   # generated token: read at compute time

    def compute(self, req: Request, payload):
        tok = payload if payload is not None else self.tok
        return self.serve_step(
            self.params, {"token": tok, "pos": self._pos, "cache": self.cache})

    def commit(self, req: Request, out, t: int) -> dict:
        nxt, _, cache = out
        self.cache = cache
        if t >= self.warm_steps:
            self.tok = nxt[:, None]
            self.out_tokens.append(self.tok.cpu().numpy())
        self._pos += 1
        return {}

    def run(self, prefetch: bool = True) -> tuple[np.ndarray, dict]:
        engine = ServingEngine(self, prefetch=prefetch, warmup=0)
        summary = engine.run(self.num_steps)
        return np.concatenate(self.out_tokens, axis=1), summary


def decode_loop_engine(model, serve_step, params, prompt, gen: int,
                       cache_seq: int, prefetch: bool = True):
    """Engine-routed decode; bit-identical tokens to ``decode_loop``."""
    src = DecodeSource(model, serve_step, params, prompt, gen, cache_seq)
    return src.run(prefetch=prefetch)


def main(argv=None):
    ap = argparse.ArgumentParser(description="greedy decode through the "
                                 "serving engine (every family: dense, "
                                 "MoE, encoder-decoder, VLM, xLSTM, "
                                 "hybrid)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to its first N layers "
                    "(a recurrent family's, to a multiple of its group)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model, serve_step = make_serve_step(cfg, args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(args.batch,
                                                   args.prompt_len))
    t0 = time.perf_counter()
    out, summary = decode_loop_engine(model, serve_step, params, prompt,
                                      args.gen,
                                      cache_seq=args.prompt_len + args.gen)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} on {model.device}: generated {out.shape} in "
          f"{dt:.1f}s ({args.batch * args.gen / max(dt, 1e-9):.1f} tok/s, "
          f"engine p50 {summary['p50_ms']:.1f}ms p99 "
          f"{summary['p99_ms']:.1f}ms per token step)")
    print("sample:", out[0][:16])
    if not (np.all(out >= 0) and np.all(out < cfg.vocab_size)):
        raise RuntimeError("generated a token outside the vocabulary")
    return out


if __name__ == "__main__":
    main()
