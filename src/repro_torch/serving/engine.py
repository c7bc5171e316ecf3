"""The serving engine's event loop: one request per step, sync or
double-buffered.

The port of ``Request`` and ``ServingEngine`` from
``repro/serving/engine.py``.  A source generates, issues, computes and
commits requests; the engine times each one (issue -> commit on the wall
clock, the compute closed by a synchronize of the output's device, which
takes the place of ``jax.block_until_ready``) and reduces the records with
``LatencyRecorder``.  In async mode (``prefetch=True``) request t+1 is
issued before request t is served.  Sources may add ``admit`` /
``note_shed`` (admission control), ``after_slot`` and ``observe_request``
hooks, as in the reference.

The PS cluster these requests are served from is ported
(``repro_torch.ml.PSCluster``, with its non-blocking ``plan_pull`` /
``pull_nowait`` / ``PullHandle.block``).  Not ported yet: the PS request
source (``PSRequestSource``, the DBPG ``_serve_step``) and the obs
tracer's request spans; they come with ``ROADMAP.md`` Queue 1 item 4.  A
source that carries a tracer (``obs``) is refused.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .latency import LatencyRecorder, RequestRecord
from .prefetch import OverlapMeter

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    tenant: str
    home: int
    rows: object              # the PS source's example rows (None for LM decode)
    batch: object             # its sparse batch (None for LM decode)
    need: object              # its (V,) bool working set (None for LM decode)
    examples: int
    tokens: int               # tokens processed (LM decode: the batch)


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class ServingEngine:
    """The event loop: sync (issue -> compute -> commit per request) or
    async (double-buffered: issue t+1, then serve t).  Slots the admission
    controller sheds are served as no-ops."""

    def __init__(self, source, prefetch: bool | None = None,
                 warmup: int | None = None):
        self.source = source
        src_cfg = getattr(source, "config", None)
        if (getattr(source, "obs", None) is not None
                or getattr(src_cfg, "obs", None) is not None):
            raise NotImplementedError(
                "request tracing (obs) is not ported yet (ROADMAP.md Queue 1 "
                "item 4)")
        self.prefetch = (src_cfg.prefetch if prefetch is None and src_cfg
                         else bool(prefetch))
        self.warmup = (src_cfg.warmup if warmup is None and src_cfg
                       else int(warmup or 0))
        self.recorder = LatencyRecorder(
            window_requests=getattr(src_cfg, "window_requests", None))
        self.overlap = OverlapMeter()

    def _produce(self, t):
        """Generate + admit + issue slot ``t``; ``None`` when shed."""
        src = self.source
        src.on_step(t)
        req = src.next_request(t)
        admit = getattr(src, "admit", None)
        if admit is not None and not admit(req):
            self.recorder.add_shed(req.tenant)
            note = getattr(src, "note_shed", None)
            if note is not None:
                note(req)
            return None
        return (req, src.issue(req, t))

    def run(self, num_requests: int) -> dict:
        rec, meter = self.recorder, self.overlap
        after = getattr(self.source, "after_slot", None)
        wall0 = None
        cur = self._produce(0) if self.prefetch and num_requests > 0 else None
        for t in range(num_requests):
            if t == self.warmup:
                wall0 = time.perf_counter()
            if self.prefetch:
                # double buffer: issue t+1 BEFORE serving t
                nxt = (self._produce(t + 1)
                       if t + 1 < num_requests else None)
            else:
                cur = self._produce(t)
            if cur is not None:
                req, handle = cur
                self._serve_one(req, handle, t, rec, meter)
            if after is not None:
                after(t)
            if self.prefetch:
                cur = nxt
        wall_s = (time.perf_counter() - wall0) if wall0 is not None else 0.0
        out = rec.summary(wall_s=wall_s)
        out["mode"] = "async" if self.prefetch else "sync"
        out["overlap"] = meter.as_dict()
        return out

    def _serve_one(self, req, handle, t, rec, meter) -> None:
        src = self.source
        tb = time.perf_counter()
        payload = handle.block()
        blocked = time.perf_counter() - tb
        tc = time.perf_counter()
        out = src.compute(req, payload)
        _synchronize(out)
        compute = time.perf_counter() - tc
        stats = src.commit(req, out, t)
        end = time.perf_counter()
        queue = getattr(handle, "queue_s", 0.0)
        measured = end - handle.issued_at
        modeled = getattr(handle, "modeled_s",
                          handle.wire_s + handle.wait_s + queue)
        rec.add(RequestRecord(
            tenant=req.tenant, step=t, home=req.home,
            examples=req.examples, tokens=req.tokens,
            latency_s=measured,
            wire_s=handle.wire_s, wait_s=handle.wait_s,
            blocked_s=blocked, compute_s=compute,
            fresh_entries=handle.fresh_entries,
            stale_entries=handle.stale_entries,
            pull_inter_bytes=handle.inter_bytes,
            push_inter_bytes=stats.get("push_inter_bytes", 0),
            warmup=t < self.warmup,
            queue_s=queue, modeled_s=modeled))
        observe = getattr(src, "observe_request", None)
        if observe is not None:
            observe(req, handle, modeled, measured)
        if t >= self.warmup:
            meter.add(handle.wire_s + queue, handle.wait_s, blocked,
                      compute)
