"""Public Parsa facade of the PyTorch port: one config, one ``partition()``
entry point, one result type.

    from repro_torch.api import ParsaConfig, partition

    cfg = ParsaConfig(k=16, backend="device_scan", refine_backend="device")
    res = partition(graph, cfg)             # runs on the card
    res.parts_u, res.parts_v                # Alg 3 + Alg 2 assignments
    res.metrics.traffic_max                 # objectives (4)/(6)/(7)
    res.timings["partition_u"]              # wall clock per phase
    res2 = res.refine(tomorrows_graph)      # warm start from res.s_masks

    # sketched server sets: scan, refine and metrics at the sketch's width
    cfg = ParsaConfig(k=16, set_repr="sketch", sketch_hot_bits=65_536,
                      sketch_bucket_bits=65_536, refine_backend="device")

    # Algorithm 4: 8 workers on the card, an OR-merge every 12 blocks
    cfg = ParsaConfig(k=16, backend="parallel_device", workers=8,
                      block_size=128, merge_every=12, refine_backend="device")
    res = partition(graph, cfg)
    res.traffic.pushed_bytes                # delta-encoded worker pushes

    # Algorithm 4 across processes: one worker a rank (torchrun starts 4
    # processes; each calls this with its own card, every rank gets the
    # same result)
    torch.cuda.set_device(rank)
    torch.distributed.init_process_group("nccl")
    res = partition(graph, cfg.replace(workers=4),
                    group=torch.distributed.group.WORLD,
                    device=f"cuda:{rank}")

    # the embedding layout (doc → data shard, vocab → model shard)
    res = partition(graph, ParsaConfig(k=16, placement=True))
    res.placement.vocab_perm, res.timings["placement"]

    # online mode: the graph arrives in chunks (repro_torch.stream)
    from repro_torch.api import ParsaStreamConfig, StreamSession
    session = StreamSession(ParsaStreamConfig(base=ParsaConfig(k=16)),
                            num_v=65_536)
    upd = session.feed(chunk)               # one parsa_scan launch

    # elastic mode: k changes mid-stream (repro_torch.elastic)
    from repro_torch.api import ElasticConfig, ElasticSession
    es = ElasticSession(ElasticConfig(stream=ParsaStreamConfig(
        base=ParsaConfig(k=8))), num_v=65_536)
    es.feed(chunk); es.grow_k(force=True)   # k 8 -> 9, one parsa_scan
    es.repair(machine=3)                    # warm: one parsa_scan

    # PS serving with the closed SLO loop (repro_torch.serving)
    from repro_torch.api import (PSRequestSource, RequestMix, SLOAutoscaler,
                                 SLOConfig, ServingConfig, ServingEngine,
                                 ZipfWorkload)
    asc = SLOAutoscaler(SLOConfig(slo_ms=30.0))
    es = ElasticSession(ElasticConfig(stream=...), num_v=..., policy=asc)
    src = PSRequestSource(cluster, RequestMix((ZipfWorkload("t"),)),
                          ServingConfig(), elastic=es, autoscaler=asc)
    ServingEngine(src).run(1024)            # grows, repairs, sheds

Backends (``available_backends()``): ``device_scan`` (the default, on the
card), ``host_blocked_oracle``, ``parallel_device`` (on the card), and the
host algorithms ``host`` and ``parallel_sim`` (numpy; their refine and
metrics still run where ``refine_backend`` and ``device`` say).

The device decides where everything runs: ``partition(..., device="cuda")``
(the default) launches the hand-written kernels and raises when there is
no card; ``device="cpu"`` runs their plain PyTorch versions.  The JAX
``ParsaConfig`` fields ``use_kernel`` and ``interpret`` are gone for that
reason.  The default backend is ``device_scan`` (JAX: ``host``), so that
the default path runs on the card.  The stream (``ParsaStreamConfig``,
``StreamSession``, ``StreamUpdate``, ``stream_partition``), the elastic
surface (``ChaosEvent``, ``ChaosSchedule``, ``ElasticConfig``,
``ElasticPolicy``, ``ElasticSession``, ``SLOAutoscaler``, ``SLOConfig``,
``ThresholdPolicy``), the serving surface (``PSRequestSource``,
``RequestMix``, ``ServingConfig``, ``ServingEngine``, ``TelemetryBus``,
``TelemetrySnapshot``, ``ZipfWorkload``) and the observability surface (``Observability``, ``Tracer``, ``FlightRecorder``,
the exporters) are exported here lazily, as in the JAX facade.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .api_backends import (
    BACKENDS,
    BackendOutput,
    TrafficCounters,
    available_backends,
    config_workers,
    get_backend,
    register_backend,
)
from .core.bipartite import BipartiteGraph
from .core.costs import PartitionMetrics, evaluate
from .core.partition import resolve_worker_group
from .core.partition_v import partition_v
from .core.placement import Placement, placement_from_parts
from .core.refine import evaluate_device, refine_v_device
from .kernels.parsa_cost import pack_bitmask, unpack_bitmask
from .sketch import SketchSpec, rank_hot_columns

__all__ = [
    "ParsaConfig", "PartitionResult", "PartitionMetrics", "TrafficCounters",
    "partition", "register_backend", "available_backends",
    # streaming surface (lazy — see __getattr__)
    "ParsaStreamConfig", "StreamSession", "StreamUpdate", "stream_partition",
    # elastic surface (lazy — see __getattr__)
    "ChaosEvent", "ChaosSchedule", "ElasticConfig", "ElasticPolicy",
    "ElasticSession", "SLOAutoscaler", "SLOConfig", "ThresholdPolicy",
    # serving surface (lazy — see __getattr__)
    "PSRequestSource", "RequestMix", "ServingConfig", "ServingEngine",
    "TelemetryBus", "TelemetrySnapshot", "ZipfWorkload",
    # observability surface (lazy — see __getattr__)
    "Observability", "Tracer", "FlightRecorder", "Explanation",
    "to_chrome_trace", "chrome_trace_json", "save_chrome_trace",
    "prometheus_text",
]

# The stream (``repro_torch.stream``), elastic (``repro_torch.elastic``),
# serving (``repro_torch.serving``) and observability (``repro_torch.obs``)
# surfaces, loaded on first use: the stream module imports this one, so an
# eager import would be a cycle.
_STREAM_EXPORTS = ("ParsaStreamConfig", "StreamSession", "StreamUpdate",
                   "stream_partition")
_ELASTIC_EXPORTS = ("ChaosEvent", "ChaosSchedule", "ElasticConfig",
                    "ElasticPolicy", "ElasticSession", "SLOAutoscaler",
                    "SLOConfig", "ThresholdPolicy")
_SERVING_EXPORTS = ("PSRequestSource", "RequestMix", "ServingConfig",
                    "ServingEngine", "TelemetryBus", "TelemetrySnapshot",
                    "ZipfWorkload")
_OBS_EXPORTS = ("Observability", "Tracer", "FlightRecorder", "Explanation",
                "to_chrome_trace", "chrome_trace_json", "save_chrome_trace",
                "prometheus_text")


def __getattr__(name: str):
    if name in _STREAM_EXPORTS:
        from . import stream

        return getattr(stream, name)
    if name in _ELASTIC_EXPORTS:
        from . import elastic

        return getattr(elastic, name)
    if name in _SERVING_EXPORTS:
        from . import serving

        return getattr(serving, name)
    if name in _OBS_EXPORTS:
        from . import obs

        return getattr(obs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_SELECTS = ("size", "footprint")
_REFINE_BACKENDS = ("host", "device")
_SET_REPRS = ("exact", "sketch")


@dataclasses.dataclass(frozen=True)
class ParsaConfig:
    """Every knob of the port's Parsa pipeline, validated at construction."""

    k: int
    backend: str = "device_scan"

    # ---- subgraph streaming (§4.2/§4.4) — host / parallel_sim backends
    blocks: int = 1            # b: number of subgraphs (1 = global greedy)
    init_iters: int = 0        # a: individual-initialization iterations
    theta: int = 1000          # bucket-queue head-pointer range (§4.1)
    select: str = "size"       # "size" (perfect balance) | "footprint"
    seed: int = 0

    # ---- device backend knobs (device_scan / host_blocked_oracle /
    #      parallel_device)
    block_size: int = 256      # B: vertices greedily assigned per block
    cap: int = 48              # compact word-list width per vertex

    # ---- parallel backend knobs (Alg 4: parallel_sim / parallel_device)
    workers: int = 4           # W concurrent workers
    tau: int | None = 0        # max push delay in tasks; None = eventual
    global_init_frac: float = 0.0  # §4.4 global-init sample fraction
    merge_every: int = 1       # parallel_device: blocks between OR-merges
                               #   (τ ≡ merge_every − 1 blocks of staleness)
    devices: int | None = None  # parallel_device: overrides workers

    # sketched server sets (repro_torch.sketch): every phase runs at the
    # sketch's width, and the scan selects with the one-launch kernel
    set_repr: str = "exact"    # "exact" | "sketch" (column-compressed sets)
    sketch_hot_bits: int = 4096    # exact identity slots (top-footprint V)
    sketch_bucket_bits: int = 8192  # hashed shared slots for the cold tail
    refine_v: bool = True      # run Alg 2 after partition_u
    sweeps: int = 2            # Alg 2 re-assignment sweeps
    refine_backend: str = "host"   # "host" = numpy oracle; "device" = the
                                   #   packed-word refine + metrics on torch
    refine_chunk: int = 1024   # C: parameters swept per refine launch
    placement: bool = False    # also derive an embedding Placement

    def __post_init__(self):
        if not isinstance(self.k, (int, np.integer)) or self.k <= 0:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown Parsa backend {self.backend!r}; available: "
                f"{', '.join(available_backends())}")
        if self.blocks < 1:
            raise ValueError(f"blocks must be >= 1, got {self.blocks}")
        if self.init_iters < 0:
            raise ValueError(f"init_iters must be >= 0, got {self.init_iters}")
        if self.select not in _SELECTS:
            raise ValueError(
                f"select must be one of {_SELECTS}, got {self.select!r}")
        if self.block_size <= 0 or self.block_size % 8 != 0:
            raise ValueError(
                f"block_size must be a positive multiple of 8, got "
                f"{self.block_size}")
        if self.cap <= 0:
            raise ValueError(f"cap must be > 0, got {self.cap}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.tau is not None and self.tau < 0:
            raise ValueError(f"tau must be >= 0 or None, got {self.tau}")
        if not 0.0 <= self.global_init_frac <= 1.0:
            raise ValueError(
                f"global_init_frac must be in [0, 1], got "
                f"{self.global_init_frac}")
        if self.merge_every < 1:
            raise ValueError(
                f"merge_every must be >= 1, got {self.merge_every}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(
                f"devices must be >= 1 or None, got {self.devices}")
        if self.set_repr not in _SET_REPRS:
            raise ValueError(
                f"set_repr must be one of {_SET_REPRS}, got "
                f"{self.set_repr!r}")
        if self.sketch_hot_bits < 0 or self.sketch_hot_bits % 32 != 0:
            raise ValueError(
                f"sketch_hot_bits must be a nonnegative multiple of 32 "
                f"(packed word alignment), got {self.sketch_hot_bits}")
        if self.sketch_bucket_bits <= 0 or self.sketch_bucket_bits % 32 != 0:
            raise ValueError(
                f"sketch_bucket_bits must be a positive multiple of 32 "
                f"(packed word alignment), got {self.sketch_bucket_bits}")
        if self.sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {self.sweeps}")
        if self.refine_backend not in _REFINE_BACKENDS:
            raise ValueError(
                f"refine_backend must be one of {_REFINE_BACKENDS}, got "
                f"{self.refine_backend!r}")
        if self.refine_chunk <= 0 or self.refine_chunk % 32 != 0:
            raise ValueError(
                f"refine_chunk must be a positive multiple of 32 (the packed "
                f"word width), got {self.refine_chunk}")
        if self.placement and not self.refine_v:
            raise ValueError("placement=True requires refine_v=True "
                             "(the embedding layout needs parts_v)")

    def replace(self, **changes) -> "ParsaConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PartitionResult:
    """Output of ``partition``: host numpy arrays and the device it ran on."""

    parts_u: np.ndarray                 # (|U|,) int32
    parts_v: np.ndarray | None          # (|V|,) int32 or None (refine_v=False)
    s_masks: np.ndarray                 # (k, ⌈num_v/32⌉) int32 packed sets
    num_v: int                          # domain of s_masks — the sketched
                                        #   width when ``sketch`` is set
    k: int
    config: ParsaConfig
    metrics: PartitionMetrics | None    # None for a result converted in
    timings: dict[str, float]           # seconds per phase + "total"
    device: str = "cuda"
    sketch: SketchSpec | None = None    # set_repr="sketch": the column map
                                        #   (parts_v is expanded to the TRUE
                                        #   extent ``sketch.num_v``; metrics
                                        #   are sketch-space estimates)
    traffic: TrafficCounters | None = None  # parallel_sim / parallel_device
    placement: Placement | None = None  # config.placement only

    @property
    def neighbor_sets(self) -> np.ndarray:
        """(k, |V|) bool — dense view of the packed neighbor sets."""
        return unpack_bitmask(self.s_masks, self.num_v)

    def refine(self, graph: BipartiteGraph, config: ParsaConfig | None = None,
               *, device: str | torch.device | None = None
               ) -> "PartitionResult":
        """Warm-start repartitioning: partition ``graph`` seeding the
        neighbor sets with this result's packed ``s_masks`` (§4.4
        incremental mode), on this result's device unless told otherwise.

        A sketched result refines against the TRUE graph and hands its
        ``SketchSpec`` on, so the new run reuses the same column map (a map
        re-ranked on the new graph would scramble the warm-start masks)."""
        if graph.num_v != self.num_v and not (
                self.sketch is not None
                and graph.num_v == self.sketch.num_v):
            raise ValueError(
                f"refine() needs a graph over the same parameter side: "
                f"result has num_v={self.num_v}, graph has "
                f"num_v={graph.num_v}")
        return partition(graph, config or self.config, init_sets=self.s_masks,
                         sketch_spec=self.sketch,
                         device=self.device if device is None else device)


def resolve_device(device: str | torch.device, what: str = "partition"
                   ) -> torch.device:
    """``device`` as a ``torch.device``.  Naming the card with none there
    raises: no entry point falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numpy(x: torch.Tensor | np.ndarray) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition(
    graph: BipartiteGraph,
    config: ParsaConfig,
    *,
    init_sets: np.ndarray | torch.Tensor | None = None,
    sketch_spec: SketchSpec | None = None,
    device: str | torch.device = "cuda",
    group=None,
) -> PartitionResult:
    """Run the Parsa pipeline described by ``config`` on ``graph``.

    Phases: optional sketch → backend partition_u → optional Alg 2
    V-refinement → exact metrics → optional embedding placement
    (``config.placement``; refused for a compressing sketch, whose hashed
    columns have no identity to place).  ``timings`` gets ``sketch`` (the
    host column map, ``set_repr="sketch"``), ``pack`` (host packing, device
    backends), ``partition_u`` (the scan alone), ``partition_v``,
    ``metrics``, ``placement`` and ``total``; each phase ends in a device synchronize so
    no phase's queued work leaks into the next one's clock.

    With ``set_repr="sketch"`` the columns are compressed once on the host
    (``sketch_spec``, else ``SketchSpec.for_graph`` with a footprint-ranked
    hot set) and every later phase runs on the sketched graph; true-domain
    ``init_sets`` are compressed too, and ``parts_v`` comes back expanded
    to the true |V|.  A hash of a union is the union of the hashes, so the
    scan's set algebra is unchanged: only the packed width shrinks.

    With ``refine_backend="device"`` the refinement and metrics run on
    ``device`` over packed words; on a cold start (no ``init_sets``, no
    ``init_iters``, no ``global_init_frac``) every backend's final S_i is
    exactly N(U_i), so its ``s_masks`` are reused as the need matrix and the
    need pack is skipped.  Otherwise the sets may hold more than N(U_i)
    and the need matrix is packed from ``parts_u``.  A host backend's dense
    ``neighbor_sets`` are packed for the result.  ``device="cuda"`` (the
    default) raises when there is no card: nothing falls back to the CPU.

    ``group``, a ``torch.distributed`` process group that the caller
    created, runs ``parallel_device`` with one worker a rank: every rank
    calls ``partition`` with the same graph and config, its own
    ``device``, and a group of exactly ``devices or workers`` ranks
    (checked first, before any host work); the scan's merges gather over
    the group, refinement and metrics run on every rank, and every rank
    returns the same result.  Any other backend refuses a group.
    """
    device = resolve_device(device)
    backend = get_backend(config.backend)
    backend_kw = {}
    if group is not None:
        if config.backend != "parallel_device":
            raise ValueError(
                f"group= runs Algorithm 4 across processes and needs "
                f"backend='parallel_device', got {config.backend!r}")
        resolve_worker_group(config_workers(config), group)
        backend_kw["group"] = group
    timings: dict[str, float] = {}
    t_start = time.perf_counter()

    sketch = None
    run_graph = graph
    if config.set_repr == "sketch":
        t0 = time.perf_counter()
        sketch = sketch_spec
        if sketch is None:
            hot_ids = None
            if 0 < config.sketch_hot_bits < graph.num_v:
                hot_ids = rank_hot_columns(graph, config.sketch_hot_bits)
            sketch = SketchSpec.for_graph(
                graph.num_v, config.sketch_hot_bits,
                config.sketch_bucket_bits, seed=config.seed,
                hot_ids=hot_ids)
        if config.placement and not sketch.is_exact:
            raise ValueError(
                "placement=True needs exact parameter identities; a "
                "compressing sketch co-locates hashed columns — raise "
                "sketch_hot_bits to >= num_v or use set_repr='exact'")
        run_graph = sketch.sketch_graph(graph)
        if init_sets is not None and not sketch.is_exact \
                and init_sets.shape[1] != sketch.width_words:
            # true-domain sets: compress them, on the host
            if isinstance(init_sets, torch.Tensor):
                init_sets = init_sets.cpu().numpy()
            init_sets = sketch.sketch_masks(init_sets, graph.num_v)
        timings["sketch"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out: BackendOutput = backend(run_graph, config, init_sets=init_sets,
                                 device=device, **backend_kw)
    _sync(device)
    elapsed = time.perf_counter() - t0
    pack_s = (out.timings or {}).get("pack")
    if pack_s is not None:
        timings["pack"] = pack_s
        timings["partition_u"] = elapsed - pack_s
    else:
        timings["partition_u"] = elapsed

    s_masks = out.s_masks
    if s_masks is None:  # a host backend's dense sets
        s_masks = pack_bitmask(out.neighbor_sets, run_graph.num_v)
    parts_u = out.parts_u
    on_device = config.refine_backend == "device"
    need_words = None
    if on_device:
        parts_u = torch.as_tensor(parts_u, device=device)
        if init_sets is None and config.init_iters == 0 \
                and config.global_init_frac == 0.0:
            # cold-start invariant: S_i == N(U_i), so the sets ARE the
            # need matrix
            need_words = torch.as_tensor(s_masks, device=device)
    parts_v = parts_v_dev = None
    if config.refine_v:
        t0 = time.perf_counter()
        if on_device:
            parts_v_dev, need_words = refine_v_device(
                run_graph, parts_u, config.k, sweeps=config.sweeps,
                chunk=config.refine_chunk, need_words=need_words,
                device=device)
            parts_v = parts_v_dev.cpu().numpy()
        else:
            parts_v = partition_v(run_graph, _numpy(parts_u), config.k,
                                  sweeps=config.sweeps)
        timings["partition_v"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if on_device:
        metrics = evaluate_device(run_graph, parts_u, parts_v_dev,
                                  config.k, need_words=need_words,
                                  device=device)
    else:
        metrics = evaluate(run_graph, _numpy(parts_u), parts_v, config.k)
    timings["metrics"] = time.perf_counter() - t0
    if sketch is not None and parts_v is not None and not sketch.is_exact:
        # back to the true parameter extent: every real column is served by
        # the machine of its sketch slot (hot → its exact Alg 2 host,
        # bucketed tail → hash co-location)
        parts_v = sketch.expand_parts_v(parts_v)

    placement = None
    if config.placement:
        t0 = time.perf_counter()
        placement = placement_from_parts(_numpy(parts_u), parts_v,
                                         run_graph.num_v, config.k)
        timings["placement"] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_start

    return PartitionResult(
        parts_u=_numpy(parts_u),
        parts_v=parts_v,
        s_masks=_numpy(s_masks),
        num_v=run_graph.num_v,
        k=config.k,
        config=config,
        metrics=metrics,
        timings=timings,
        device=str(device),
        sketch=sketch,
        traffic=out.traffic,
        placement=placement,
    )
