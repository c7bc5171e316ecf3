"""The port's facade against the JAX package: ``partition()`` end to end,
warm starts carried across with ``convert.result_from_numpy``, the copied
graph generators, and two guards (the port imports neither JAX nor
``repro``; the default device is the card and never falls back)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import ParsaConfig as JConfig
from repro.api import partition as j_partition
from repro.core.bipartite import from_edges as j_from_edges
from repro.graphs import ctr_like as j_ctr_like
from repro.graphs import text_like as j_text_like
from repro_torch import api
from repro_torch.api import ParsaConfig, partition
from repro_torch.convert import graph_from_numpy, result_from_numpy
from repro_torch.core.dispatch import dispatch_counter
from repro_torch.graphs import ctr_like, text_like

METRIC_FIELDS = ("sizes", "footprint", "traffic", "worker_recv",
                 "server_send")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _assert_results_equal(got, want):
    assert np.array_equal(got.parts_u, want.parts_u)
    assert np.array_equal(got.s_masks, want.s_masks)
    assert (got.parts_v is None) == (want.parts_v is None)
    if want.parts_v is not None:
        assert np.array_equal(got.parts_v, want.parts_v)
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(got.metrics, f),
                              getattr(want.metrics, f)), f


# ------------------------------------------------------ end to end
@pytest.mark.parametrize("refine_backend", ["device", "host"])
@pytest.mark.parametrize("k", [4, 16])
def test_partition_matches_jax(k, refine_backend):
    g = j_text_like(500, 900, mean_len=15, seed=9)
    kw = dict(k=k, backend="device_scan", refine_backend=refine_backend,
              block_size=64, sweeps=2)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    _assert_results_equal(got, want)
    assert set(got.timings) == set(want.timings)
    assert got.device == "cpu"


def test_host_blocked_oracle_matches_jax():
    g = j_text_like(500, 900, mean_len=15, seed=9)
    kw = dict(k=8, backend="host_blocked_oracle", refine_backend="device",
              block_size=64)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    _assert_results_equal(got, want)


def test_partition_refine_v_off_matches_jax():
    g = j_text_like(300, 500, mean_len=12, seed=2)
    kw = dict(k=4, backend="device_scan", refine_backend="device",
              block_size=64, refine_v=False)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    assert got.parts_v is None
    _assert_results_equal(got, want)


def test_partition_dispatches_one_per_phase():
    g = _port(j_text_like(300, 500, mean_len=12, seed=2))
    cfg = ParsaConfig(k=4, backend="device_scan", refine_backend="device",
                      block_size=64)
    with dispatch_counter() as counts:
        partition(g, cfg, device="cpu")
    # cold start: s_masks are reused as the need words, so no need_pack
    assert counts == {"partition_scan": 1, "refine_scan": 1, "metrics": 1}
    with dispatch_counter() as counts:
        partition(g, cfg, init_sets=np.zeros((4, g.num_v), bool),
                  device="cpu")
    assert counts["need_pack"] == 1


def test_graph_with_bit31_words_matches_jax():
    """Every edge lands on a parameter ≡ 31 (mod 32): each word of N(u) and
    S_i is a negative int32."""
    rng = np.random.default_rng(4)
    nu, nv = 200, 32 * 40
    cols = 32 * rng.integers(0, 40, size=3000) + 31
    g = j_from_edges(nu, nv, rng.integers(0, nu, size=3000), cols)
    kw = dict(k=8, backend="device_scan", refine_backend="device",
              block_size=64)
    want = j_partition(g, JConfig(**kw))
    got = partition(_port(g), ParsaConfig(**kw), device="cpu")
    assert (got.s_masks < 0).any()
    _assert_results_equal(got, want)


# --------------------------------------------------- warm starts
@pytest.mark.parametrize("backend", ["device_scan", "host_blocked_oracle"])
def test_refine_warm_start_from_jax_result(backend):
    """A JAX result carried across with result_from_numpy refines on the
    port exactly as it refines in JAX."""
    g1 = j_text_like(400, 800, mean_len=12, seed=3)
    g2 = j_text_like(300, 800, mean_len=12, seed=4)
    cfg = JConfig(k=8, backend=backend, block_size=64,
                  refine_backend="device")
    r1 = j_partition(g1, cfg)
    want = r1.refine(g2)
    carried = result_from_numpy(r1.parts_u, r1.parts_v, r1.s_masks, 8,
                                g1.num_v, cfg, device="cpu")
    assert carried.config.backend == backend
    got = carried.refine(_port(g2))
    _assert_results_equal(got, want)


def test_refine_warm_start_dense_and_packed_agree():
    g1 = _port(j_text_like(400, 800, mean_len=12, seed=3))
    g2 = _port(j_text_like(300, 800, mean_len=12, seed=4))
    cfg = ParsaConfig(k=8, block_size=64, refine_backend="device")
    r1 = partition(g1, cfg, device="cpu")
    before = r1.s_masks.copy()
    packed = r1.refine(g2)
    dense = partition(g2, cfg, init_sets=r1.neighbor_sets, device="cpu")
    _assert_results_equal(packed, dense)
    assert np.array_equal(r1.s_masks, before)  # never mutated in place
    with pytest.raises(ValueError, match="same parameter side"):
        r1.refine(_port(j_text_like(30, 801, mean_len=5, seed=0)))


# ------------------------------------------------- copied generators
@pytest.mark.parametrize("seed", [0, 9])
def test_generators_match_jax_package(seed):
    pairs = [(text_like(500, 900, mean_len=15, seed=seed),
              j_text_like(500, 900, mean_len=15, seed=seed)),
             (ctr_like(300, 2000, nnz_per_row=20, seed=seed),
              j_ctr_like(300, 2000, nnz_per_row=20, seed=seed))]
    for got, want in pairs:
        assert (got.num_u, got.num_v) == (want.num_u, want.num_v)
        assert np.array_equal(got.u_indptr, want.u_indptr)
        assert np.array_equal(got.u_indices, want.u_indices)
        assert got.u_indices.dtype == want.u_indices.dtype


def test_load_npz_reads_a_jax_saved_graph(tmp_path):
    from repro_torch.core import load_npz

    want = j_text_like(120, 300, mean_len=8, seed=1)
    want.save_npz(tmp_path / "g.npz")
    got = load_npz(tmp_path / "g.npz")
    got.validate()
    assert (got.num_u, got.num_v) == (want.num_u, want.num_v)
    assert np.array_equal(got.u_indptr, want.u_indptr)
    assert np.array_equal(got.u_indices, want.u_indices)


# ----------------------------------------------------------- config
def test_config_validation():
    for bad, match in [(dict(k=0), "k must"), (dict(k=4, backend="nope"),
                                                 "unknown Parsa backend"),
                       (dict(k=4, block_size=12), "block_size"),
                       (dict(k=4, sweeps=0), "sweeps"),
                       (dict(k=4, refine_backend="gpu"), "refine_backend"),
                       (dict(k=4, refine_chunk=100), "refine_chunk")]:
        with pytest.raises(ValueError, match=match):
            ParsaConfig(**bad)
    assert not hasattr(ParsaConfig(k=4), "use_kernel")
    assert sorted(api.BACKENDS) == ["device_scan", "host",
                                    "host_blocked_oracle", "parallel_device",
                                    "parallel_sim"]


# ------------------------------------------------------------ guards
def test_public_names_match_jax_facade():
    """``repro_torch.api`` exports every name of ``repro.api``
    (``register_backend`` and the serving and autoscaler surface
    included), and each resolves."""
    import repro.api as japi

    assert set(api.__all__) == set(japi.__all__)
    for name in api.__all__:
        assert getattr(api, name) is not None, name
    assert api.register_backend is \
        __import__("repro_torch.api_backends",
                   fromlist=["register_backend"]).register_backend
    from repro_torch import elastic, runtime, serving

    assert api.SLOAutoscaler is elastic.SLOAutoscaler
    assert api.ServingEngine is serving.ServingEngine
    assert api.TelemetrySnapshot is serving.TelemetrySnapshot
    assert runtime.CircuitBreaker.__module__ == "repro_torch.runtime.fault"


def test_import_leaves_no_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.convert, "
            "repro_torch.core.refine, repro_torch.graphs, repro_torch.sketch, "
            "repro_torch.kernels.parsa_cost.ops, "
            "repro_torch.kernels.flash_attention, repro_torch.models.model, "
            "repro_torch.models.moe, "
            "repro_torch.launch.serve, repro_torch.launch.steps, "
            "repro_torch.launch.mesh, "
            "repro_torch.serving, repro_torch.configs, repro_torch.stream, "
            "repro_torch.obs, repro_torch.core.placement, "
            "repro_torch.core.moe_placement, repro_torch.data, "
            "repro_torch.elastic, repro_torch.runtime, repro_torch.ml, "
            "repro_torch.configs.parsa_paper, repro_torch.serving.engine, "
            "repro_torch.serving.router, repro_torch.serving.telemetry, "
            "repro_torch.elastic.autoscaler, repro_torch.runtime.fault;"
            "[getattr(repro_torch.api, n) for n in repro_torch.api.__all__];"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_names_no_jax_or_repro_module():
    """chip_smoke.py imports neither JAX nor ``repro``: the reference
    package appears only as file paths in ``KERNELS`` (what each CUDA
    kernel replaces)."""
    import ast

    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
    kernels = next(n for n in tree.body if isinstance(n, ast.Assign)
                   and any(getattr(t, "id", None) == "KERNELS"
                           for t in n.targets))
    rest = text.replace(ast.get_source_segment(text, kernels), "")
    assert "repro." not in rest.replace("repro_torch.", "")
    assert "src/repro/" not in rest
    for replaces, source in ast.literal_eval(kernels.value).values():
        assert replaces.startswith("src/repro/kernels/")
        assert source.startswith("src/repro_torch/")
        assert (ROOT / source).is_file() and \
            (ROOT / replaces.split(":")[0]).is_file()


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = text_like(50, 100, mean_len=5, seed=0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        partition(g, ParsaConfig(k=4, block_size=64))
