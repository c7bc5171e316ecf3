"""The port's serving path against the JAX package's.

* Greedy decode through the serving engine on the setup of
  ``tests/test_serving.py`` (``test_decode_engine_matches_oracle``: reduced
  qwen3-14b, the JAX model's weights from ``PRNGKey(0)``, a (2, 6) prompt,
  4 new tokens).  Greedy tokens must be equal, so each test also reports
  the smallest top-2 logit margin of the steps it compares: a margin below
  the logits' error would make equality luck, and the test says so instead
  of passing.
* The PS request loop (``tests/test_serving.py:61-229``): the same seeded
  graph, labels, placement, mix, chaos and configs through
  ``repro.serving`` and ``repro_torch.serving`` on the CPU.  Every integer
  and modeled field of every ``RequestRecord`` (homes, examples, tokens,
  fresh/stale entries, pull and push bytes, modeled wire, retry, virtual
  queue and latency), the chaos events, the dispatch records and the
  elastic ops must be equal; the served weights ``w`` agree within
  ``REL`` = 1e-5 relative to their largest magnitude (the sigmoid's
  ``exp`` and the loss's ``logaddexp`` are not XLA's, so the port's
  floats may differ in their last bits).  Wall-clock fields (measured
  latency, blocked and compute seconds, the wall queue) are the run's own
  and are checked, as in the reference, by property only.

The helpers here (``Pkg``, ``records``, ``same_records``, ``close``,
``two_tenants``) are shared with
``tests/test_torch_autoscaler.py`` and ``tests/test_torch_obs.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.elastic as jelastic
import repro.ml as jml
import repro.runtime as jruntime
import repro.serving as jserving
import repro_torch.api as tapi
import repro_torch.elastic as telastic
import repro_torch.ml as tml
import repro_torch.runtime as truntime
import repro_torch.serving as tserving
from repro import obs as jobs
from repro.configs import get_config as jax_config
from repro.core import random_parts
from repro.core.jax_partition import dispatch_counter as j_dispatch_counter
from repro.graphs import ctr_like
from repro.launch.serve import decode_loop as jax_decode_loop
from repro.launch.serve import decode_loop_engine as jax_decode_loop_engine
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.convert import graph_from_numpy, model_params_from_numpy
from repro_torch.core.dispatch import dispatch_counter as t_dispatch_counter
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.serving import ReadyHandle, Request, ServingEngine

REL = 1e-5
K = 4


# ------------------------------------------------------------ the two stacks
class Pkg(types.SimpleNamespace):
    """One package's serving stack: ``Pkg.of(port)`` holds the modules,
    the graph in that package's type, and the keyword that puts a session
    or cluster on the CPU (the port's ``device``; the JAX package's
    ``use_kernel=False`` goes into ``ParsaConfig``)."""

    @classmethod
    def of(cls, port: bool, g=None):
        if port:
            ns = cls(port=True, api=tapi, elastic=telastic, ml=tml,
                     runtime=truntime, serving=tserving, obs=tobs,
                     dispatch_counter=t_dispatch_counter,
                     dev={"device": "cpu"}, scan={})
        else:
            ns = cls(port=False, api=japi, elastic=jelastic, ml=jml,
                     runtime=jruntime, serving=jserving, obs=jobs,
                     dispatch_counter=j_dispatch_counter, dev={},
                     scan={"use_kernel": False})
        if g is not None:
            ns.g = (graph_from_numpy(g.num_u, g.num_v, g.u_indptr,
                                     g.u_indices) if port else g)
        return ns

    def __getattr__(self, name):
        # every public class of the stack by its name
        for mod in (self.serving, self.elastic, self.runtime, self.ml,
                    self.api):
            if hasattr(mod, name):
                return getattr(mod, name)
        raise AttributeError(name)

    def parsa(self, **kw):
        return self.api.ParsaConfig(**kw, **self.scan)

    def session(self, k=K, min_k=2, max_k=None, policy=None, obs=None):
        """An ``ElasticSession`` at ``k`` fed the whole graph once."""
        scfg = self.api.ParsaStreamConfig(base=self.parsa(
            k=k, backend="device_scan", refine_v=False, seed=0))
        sess = self.ElasticSession(
            self.ElasticConfig(stream=scfg, min_k=min_k,
                               max_k=k + 4 if max_k is None else max_k),
            num_v=self.g.num_v, policy=policy, obs=obs, **self.dev)
        sess.feed(self.g)
        return sess

    def cluster(self, labels, parts_u=None, parts_v=None, bandwidth=2.5e5,
                k=K):
        """``tests/test_serving.py``'s cluster: random placements, DBPG
        without compression or KKT filter, ``w`` drawn from seed 1."""
        n_u, n_v = self.g.num_u, self.g.num_v
        if parts_u is None:
            parts_u = random_parts(n_u, k, 0)
        if parts_v is None:
            parts_v = random_parts(n_v, k, 1)
        dcfg = self.DBPGConfig(lam=0.05, lr=0.1, kkt_eps=0.0, compress=False,
                               error_feedback=False)
        cl = self.PSCluster(self.g, labels, np.asarray(parts_u).copy(),
                            np.asarray(parts_v).copy(), k, dcfg,
                            bandwidth=bandwidth, **self.dev)
        cl.commit_weights(np.random.default_rng(1).normal(
            0, 0.1, n_v).astype(np.float32))
        return cl


def two_tenants(pkg):
    """The heavy/light mix of ``tests/test_autoscaler.py`` and
    ``tests/test_obs.py``: a 3:1 weight split, distinct hot sets."""
    return pkg.RequestMix((
        pkg.ZipfWorkload("heavy", batch=24, zipf_s=1.1, weight=3.0),
        pkg.ZipfWorkload("light", batch=16, zipf_s=1.3, hot_offset=7,
                         weight=1.0),
    ))


def host_w(cluster) -> np.ndarray:
    w = cluster.w
    return w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def close(got, want, what: str) -> None:
    """``got`` within ``REL`` of ``want`` relative to ``want``'s largest
    magnitude (the measure of ``tests/test_torch_ps.py``: a coordinate the
    soft threshold leaves near 0 carries the vector's rounding, not its
    own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0.0)) <= REL * scale, what


def records(engine) -> list[tuple]:
    """Every deterministic field of the engine's request records."""
    return [(r.tenant, r.step, r.home, r.examples, r.tokens, r.warmup,
             r.fresh_entries, r.stale_entries, r.pull_inter_bytes,
             r.push_inter_bytes, r.wire_s, r.wait_s, r.modeled_s)
            for r in engine.recorder.records]


def dispatch_records(counts) -> list[tuple]:
    return [(r.phase, r.nbytes, dict(r.meta)) for r in counts.records]


def same_records(jeng, teng, jcl=None, tcl=None) -> None:
    """Two engines served the same requests: records, shed counts and
    (given the clusters) traffic meters equal, ``w`` within ``REL``."""
    assert records(teng) == records(jeng)
    assert teng.recorder.shed == jeng.recorder.shed
    if jcl is not None:
        assert tcl.placement_version == jcl.placement_version
        assert (tcl.meter.inner_bytes, tcl.meter.inter_bytes) == \
            (jcl.meter.inner_bytes, jcl.meter.inter_bytes)
        assert np.array_equal(tcl.meter.per_machine, jcl.meter.per_machine)
        close(host_w(tcl), host_w(jcl), "w")


@pytest.fixture(scope="module")
def serving_graph():
    g = ctr_like(600, 1200, nnz_per_row=12, clusters=8, locality=0.85,
                 seed=0)
    labels = np.where(np.random.default_rng(0).random(g.num_u) < 0.5,
                      1.0, -1.0).astype(np.float32)
    return g, labels


PROMPT_LEN, GEN = 6, 4
CACHE_SEQ = PROMPT_LEN + GEN


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3-14b").reduced()
    jm, jstep = jax_make_serve_step(jcfg)
    jstep = jax.jit(jstep)
    jp = jm.init(jax.random.PRNGKey(0))
    prompt = np.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, PROMPT_LEN)), np.int32)
    ref = jax_decode_loop(jm, jstep, jp, prompt, gen=GEN, cache_seq=CACHE_SEQ)
    _, jsum = jax_decode_loop_engine(jm, jstep, jp, prompt, gen=GEN,
                                     cache_seq=CACHE_SEQ, prefetch=True)
    cfg = get_config("qwen3-14b").reduced()
    model, step = make_serve_step(cfg, "cpu")
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return dict(jm=jm, jstep=jstep, jp=jp, prompt=prompt, ref=ref, jsum=jsum,
                cfg=cfg, model=model, step=step, params=params)


def _min_margin(step, params, model, prompt):
    """Smallest top-2 logit margin over the generated steps (port)."""
    cache = model.init_cache(prompt.shape[0], CACHE_SEQ)
    tok = torch.from_numpy(prompt[:, :1])
    margins = []
    for t in range(PROMPT_LEN - 1 + GEN):
        if t < PROMPT_LEN:
            tok = torch.from_numpy(prompt[:, t:t + 1])
        nxt, logits, cache = step(params, {"token": tok, "pos": t,
                                           "cache": cache})
        if t >= PROMPT_LEN - 1:
            top2 = logits.topk(2, dim=-1).values
            margins.append(float((top2[:, 0] - top2[:, 1]).min()))
            tok = nxt[:, None]
    return min(margins)


def test_decode_loop_matches_jax(setup):
    s = setup
    got = S.decode_loop(s["model"], s["step"], s["params"], s["prompt"],
                        gen=GEN, cache_seq=CACHE_SEQ)
    margin = _min_margin(s["step"], s["params"], s["model"], s["prompt"])
    print(f"smallest top-2 logit margin over the generated steps: {margin:.3e}")
    # the logits agree with JAX's to 1e-4 (tests/test_torch_models.py), so
    # a tie closer than that would make token equality a coin toss
    assert margin > 1e-4, f"near-tie: top-2 margin {margin:.3e}"
    np.testing.assert_array_equal(got, s["ref"])
    assert got.dtype == np.int32 and got.shape == (2, GEN)


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_matches_decode_loop_and_jax(setup, prefetch):
    s = setup
    own = S.decode_loop(s["model"], s["step"], s["params"], s["prompt"],
                        gen=GEN, cache_seq=CACHE_SEQ)
    out, summary = S.decode_loop_engine(
        s["model"], s["step"], s["params"], s["prompt"], gen=GEN,
        cache_seq=CACHE_SEQ, prefetch=prefetch)
    np.testing.assert_array_equal(out, own)     # bit-identical to the loop
    np.testing.assert_array_equal(out, s["ref"])
    assert summary["requests"] == s["jsum"]["requests"] == PROMPT_LEN - 1 + GEN
    assert summary["mode"] == ("async" if prefetch else "sync")
    assert set(summary["per_tenant"]) == set(s["jsum"]["per_tenant"]) \
        == {"prefill", "decode"}
    for name, row in summary["per_tenant"].items():
        assert row["requests"] == s["jsum"]["per_tenant"][name]["requests"]
    assert summary["tokens"] == s["jsum"]["tokens"]


def test_teacher_forcing(setup):
    """Prefill's last-position logits equal the decode step's at the last
    prompt position (tests/test_models.py:77-105 in JAX), float32 1e-4."""
    s = setup
    _, prefill = make_prefill_step(s["cfg"], "cpu")
    toks = torch.from_numpy(s["prompt"])
    full, pcache = prefill(s["params"], {"tokens": toks,
                                         "cache_seq": CACHE_SEQ})
    cache = s["model"].init_cache(2, CACHE_SEQ)
    for t in range(PROMPT_LEN):
        _, logits, cache = s["step"](s["params"], {
            "token": toks[:, t:t + 1], "pos": t, "cache": cache})
    torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["k"][:, :, :PROMPT_LEN],
                               pcache["k"][:, :, :PROMPT_LEN],
                               atol=1e-4, rtol=1e-4)


def test_serve_main_on_the_cpu(capsys):
    out = S.main(["--arch", "qwen3-14b", "--reduce", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 3)
    assert (out >= 0).all() and (out < 256).all()
    assert "tok/s" in capsys.readouterr().out


def test_model_init_is_seeded_with_the_reference_scales():
    cfg = get_config("qwen3-14b").reduced()
    model, _ = make_serve_step(cfg, "cpu")
    a, b, c = model.init(0), model.init(0), model.init(1)
    torch.testing.assert_close(a["stack"][1]["mlp"]["wd"],
                               b["stack"][1]["mlp"]["wd"], atol=0, rtol=0)
    assert not torch.equal(a["embed"], c["embed"])
    jp = jax_config("qwen3-14b").reduced()
    from repro.models.model import build_model as jax_build
    shapes = jax.tree.map(lambda x: x.shape[1:], jax.eval_shape(
        jax_build(jp).init, jax.random.PRNGKey(0))["stack"])
    for name, leaf in a["stack"][0]["attn"].items():
        assert tuple(leaf.shape) == shapes["attn"][name], name
    # std 1/sqrt(fan_in): wq (D, H, hd) has fan_in D = 64
    assert abs(float(a["stack"][0]["attn"]["wq"].std()) - 1 / 8) < 0.01
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_engine_sheds_and_refuses_a_tracer():
    """Admission sheds through the engine; a source that carries a tracer
    (``obs``) is no longer refused — the engine installs it for the run
    and each served request opens a ``request`` span (the name dates from
    the slice that refused it)."""
    class Src:
        obs = None

        def __init__(self):
            self.served = []

        def on_step(self, t):
            pass

        def next_request(self, t):
            return Request(tenant="a" if t % 2 else "b", home=0, rows=None,
                           batch=None, need=None, examples=1, tokens=3)

        def admit(self, req):
            return req.tenant == "a"

        def issue(self, req, t):
            h = ReadyHandle(torch.tensor([t]))
            if self.obs is not None:
                h._span = self.obs.tracer.begin("request", v_start=float(t),
                                                track="home0", step=t)
            return h

        def compute(self, req, payload):
            return payload * 2

        def commit(self, req, out, t):
            self.served.append(int(out))
            return {}

    src = Src()
    summary = ServingEngine(src, prefetch=True).run(6)
    assert src.served == [2, 6, 10]
    assert summary["requests"] == 3 and summary["shed_per_tenant"] == {"b": 3}
    assert summary["tokens"] == 9
    src = Src()
    src.obs = tobs.Observability()
    engine = ServingEngine(src, prefetch=False)
    assert engine.obs is src.obs
    summary = engine.run(6)
    assert src.served == [2, 6, 10] and summary["requests"] == 3
    roots = [sp for sp in src.obs.tracer.spans if sp.name == "request"]
    assert [sp.attrs["step"] for sp in roots] == [1, 3, 5]
    for root in roots:
        kids = [sp.name for sp in src.obs.tracer.spans
                if sp.parent_id == root.span_id]
        assert kids == ["pull", "compute", "push"]
    assert tobs.trace._ACTIVE == []        # uninstalled after the run


# ------------------------------------------------------- the PS request loop
def _mix(pkg, batch=32):
    return pkg.RequestMix((pkg.ZipfWorkload("t", batch=batch, zipf_s=1.1),))


def _engine(pkg, labels, prefetch, bandwidth=2.5e5, chaos=None,
            elastic=None, warmup=2, retry=None, parts=None):
    """``tests/test_serving.py``'s ``_engine`` in package ``pkg``."""
    parts = parts if parts is not None else (None, None)
    cluster = pkg.cluster(labels, parts_u=parts[0], parts_v=parts[1],
                          bandwidth=bandwidth)
    cfg = pkg.ServingConfig(prefetch=prefetch, warmup=warmup, seed=0,
                            pad_multiple=512,
                            **({"retry": retry} if retry else {}))
    source = pkg.PSRequestSource(cluster, _mix(pkg), cfg, chaos=chaos,
                                 elastic=elastic)
    return pkg.ServingEngine(source), source, cluster


def _both(serving_graph):
    g, labels = serving_graph
    return Pkg.of(False, g), Pkg.of(True, g), labels


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_smoke_one_dispatch_per_request(serving_graph, prefetch):
    """One ``serving_pull`` and one ``serving_compute`` dispatch a request,
    labeled as in JAX (the compute's ``cache_miss`` label is JAX's alone:
    the port compiles nothing per shape); records and ``w`` as in JAX."""
    jp, tp, labels = _both(serving_graph)
    n, warmup = 10, 2
    runs = []
    for pkg in (jp, tp):
        engine, src, cl = _engine(pkg, labels, prefetch, warmup=warmup)
        with pkg.dispatch_counter() as counts:
            s = engine.run(n)
        runs.append((engine, cl, counts, s))
    (je, jc, jcounts, js), (te, tc, tcounts, ts) = runs
    same_records(je, te, jc, tc)
    jrec = [(p, b, {k: v for k, v in m.items() if k != "cache_miss"})
            for p, b, m in dispatch_records(jcounts)]
    assert dispatch_records(tcounts) == jrec
    assert dict(tcounts) == dict(jcounts)
    phases = [r.phase for r in tcounts.records]
    assert phases.count("serving_pull") == n
    assert phases.count("serving_compute") == n
    for r in tcounts.records:
        if r.phase == "serving_pull":
            assert "home" in r.meta and r.nbytes >= 0
        elif r.phase == "serving_compute":
            assert r.nbytes > 0 and r.meta.get("tokens", 0) > 0
    assert ts["mode"] == js["mode"] == ("async" if prefetch else "sync")
    for key in ("requests", "examples", "tokens", "pull_inter_bytes",
                "push_inter_bytes", "stale_entries"):
        assert ts[key] == js[key], key
    assert ts["requests"] == n - warmup
    assert ts["examples"] == 32 * (n - warmup)
    assert ts["tokens"] > 0 and ts["wall_s"] > 0
    assert ts["p99_ms"] >= ts["p50_ms"] > 0
    assert ts["pull_inter_bytes"] > 0 and ts["push_inter_bytes"] > 0
    assert ts["stale_entries"] == 0


def test_async_overlap_is_measured_not_assumed(serving_graph):
    """Wire-dominated link (5e4 B/s): the port's async run hides the
    transfer behind compute — ``blocked_s`` collapses while ``wire_s``
    stays.  The modeled wire of both modes equals JAX's; the wall-clock
    comparison gets best-of-3, as in the reference."""
    jp, tp, labels = _both(serving_graph)
    bw = 5e4
    want = {}
    for prefetch in (False, True):
        engine, _, _ = _engine(jp, labels, prefetch=prefetch, bandwidth=bw)
        engine.run(12)
        want[prefetch] = records(engine)
    last = None
    for _ in range(3):
        engine_s, _, _ = _engine(tp, labels, prefetch=False, bandwidth=bw)
        engine_a, _, _ = _engine(tp, labels, prefetch=True, bandwidth=bw)
        sync = engine_s.run(12)
        asyn = engine_a.run(12)
        assert records(engine_s) == want[False]
        assert records(engine_a) == want[True]
        assert asyn["wire_s"] == pytest.approx(sync["wire_s"], rel=0.5)
        assert asyn["hidden_s"] > 0
        if (asyn["blocked_s"] < sync["blocked_s"] * 0.8
                and asyn["wall_s"] < sync["wall_s"]):
            return
        last = (asyn["blocked_s"], sync["blocked_s"],
                asyn["wall_s"], sync["wall_s"])
    pytest.fail("async never hid the wire in 3 attempts: "
                f"blocked {last[0]:.4f}s vs sync {last[1]:.4f}s, "
                f"wall {last[2]:.4f}s vs sync {last[3]:.4f}s")


def modeled_hidden(engine) -> list[float]:
    """The modeled pull time hidden behind compute, a request, read from
    the engine's own records: in async mode request t's pull (its modeled
    wire, retry penalty and virtual-link queue: ``modeled_s`` less the
    modeled service slot) is issued when request t-1's service slot
    begins, so up to one slot of it (``service_model_s``) ticks behind
    that compute; request 0's, issued before the loop, hides none, and
    nothing hides in sync mode.  Every term is on the virtual clock: the
    host's scheduling cannot move it."""
    svc = engine.source.config.service_model_s
    return [min(r.modeled_s - svc, svc) if engine.prefetch and r.step > 0
            else 0.0 for r in engine.recorder.records]


def test_async_overlap_read_from_the_records(serving_graph):
    """Beside the wall-clock check above (ROADMAP Queue 3 item 4): on the
    same wire-dominated link the overlap read from the records
    (``modeled_hidden``) equals JAX's request by request, bit for bit; the
    async run hides a positive modeled pull time behind every request's
    compute past the first (each pull outlasts its slot here, so a whole
    slot), the sync run none."""
    jp, tp, labels = _both(serving_graph)
    bw, n = 5e4, 12
    got = {}
    for pkg in (jp, tp):
        for prefetch in (False, True):
            engine, src, _ = _engine(pkg, labels, prefetch=prefetch,
                                     bandwidth=bw)
            engine.run(n)
            got[pkg.port, prefetch] = (records(engine),
                                       modeled_hidden(engine))
    svc = src.config.service_model_s
    for prefetch in (False, True):
        assert got[True, prefetch] == got[False, prefetch], prefetch
    assert got[True, False][1] == [0.0] * n
    hidden = got[True, True][1]
    assert hidden[0] == 0.0 and hidden[1:] == [svc] * (n - 1), hidden


def test_update_propagates_between_requests(serving_graph):
    """Serving is online DBPG: commits move the server weights, to the
    same ``w`` as JAX's within ``REL``; ``update=False`` leaves them."""
    jp, tp, labels = _both(serving_graph)
    runs = []
    for pkg in (jp, tp):
        engine, src, cl = _engine(pkg, labels, prefetch=True)
        w0 = host_w(cl).copy()
        engine.run(6)
        assert not np.array_equal(host_w(cl), w0)
        runs.append((engine, cl))
    same_records(runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    cl = tp.cluster(labels)
    w0 = host_w(cl).copy()
    src = tp.PSRequestSource(cl, _mix(tp), tp.ServingConfig(
        update=False, warmup=0, pad_multiple=512))
    tp.ServingEngine(src).run(4)
    assert np.array_equal(host_w(cl), w0)


def test_retry_policy_admission():
    for pkg in (Pkg.of(False), Pkg.of(True)):
        p = pkg.RetryPolicy(timeout_s=0.05, retries=1, backoff=2.0)
        assert p.admit(0.01) == (True, 0.0)
        ok, wait = p.admit(0.07)
        assert ok and wait == pytest.approx(0.05)
        ok, wait = p.admit(float("inf"))
        assert not ok and wait == pytest.approx(p.budget_s)
        assert p.budget_s == pytest.approx(0.15)
        with pytest.raises(ValueError):
            pkg.RetryPolicy(timeout_s=0.0)
        with pytest.raises(ValueError):
            pkg.RetryPolicy(backoff=0.5)
        with pytest.raises(ValueError):
            pkg.RetryPolicy(retries=-1)
    jr, tr = jruntime.RetryPolicy(0.003, 3, 1.5), truntime.RetryPolicy(
        0.003, 3, 1.5)
    for wire in (0.0, 0.002, 0.004, 0.006, 0.01, 0.02, float("inf")):
        assert tr.admit(wire) == jr.admit(wire)
    assert tr.budget_s == jr.budget_s
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


def test_kill_mid_serve_falls_back_to_stale(serving_graph):
    """A shard killed mid-serve does not stall the engine: its links fail
    their retry budget once, the circuit opens, and requests keep serving
    stale — the same requests, bytes and stale entries as JAX's."""
    jp, tp, labels = _both(serving_graph)
    runs = []
    for pkg in (jp, tp):
        chaos = pkg.ChaosSchedule([pkg.ChaosEvent(feed=3, kind="kill",
                                                  machine=1)], seed=0)
        retry = pkg.RetryPolicy(timeout_s=0.002, retries=1)
        engine, src, cl = _engine(pkg, labels, prefetch=True, chaos=chaos,
                                  retry=retry)
        runs.append((engine, src, cl, engine.run(12), retry))
    (je, jsrc, jc, js, _), (te, tsrc, tc, ts, retry) = runs
    same_records(je, te, jc, tc)
    assert tsrc.events == jsrc.events
    assert (tsrc.dead, tsrc.suspect) == (jsrc.dead, jsrc.suspect)
    assert tsrc.breaker.open_links() == jsrc.breaker.open_links()
    assert tsrc.dead == {1} and 1 in tsrc.suspect
    assert ts["stale_entries"] == js["stale_entries"] > 0
    assert ts["requests"] == 10
    assert (3, "kill", 1) in tsrc.events
    assert ts["wait_s"] == js["wait_s"]
    assert ts["wait_s"] <= retry.budget_s + 1e-9


def test_straggler_inflates_wire_then_recovers(serving_graph):
    jp, tp, labels = _both(serving_graph)
    runs = []
    for pkg in (jp, tp):
        chaos = pkg.ChaosSchedule([
            pkg.ChaosEvent(feed=2, kind="straggle", machine=1, factor=50.0),
            pkg.ChaosEvent(feed=8, kind="recover", machine=1),
        ], seed=0)
        engine, src, cl = _engine(pkg, labels, prefetch=False,
                                  bandwidth=1e6, chaos=chaos)
        engine.run(12)
        runs.append((engine, src, cl))
    same_records(runs[0][0], runs[1][0], runs[0][2], runs[1][2])
    engine, src, _ = runs[1]
    assert np.array_equal(src.straggle, runs[0][1].straggle)
    assert src.straggle[1] == 1.0
    recs = engine.recorder.records
    slow = [r.wire_s for r in recs if 2 <= r.step < 8 and r.home != 1]
    fast = [r.wire_s for r in recs if r.step >= 8]
    assert max(slow) > max(fast)


def test_elastic_repair_under_load(serving_graph):
    """Kill with an ``ElasticSession`` attached: the warm repair (one
    ``elastic_repair_scan``) re-places the lost shard's rows as in JAX,
    and the new placement reaches the router via ``placement_version``."""
    jp, tp, labels = _both(serving_graph)
    runs = []
    for pkg in (jp, tp):
        es = pkg.session(max_k=64)
        cl = pkg.cluster(labels, parts_u=np.asarray(es.parts).copy())
        chaos = pkg.ChaosSchedule([pkg.ChaosEvent(feed=3, kind="kill",
                                                  machine=2)], seed=0)
        cfg = pkg.ServingConfig(prefetch=True, warmup=2, seed=0,
                                pad_multiple=512)
        src = pkg.PSRequestSource(cl, _mix(pkg), cfg, chaos=chaos,
                                  elastic=es)
        engine = pkg.ServingEngine(src)
        v0 = cl.placement_version
        with pkg.dispatch_counter() as counts:
            s = engine.run(10)
        runs.append((engine, src, cl, es, s, v0, counts))
    (je, jsrc, jc, jes, js, _, jcounts), (te, tsrc, tc, tes, ts, v0,
                                         tcounts) = runs
    same_records(je, te, jc, tc)
    assert np.array_equal(tc.parts_u, jc.parts_u)
    assert np.array_equal(tc.parts_v, jc.parts_v)
    assert np.array_equal(tc.owner, jc.owner)
    assert [(o.kind, o.machine, o.moved_u, o.committed) for o in tes.ops] \
        == [(o.kind, o.machine, o.moved_u, o.committed) for o in jes.ops]
    assert tcounts["elastic_repair_scan"] == jcounts["elastic_repair_scan"] \
        == 1
    assert tsrc.dead == set()
    assert tc.placement_version > v0
    assert tsrc.router.version == tc.placement_version
    assert ts["requests"] == 8
    assert len(tes.ops) == 1 and tes.ops[0].kind == "repair"


def test_router_pools_and_routing(serving_graph):
    jp, tp, labels = _both(serving_graph)
    out = []
    for pkg in (jp, tp):
        cluster = pkg.cluster(labels)
        r = pkg.Router(cluster)
        for m in range(K):
            assert np.array_equal(r.pools[m],
                                  np.flatnonzero(cluster.parts_u == m))
        homes = [r.next_home(dead={1}) for _ in range(6)]
        assert 1 not in homes and set(homes) == {0, 2, 3}
        rng = np.random.default_rng(0)
        rows = r.sample_rows(2, 64, rng, zipf_s=1.2, hot_offset=5)
        assert np.isin(rows, r.pools[2]).all()
        routed = (r.route(r.pools[3][:8], cluster.parts_u),
                  r.route(r.pools[3][:8], cluster.parts_u, dead={3}))
        assert routed[0] == 3 and routed[1] != 3
        assert not r.refresh(cluster)
        cluster.apply_placement(cluster.parts_u, cluster.parts_v)
        assert r.refresh(cluster)
        out.append((homes, rows.tolist(), routed, r.version))
    assert out[1] == out[0]            # same draws, same routes


def test_workload_validation():
    for pkg in (Pkg.of(False), Pkg.of(True)):
        with pytest.raises(ValueError):
            pkg.ZipfWorkload("t", batch=0)
        with pytest.raises(ValueError):
            pkg.ZipfWorkload("t", weight=0.0)
        with pytest.raises(ValueError):
            pkg.RequestMix(())
    mixes = [p.RequestMix((p.ZipfWorkload("a", weight=3.0),
                           p.ZipfWorkload("b", hot_offset=7)))
             for p in (Pkg.of(False), Pkg.of(True))]
    draws = [[m.sample(rng).name for _ in range(64)]
             for m, rng in zip(mixes, (np.random.default_rng(4),
                                       np.random.default_rng(4)))]
    assert draws[1] == draws[0]


def test_serve_step_matches_jax(serving_graph):
    """One served DBPG step on a padded request batch: gradient and
    updated ``w`` within ``REL`` of JAX's ``_serve_step``, zeros of the
    gradient (the push mask) equal, and the pulled buffer left as it was."""
    from repro.ml.lr import SparseBatch as JBatch
    from repro.serving.engine import _serve_step as j_serve_step
    from repro_torch.ml.lr import SparseBatch as TBatch
    from repro_torch.serving.engine import _serve_step as t_serve_step

    g, labels = serving_graph
    tg = graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)
    rng = np.random.default_rng(3)
    rows = rng.choice(g.num_u, size=40)
    w = rng.normal(0, 0.1, g.num_v).astype(np.float32)
    w[rng.random(g.num_v) < 0.3] = 0.0
    jb = JBatch.from_graph(g, rows, labels, pad_to=1024)
    tb = TBatch.from_graph(tg, rows, labels, pad_to=1024, device="cpu")
    need = np.zeros(g.num_v, bool)
    need[np.asarray(jb.col_ids)[:tb.nnz]] = True
    for update in (True, False):
        jw, jg, jl = j_serve_step(jb, jnp.asarray(w), jnp.asarray(need),
                                  lr=0.1, lam=0.05, update=update)
        buf = torch.from_numpy(w.copy())
        tw, tg_, tl = t_serve_step(tb, buf, torch.from_numpy(need),
                                   lr=0.1, lam=0.05, update=update)
        assert np.array_equal(buf.numpy(), w)
        close(tg_.numpy(), np.asarray(jg), "gradient")
        assert np.array_equal(tg_.numpy() != 0, np.asarray(jg) != 0)
        close(tw.numpy(), np.asarray(jw), "w")
        assert float(tl) == pytest.approx(float(jl), rel=REL)


def test_source_serves_on_its_clusters_device(serving_graph, monkeypatch):
    """The request source computes where its cluster lives: on the CPU
    every batch, buffer and output is a CPU tensor; a cluster asked for
    the card with none there raises, so no source falls back."""
    g, labels = serving_graph
    tp = Pkg.of(True, g)
    engine, src, cl = _engine(tp, labels, prefetch=False)
    assert src.device == cl.device == torch.device("cpu")
    req = src.next_request(0)
    handle = src.issue(req, 0)
    out = src.compute(req, handle.block())
    assert req.batch.values.device == handle.buffer.device == \
        torch.device("cpu")
    assert all(t.device == torch.device("cpu") for t in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tp.PSCluster(tp.g, labels, random_parts(g.num_u, K, 0),
                     random_parts(g.num_v, K, 1), K, tp.DBPGConfig())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_closed_loop_equals_the_cpu(cuda_device, serving_graph):
    """The reduced closed loop of ``tests/test_obs.py`` on the card: the
    CPU's request records, events and decisions; ``w`` within ``REL``."""
    from test_torch_obs import _closed_loop_run

    g, labels = serving_graph
    tp = Pkg.of(True, g)
    runs = []
    for device in ("cpu", cuda_device):
        tp.dev = {"device": device}
        runs.append(_closed_loop_run(tp, labels, tobs.Observability()))
    (ce, csrc, _, casc, _), (ge, gsrc, _, gasc, _) = runs
    same_records(ce, ge, csrc.cluster, gsrc.cluster)
    assert gsrc.events == csrc.events
    assert [d for _, d in gasc.decisions] == [d for _, d in casc.decisions]
