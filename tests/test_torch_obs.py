"""The port's observability core against the JAX package's: the same
scripted spans and events, the same seeded stream feeds traced with
``StreamSession(obs=...)``, and the same traced closed serving loop
(``tests/test_obs.py``'s) export byte-identical Chrome traces (but the
served losses, within 1e-5), recorder JSON, ``explain()`` text and
Prometheus text in both packages."""
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.api import ParsaConfig as JConfig
from repro.api import ParsaStreamConfig as JStreamConfig
from repro.api import StreamSession as JSession
from repro.core.jax_partition import dispatch_counter as j_dispatch_counter
from repro.graphs import ctr_like_stream as j_ctr_like_stream
from repro.graphs import text_like_stream as j_text_like_stream
from repro_torch import obs as tobs
from repro_torch.api import (
    Observability,
    ParsaConfig,
    ParsaStreamConfig,
    StreamSession,
    chrome_trace_json,
    prometheus_text,
)
from repro_torch.convert import graph_from_numpy
from repro_torch.core.dispatch import _count_dispatch, dispatch_counter
from test_torch_serving import REL, Pkg, records, same_records, two_tenants

BASE = dict(k=4, backend="device_scan", block_size=64, refine_v=False)


def _port(g):
    return graph_from_numpy(g.num_u, g.num_v, g.u_indptr, g.u_indices)


def _script_tracer(m):
    """The same spans, children, instants and installed-registry hooks
    through package ``m``'s obs module."""
    tr = m.Tracer(max_spans=64)
    root = tr.begin("request", v_dur=0.004, track="home2", wall_s=0.0123,
                    tenant="heavy", rows=24)
    pull = root.child("pull", 0.0, 0.0025, wall_s=0.002, bytes=4096)
    pull.child("wire", 0.0, 0.002)
    pull.child("retry", 0.002, 0.0005, attempt=1)
    root.child("compute", 0.0025, 0.001, track="compute")
    root.set(v_dur=0.0041, wall_s=0.013, late=True)
    tr.push(root)
    with tr.installed():
        m.trace_instant("router_refresh", epoch=3)
        m.dispatch_instant("serving_pull", nbytes=512, meta={"k": 4})
        m.annotate_last_instant(cache_miss=True, worker=2)
    tr.pop()
    tr.set_time(1.5)
    tr.instant("orphan", shard=1)
    m.trace_instant("not_installed")     # no tracer installed: a no-op
    tr.advance(0.25)
    tr.begin("feed", track="stream", feed=0, frac=0.125)
    return tr


def test_scripted_tracer_exports_byte_identical():
    jt, tt = _script_tracer(jobs), _script_tracer(tobs)
    assert len(tt.spans) == len(jt.spans) == 9
    for wall in (False, True):
        assert tobs.chrome_trace_json(tt, include_wall=wall) == \
            jobs.chrome_trace_json(jt, include_wall=wall)
    assert tobs.to_chrome_trace(tt) == jobs.to_chrome_trace(jt)


def test_tracer_span_bound_and_registry():
    for m in (jobs, tobs):
        tr = m.Tracer(max_spans=5)
        for i in range(12):
            tr.begin("s", i=i)
        assert [sp.attrs["i"] for sp in tr.spans] == [7, 8, 9, 10, 11]
        tr.install()
        tr.install()
        tr.uninstall()
        tr.uninstall()
        m.trace_instant("gone")
        assert len(tr.spans) == 5 and tr.spans[-1].name == "s"


def _script_recorder(m, torch_scalars=False):
    rec = m.FlightRecorder(maxlen=64)
    num = (lambda x: torch.tensor(x)) if torch_scalars else (lambda x: x)
    rec.record("chaos", step=4, data={"kind": "burst", "factor": 3.0,
                                      "machine": None})
    rec.record("window", step=8, window=0, p99_ms=num(50.5), slo_ms=10.0,
               within=False)
    rec.record("chaos", step=10, data={"kind": "burst", "factor": 1.0,
                                       "machine": None})
    rec.record("chaos", step=11, data={"kind": "kill", "machine": 2,
                                       "factor": None})
    rec.record("chaos", step=12, data={"kind": "straggle", "machine": 1,
                                       "factor": 4.0})
    rec.record("window", step=16, window=1, p99_ms=30.0, slo_ms=10.0,
               within=False)
    rec.record("elastic_op", step=17,
               data={"kind": "repair", "committed": True, "machine": 2,
                     "k_before": 4, "k_after": 4,
                     "migration_bytes": num(128)})
    rec.record("chaos", step=20, data={"kind": "recover", "machine": 1})
    rec.record("window", step=24, window=2, p99_ms=12.0, slo_ms=10.0,
               within=False)
    rec.record("window", step=32, window=3, p99_ms=5.0, slo_ms=10.0)
    rec.record("window", step=40, window=4, p99_ms=None, slo_ms=None,
               within=False)
    rec.record("shed", step=41, tenant="light", backlog=np.int64(7),
               frac=np.float32(0.5))
    return rec


def test_recorder_json_and_explain_byte_identical(tmp_path):
    jr, tr = _script_recorder(jobs), _script_recorder(tobs)
    assert tr.to_json() == jr.to_json()
    for w in range(5):
        for lookback in (0, 1, 2):
            a, b = tr.explain(w, lookback), jr.explain(w, lookback)
            assert str(a) == str(b)
            assert (a.verdict, a.causes, a.evidence, a.attributed) == \
                (b.verdict, b.causes, b.evidence, b.attributed)
    with pytest.raises(KeyError):
        tr.explain(9)
    # torch scalars serialize as the Python numbers they hold
    assert _script_recorder(tobs, torch_scalars=True).to_json() == \
        jr.to_json()
    with pytest.raises(TypeError, match="not JSON-serializable"):
        tobs.recorder._json_default(torch.zeros(2))
    # a recorder saved by either package loads into the other
    jr.save(tmp_path / "j.json")
    tr.save(tmp_path / "t.json")
    assert tobs.FlightRecorder.load(tmp_path / "j.json").to_json() == \
        jobs.FlightRecorder.load(tmp_path / "t.json").to_json()


def _traced_stream(chunks, port: bool, **skw):
    """Feed ``chunks`` with the session's tracer installed around the
    feeds (so the dispatch instants land in it); returns (session, obs,
    dispatch log of the last feed)."""
    if port:
        ob = Observability()
        sess = StreamSession(ParsaStreamConfig(base=ParsaConfig(**BASE),
                                               **skw),
                             num_v=chunks[0].num_v, obs=ob, device="cpu")
        counter = dispatch_counter
        chunks = [_port(c) for c in chunks]
    else:
        ob = jobs.Observability()
        sess = JSession(JStreamConfig(base=JConfig(**BASE, use_kernel=False),
                                      **skw),
                        num_v=chunks[0].num_v, obs=ob)
        counter = j_dispatch_counter
    with ob.tracer.installed():
        for c in chunks[:-1]:
            sess.feed(c)
        with counter() as counts:
            sess.feed(chunks[-1])
    return sess, ob, counts


@pytest.mark.parametrize("kind", ["exact", "drift"])
def test_stream_feed_traces_byte_identical(kind, tmp_path):
    if kind == "exact":
        chunks = j_text_like_stream(600, 900, chunks=3, mean_len=10, seed=6)
        skw = dict(repartition="never")
    else:
        chunks = j_ctr_like_stream(900, 2000, chunks=4, nnz_per_row=12,
                                   churn=0.7, seed=1)
        skw = dict(drift_threshold=1.0, drift_min_feeds=1,
                   repartition_frac=0.02)
    js, jo, jc = _traced_stream(chunks, False, **skw)
    ts, to, tc = _traced_stream(chunks, True, **skw)
    got = chrome_trace_json(to.tracer, include_wall=False)
    assert got == jobs.chrome_trace_json(jo.tracer, include_wall=False)
    names = [sp.name for sp in to.tracer.spans]
    assert names.count("feed") == len(chunks)
    assert names.count("dispatch:stream_feed_scan") == len(chunks)
    if kind == "drift":
        assert ts.repartitions > 0
        assert "dispatch:partition_scan" in names and "repartition" in names
    # wall clocks were measured (ride along, excluded from the diff)
    assert any(sp.wall_s is not None for sp in to.tracer.spans)
    assert "wall_ms" in chrome_trace_json(to.tracer, include_wall=True)
    # Prometheus text of the session's traffic and the last feed's
    # dispatches
    assert prometheus_text(traffic=ts.traffic, dispatches=tc) == \
        jobs.prometheus_text(traffic=js.traffic, dispatches=jc)
    paths = to.save(tmp_path, include_wall=False)
    assert paths["trace"].read_text() == got + "\n"
    assert tobs.FlightRecorder.load(paths["events"]).to_json() == "[]"


def test_dispatch_counter_emits_instants_only_when_installed():
    tr = tobs.Tracer()
    _count_dispatch("outside", nbytes=8, k=2)
    assert len(tr.spans) == 0
    root = tr.begin("feed")
    tr.push(root)
    with tr.installed(), dispatch_counter() as counts:
        _count_dispatch("inside", nbytes=8, k=2)
    tr.pop()
    assert counts["inside"] == 1
    inst = tr.spans[-1]
    assert inst.name == "dispatch:inside" and inst.instant
    assert inst.parent_id == root.span.span_id
    assert inst.attrs == {"nbytes": 8, "k": 2}
    _count_dispatch("after", nbytes=8)
    assert len(tr.spans) == 2


def test_stream_without_obs_emits_no_spans_of_its_own():
    """``obs=None``: the feeds build no span tree; an installed tracer
    still receives the dispatch counter's instants, two a feed."""
    chunks = j_text_like_stream(200, 400, chunks=2, mean_len=8, seed=1)
    tr = tobs.Tracer()
    sess = StreamSession(ParsaStreamConfig(base=ParsaConfig(**BASE)),
                         num_v=400, device="cpu")
    with tr.installed():
        for c in chunks:
            sess.feed(_port(c))
    assert sess.obs is None
    assert [sp.name for sp in tr.spans] == [
        "dispatch:stream_feed_scan", "dispatch:stream_metrics"] * 2


def _traced_elastic(g, port: bool):
    """``tests/test_obs.py``'s traced elastic session: two feeds, then a
    warm repair of the largest part, with the tracer installed."""
    k = 16
    base = dict(k=k, backend="device_scan", refine_v=False, seed=0)
    if port:
        from repro_torch.api import ElasticConfig, ElasticSession

        ob = Observability()
        sess = ElasticSession(
            ElasticConfig(stream=ParsaStreamConfig(base=ParsaConfig(**base)),
                          min_k=2, max_k=k + 2),
            num_v=g.num_v, obs=ob, device="cpu")
        g = _port(g)
    else:
        from repro.elastic import ElasticConfig, ElasticSession

        ob = jobs.Observability()
        sess = ElasticSession(
            ElasticConfig(stream=JStreamConfig(
                base=JConfig(**base, use_kernel=False)),
                min_k=2, max_k=k + 2),
            num_v=g.num_v, obs=ob)
    assert sess.stream.obs is ob          # one hook covers the stack
    with ob.tracer.installed():
        sess.feed(g.slice_u(0, 400))
        sess.feed(g.slice_u(400, 800))
        op = sess.repair(int(np.argmax(np.bincount(sess.parts, minlength=k))),
                         mode="warm")
    return sess, ob, op


def test_elastic_op_spans_byte_identical():
    from repro.graphs import text_like as j_text_like

    g = j_text_like(800, 1024, mean_len=12, seed=0)
    js, jo, jop = _traced_elastic(g, port=False)
    ts, to, top = _traced_elastic(g, port=True)
    assert top.committed and jop.committed
    got = chrome_trace_json(to.tracer, include_wall=False)
    assert got == jobs.chrome_trace_json(jo.tracer, include_wall=False)
    feeds = [sp for sp in to.tracer.spans if sp.name == "feed"]
    assert len(feeds) == 2
    assert feeds[1].v_start == pytest.approx(feeds[0].v_start + 1.0)
    ops = [sp for sp in to.tracer.spans if sp.name == "elastic_op"]
    assert ops and ops[-1].attrs["kind"] == "repair"
    assert ops[-1].wall_s is not None
    kids = {sp.name for sp in to.tracer.spans
            if sp.parent_id == ops[-1].span_id}
    assert kids == {"plan", "scan", "migrate"}
    assert "dispatch:elastic_repair_scan" in [sp.name
                                              for sp in to.tracer.spans]
    assert prometheus_text(traffic=ts.traffic) == \
        jobs.prometheus_text(traffic=js.traffic)


# ------------------------------------------------ the traced serving loop
# ``tests/test_obs.py``'s closed loop (600 x 1,200, K=4, 96 slots, its
# burst/calm/kill/straggle/recover script), traced end to end.  The port's
# trace equals JAX's byte for byte but for the compute spans' ``loss``,
# which agrees within ``REL`` relative: the loss sums ``logaddexp`` terms
# whose last bits are XLA's in one package and ATen's in the other.

K_OBS = 4
N_SLOTS = 96


def _obs_chaos(pkg):
    return pkg.ChaosSchedule([
        pkg.ChaosEvent(feed=8, kind="burst", factor=2.5),
        pkg.ChaosEvent(feed=40, kind="burst", factor=1.0),
        pkg.ChaosEvent(feed=48, kind="kill"),
        pkg.ChaosEvent(feed=64, kind="straggle", machine=1, factor=4.0),
        pkg.ChaosEvent(feed=80, kind="recover", machine=1),
    ], seed=0)


def _closed_loop_run(pkg, labels, obs, chaos=True, n_slots=N_SLOTS):
    """One closed-loop run of package ``pkg`` on fresh state with ``obs``
    threaded through every layer by the config hooks."""
    slo_cfg = pkg.SLOConfig(slo_ms=16.0, window_requests=8, decide_every=8,
                            warmup_windows=1, patience=1, cooldown_windows=0,
                            min_k=K_OBS, max_k=K_OBS + 3, obs=obs)
    asc = pkg.SLOAutoscaler(slo_cfg)
    sess = pkg.session(k=K_OBS, min_k=K_OBS, max_k=K_OBS + 3, policy=asc)
    cfg = pkg.ServingConfig(
        prefetch=True, warmup=2, seed=0, pad_multiple=512,
        retry=pkg.RetryPolicy(timeout_s=0.004, retries=0),
        service_model_s=2e-3, max_backlog_s=0.1,
        window_requests=slo_cfg.window_requests, obs=obs)
    src = pkg.PSRequestSource(
        pkg.cluster(labels, parts_u=np.asarray(sess.parts), bandwidth=6e4),
        two_tenants(pkg), cfg, chaos=_obs_chaos(pkg) if chaos else None,
        elastic=sess, autoscaler=asc)
    engine = pkg.ServingEngine(src)
    with pkg.dispatch_counter() as counts:
        engine.run(n_slots)
    return engine, src, sess, asc, counts


def split_losses(trace_json: str) -> tuple[str, list]:
    """The trace with every span's ``loss`` attribute taken out, and the
    losses in span order."""
    import json

    doc = json.loads(trace_json)
    losses = [ev["args"].pop("loss") for ev in doc["traceEvents"]
              if "loss" in ev.get("args", {})]
    return json.dumps(doc, sort_keys=True, separators=(",", ":")), losses


def same_traces(got: str, want: str) -> int:
    """Byte-identical but for the losses, which agree within ``REL``;
    returns the number of losses compared."""
    g, gl = split_losses(got)
    w, wl = split_losses(want)
    assert g == w
    assert len(gl) == len(wl)
    np.testing.assert_allclose(gl, wl, rtol=REL, atol=0)
    return len(gl)


@pytest.fixture(scope="module")
def traced_runs():
    """The traced closed loop once in JAX and twice in the port."""
    from repro.graphs import ctr_like as j_ctr_like

    g = j_ctr_like(600, 1200, nnz_per_row=12, clusters=8, locality=0.85,
                   seed=0)
    labels = np.where(np.random.default_rng(0).random(g.num_u) < 0.5,
                      1.0, -1.0).astype(np.float32)
    jp, tp = Pkg.of(False, g), Pkg.of(True, g)
    jobs_, obs1, obs2 = jobs.Observability(), Observability(), Observability()
    jrun = _closed_loop_run(jp, labels, jobs_)
    run1 = _closed_loop_run(tp, labels, obs1)
    _closed_loop_run(tp, labels, obs2)
    return dict(jax=(jrun, jobs_), port=(run1, obs1), replay=obs2,
                labels=labels, pkgs=(jp, tp))


def test_seeded_replays_export_byte_identical_streams(traced_runs):
    """Two seeded replays of the port export byte-identical trace JSON and
    recorder streams, and both equal JAX's (its losses within ``REL``)."""
    (jrun, jo), (run, obs1) = traced_runs["jax"], traced_runs["port"]
    obs2 = traced_runs["replay"]
    assert len(obs1.tracer.spans) > 100
    assert chrome_trace_json(obs1.tracer) == chrome_trace_json(obs2.tracer)
    assert obs1.recorder.to_json() == obs2.recorder.to_json()
    assert any(sp.wall_s is not None for sp in obs1.tracer.spans)
    n = same_traces(chrome_trace_json(obs1.tracer),
                    jobs.chrome_trace_json(jo.tracer))
    assert n == len(run[0].recorder.records)
    assert obs1.recorder.to_json() == jo.recorder.to_json()
    same_records(jrun[0], run[0], jrun[1].cluster, run[1].cluster)
    assert [(r.phase, r.nbytes, {k: v for k, v in r.meta.items()
                                 if k != "cache_miss"})
            for r in jrun[4].records] == \
        [(r.phase, r.nbytes, r.meta) for r in run[4].records]


def test_trace_covers_every_layer(traced_runs):
    (_, obs), (_, jo) = traced_runs["port"], traced_runs["jax"]
    names = {sp.name for sp in obs.tracer.spans}
    assert names == {sp.name for sp in jo.tracer.spans}
    assert {"request", "pull", "compute", "push"} <= names
    assert {"ps.plan_pull", "ps.pull_nowait", "router.refresh"} <= names
    assert "elastic_op" in names
    assert any(n.startswith("dispatch:") for n in names)
    kinds = {ev.kind for ev in obs.recorder.events}
    assert {"chaos", "window", "elastic_op", "decision", "breaker_open"} \
        <= kinds
    assert kinds == {ev.kind for ev in jo.recorder.events}


def test_request_span_tree_nests_correctly(traced_runs):
    (_, obs) = traced_runs["port"]
    spans = list(obs.tracer.spans)
    by_id = {sp.span_id: sp for sp in spans}
    roots = [sp for sp in spans if sp.name == "request" and not sp.instant]
    assert roots
    eps = 1e-9
    for root in roots:
        kids = [sp for sp in spans
                if sp.parent_id == root.span_id and not sp.instant]
        assert {"pull", "compute", "push"} <= {sp.name for sp in kids}
        for sp in kids:
            assert sp.trace_id == root.trace_id
            assert sp.v_start >= root.v_start - eps
            assert sp.v_start + sp.v_dur <= root.v_start + root.v_dur + eps
        pull = next(sp for sp in kids if sp.name == "pull")
        compute = next(sp for sp in kids if sp.name == "compute")
        push = next(sp for sp in kids if sp.name == "push")
        assert compute.v_start == pytest.approx(
            pull.v_start + pull.v_dur, abs=1e-9)
        assert push.v_start == pytest.approx(
            compute.v_start + compute.v_dur, abs=1e-9)
        for sub in spans:
            if sub.parent_id == pull.span_id:
                assert sub.name in ("wire", "retry", "queue")
                assert sub.v_start >= pull.v_start - eps
                assert sub.v_start + sub.v_dur <= \
                    pull.v_start + pull.v_dur + eps
    for sp in spans:
        if sp.parent_id >= 0 and not sp.instant:
            parent = by_id[sp.parent_id]
            assert sp.v_start >= parent.v_start - eps
            assert sp.v_start + sp.v_dur <= \
                parent.v_start + parent.v_dur + eps


def test_explain_attributes_all_violated_windows(traced_runs):
    (run, obs), (jrun, jo) = traced_runs["port"], traced_runs["jax"]
    asc = run[3]
    slo_ms = asc.config.slo_ms
    violated = 0
    for i, (snap, _) in enumerate(asc.decisions):
        ex = obs.explain(i)
        assert str(ex) == str(jo.explain(i))
        assert (ex.verdict, ex.causes, ex.attributed) == \
            (jo.explain(i).verdict, jo.explain(i).causes,
             jo.explain(i).attributed)
        if i < asc.config.warmup_windows or snap.p99_ms <= slo_ms:
            assert ex.verdict == "within-slo" or ex.attributed
            continue
        violated += 1
        assert ex.verdict == "violated"
        assert ex.attributed, f"window {i} unattributed: {ex}"
        assert all(c["kind"] in tobs.CAUSE_KINDS for c in ex.causes)
        assert "VIOLATED" in str(ex) and "<-" in str(ex)
    assert violated >= 1, "chaos script never stressed the loop"
    assert len(asc.decisions) == len(jrun[3].decisions)


def test_perfetto_export_format(traced_runs, tmp_path):
    (_, obs) = traced_runs["port"]
    paths = obs.save(tmp_path, prefix="run")
    import json

    doc = json.loads(paths["trace"].read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert evs[0] == {"name": "process_name", "ph": "M", "pid": 0,
                      "args": {"name": "parsa virtual clock"}}
    tracks = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert "elastic" in tracks and any(t.startswith("home") for t in tracks)
    complete = [e for e in evs if e.get("ph") == "X"]
    instants = [e for e in evs if e.get("ph") == "i"]
    assert complete and instants
    for e in complete:
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert any("wall_ms" in e["args"] for e in complete)
    rec = tobs.FlightRecorder.load(paths["events"])
    assert rec.to_json() == obs.recorder.to_json()
    # the JAX package loads the port's snapshot to the same bytes
    assert jobs.FlightRecorder.load(paths["events"]).to_json() == \
        obs.recorder.to_json()


# --------------------------------------------------- explain() unit tests
def _window(rec, idx, step, p99, slo=10.0):
    rec.record("window", step=step, window=idx, p99_ms=p99, slo_ms=slo,
               within=p99 <= slo)


def test_explain_burst_interval_and_drain_lookback():
    out = []
    for m in (jobs, tobs):
        rec = m.FlightRecorder()
        rec.record("chaos", step=4, data={"kind": "burst", "factor": 3.0,
                                          "machine": None})
        _window(rec, 0, step=8, p99=50.0)
        rec.record("chaos", step=10, data={"kind": "burst", "factor": 1.0,
                                           "machine": None})
        _window(rec, 1, step=16, p99=30.0)
        _window(rec, 2, step=24, p99=5.0)
        ex0 = rec.explain(0)
        assert ex0.verdict == "violated" and ex0.attributed
        assert [c["kind"] for c in ex0.causes] == ["burst"]
        ex1 = rec.explain(1)
        assert ex1.attributed and ex1.causes[0]["kind"] == "burst"
        ex2 = rec.explain(2)
        assert ex2.verdict == "within-slo" and ex2.causes == []
        assert "within SLO" in str(ex2)
        out.append([str(rec.explain(i)) for i in range(3)]
                   + [rec.to_json()])
    assert out[1] == out[0]


def test_explain_kill_until_repair_then_migration():
    out = []
    for m in (jobs, tobs):
        rec = m.FlightRecorder()
        rec.record("chaos", step=5, data={"kind": "kill", "machine": 2,
                                          "factor": None})
        _window(rec, 0, step=8, p99=40.0)
        ex = rec.explain(0)
        assert [c["kind"] for c in ex.causes] == ["kill"]
        assert "not repaired" in ex.causes[0]["detail"]
        rec.record("elastic_op", step=9,
                   data={"kind": "repair", "committed": True, "machine": 2,
                         "k_before": 4, "k_after": 4,
                         "migration_bytes": 128})
        _window(rec, 1, step=16, p99=30.0)
        ex1 = rec.explain(1)
        assert sorted(c["kind"] for c in ex1.causes) == ["kill", "migration"]
        rec2 = m.FlightRecorder()
        rec2.record("elastic_op", step=3,
                    data={"kind": "grow", "committed": False, "machine": 1,
                          "k_before": 4, "k_after": 5})
        _window(rec2, 0, step=8, p99=40.0)
        assert rec2.explain(0).causes == []
        out.append((str(ex), str(ex1), str(rec2.explain(0)), rec.to_json()))
    assert out[1] == out[0]


def test_explain_unknown_window_raises():
    for m in (jobs, tobs):
        with pytest.raises(KeyError):
            m.FlightRecorder().explain(7)


def test_recorder_bounded_and_kwarg_collisions():
    out = []
    for m in (jobs, tobs):
        rec = m.FlightRecorder(maxlen=4)
        for i in range(10):
            rec.record("shed", step=i, tenant="t")
        assert len(rec) == 4
        assert [ev.step for ev in rec.events] == [6, 7, 8, 9]
        assert [ev.seq for ev in rec.events] == [6, 7, 8, 9]
        ev = rec.record("chaos", step=1, data={"kind": "burst", "step": 99},
                        factor=2.0)
        assert ev.kind == "chaos" and ev.step == 1
        assert ev.data == {"kind": "burst", "step": 99, "factor": 2.0}
        out.append(rec.to_json())
    assert out[1] == out[0]


# ----------------------------------------------------------- prometheus
def _without_wall(text: str) -> str:
    """Prometheus text minus the one wall-clock sample (the measured
    sliding-window p99)."""
    return "\n".join(line for line in text.splitlines()
                     if 'clock="measured"' not in line)


def test_prometheus_text_unifies_counters(traced_runs):
    texts = []
    for key, mod, counter in (("jax", jobs, j_dispatch_counter),
                              ("port", tobs, dispatch_counter)):
        (engine, src, sess, _, _), _ = traced_runs[key]
        with counter() as counts:
            pass
        texts.append(mod.prometheus_text(
            latency=engine.recorder, telemetry=src.telemetry,
            traffic=sess.traffic, meter=src.cluster.meter,
            dispatches=counts))
    text = texts[1]
    assert _without_wall(text) == _without_wall(texts[0])
    for fam in ("parsa_serving_requests_total", "parsa_serving_latency_ms",
                "parsa_telemetry_p99_ms", "parsa_telemetry_speed_ratio",
                "parsa_stream_migration_bytes_total",
                "parsa_ps_inter_bytes_total"):
        assert f"# TYPE {fam}" in text, fam
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name_labels, value = line.rsplit(" ", 1)
        float(value)
        assert name_labels.startswith("parsa_")
    assert 'stat="p99"' in text and 'clock="modeled"' in text
    # the closed loop's own dispatches, labeled alike
    (run, _), (jrun, _) = traced_runs["port"], traced_runs["jax"]
    assert prometheus_text(dispatches=run[4]) == \
        jobs.prometheus_text(dispatches=jrun[4])


def test_prometheus_dispatch_families():
    from repro.api import partition as j_partition
    from repro.graphs import text_like as j_text_like
    from repro_torch.api import partition as t_partition

    g = j_text_like(400, 512, mean_len=10, seed=0)
    with j_dispatch_counter() as jcounts:
        j_partition(g, JConfig(k=4, backend="device_scan", refine_v=False,
                               seed=0, use_kernel=False))
    with dispatch_counter() as counts:
        t_partition(_port(g), ParsaConfig(k=4, backend="device_scan",
                                          refine_v=False, seed=0),
                    device="cpu")
    text = prometheus_text(dispatches=counts)
    assert text == jobs.prometheus_text(dispatches=jcounts)
    assert 'parsa_dispatch_total{phase="partition_scan"} 1' in text
    assert 'parsa_dispatch_bytes_total{phase="partition_scan"}' in text


def test_dispatch_log_labeled_records_back_compat():
    from repro.api import partition as j_partition
    from repro.graphs import text_like as j_text_like
    from repro_torch.api import partition as t_partition
    from repro_torch.core.dispatch import DispatchLog

    g = j_text_like(400, 512, mean_len=10, seed=0)
    with j_dispatch_counter() as jcounts:
        j_partition(g, JConfig(k=4, backend="device_scan", refine_v=False,
                               seed=0, use_kernel=False))
    with dispatch_counter() as counts:
        t_partition(_port(g), ParsaConfig(k=4, backend="device_scan",
                                          refine_v=False, seed=0),
                    device="cpu")
    assert isinstance(counts, DispatchLog) and isinstance(counts, dict)
    assert counts["partition_scan"] == 1
    assert counts == dict(counts) == dict(jcounts)
    recs = [r for r in counts.records if r.phase == "partition_scan"]
    assert len(recs) == 1 and recs[0].nbytes > 0
    assert recs[0].meta.get("k") == 4
    assert [(r.phase, r.nbytes, r.meta) for r in counts.records] == \
        [(r.phase, r.nbytes, r.meta) for r in jcounts.records]


def test_annotate_dispatch_updates_last_record():
    from repro.core.jax_partition import _count_dispatch as j_count
    from repro.core.jax_partition import annotate_dispatch as j_annotate
    from repro_torch.core.dispatch import annotate_dispatch

    out = []
    for count, annotate, counter, m in (
            (j_count, j_annotate, j_dispatch_counter, jobs),
            (_count_dispatch, annotate_dispatch, dispatch_counter, tobs)):
        tr = m.Tracer()
        root = tr.begin("request")
        tr.push(root)
        with tr.installed(), counter() as counts:
            count("phase_a", nbytes=10)
            count("phase_b", nbytes=20, k=2)
            annotate(cache_miss=True)
        tr.pop()
        assert counts.records[-1].meta == {"k": 2, "cache_miss": True}
        assert counts.records[0].meta == {}
        assert counts == {"partition_scan": 0, "phase_a": 1, "phase_b": 1}
        assert tr.spans[-1].attrs == {"nbytes": 20, "k": 2,
                                      "cache_miss": True}
        out.append(m.chrome_trace_json(tr, include_wall=True))
    assert out[1] == out[0]


def test_cache_miss_annotations_stripped_from_deterministic_export():
    out = []
    for m in (jobs, tobs):
        tr = m.Tracer()
        sp = tr.begin("request", v_start=0.0, v_dur=1.0)
        tr.push(sp)
        tr.instant("dispatch:serving_compute", cache_miss=True, nbytes=4)
        tr.pop()
        det = m.chrome_trace_json(tr)
        assert "cache_miss" not in det
        assert "cache_miss" in m.chrome_trace_json(tr, include_wall=True)
        out.append(det)
    assert out[1] == out[0]


def test_obs_disabled_zero_spans_and_cheap_hooks(traced_runs):
    import time

    jp, tp = traced_runs["pkgs"]
    labels = traced_runs["labels"]

    def timed(obs):
        t0 = time.perf_counter()
        run = _closed_loop_run(tp, labels, obs=obs, n_slots=32)
        return run, time.perf_counter() - t0

    (engine, src, sess, _, _), off_s = timed(None)
    assert src.obs is None and sess.obs is None and engine.obs is None
    want = _closed_loop_run(jp, labels, obs=None, n_slots=32)
    same_records(want[0], engine, want[1].cluster, src.cluster)
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        tobs.trace_instant("noop", a=1)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 5e-6, f"disabled trace_instant {per_call*1e6:.2f}us"
    # the off and on runs alternate twice and the faster of each is
    # compared: one run of either can meet a load spike on a shared host
    on, on_s = timed(Observability())
    off_s = min(off_s, timed(None)[1])
    on_s = min(on_s, timed(Observability())[1])
    assert off_s <= 1.5 * on_s + 0.5, (off_s, on_s)
    assert records(on[0]) == records(engine)   # tracing changes nothing


def test_tracer_span_bound():
    for m in (jobs, tobs):
        tr = m.Tracer(max_spans=8)
        for i in range(20):
            tr.begin(f"s{i}", v_start=float(i), v_dur=1.0)
        assert len(tr.spans) == 8
        assert tr.spans[0].name == "s12"
