"""The port's observability core against the JAX package's: the same
scripted spans and events, and the same seeded stream feeds traced with
``StreamSession(obs=...)``, export byte-identical Chrome traces, recorder
JSON, ``explain()`` text and Prometheus text in both packages."""
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
