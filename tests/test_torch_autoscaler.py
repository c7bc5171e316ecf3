"""The port's closed SLO loop against the JAX package's: every test of
``tests/test_autoscaler.py`` — sliding-window telemetry, circuit half-open
probes, admission control, the autoscaler's decision logic, and chaos
composed through the serving engine — run through both packages on the
same seeded numpy inputs (the JAX sessions with ``use_kernel=False``, the
port's on the CPU).

Integers, events, decisions, the snapshots' deterministic fields (all but
the wall-clock ``p99_measured_ms``), ops, dispatch counts and every
deterministic field of the request records must be equal; ``w`` agrees
within 1e-5 relative to its largest magnitude (``test_torch_serving.REL``,
``close``)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_serving import (K, Pkg, host_w, records, same_records,
                                two_tenants)


def _det_snap(snap) -> tuple:
    """A snapshot's deterministic projection (no wall clock)."""
    return (snap.step, snap.k, snap.window, snap.p50_ms, snap.p99_ms,
            snap.mean_ms, snap.occupancy, snap.footprint, snap.sizes,
            snap.speeds, snap.shed, snap.served, snap.open_circuits,
            snap.load_factor)


def _signature(asc, src, sess) -> dict:
    """Everything a replay must reproduce (``bench_slo``'s signature)."""
    return {
        "ops": tuple((op.kind, op.k_before, op.k_after, op.machine,
                      op.partner, op.committed, op.moved_u,
                      int(op.traffic.migration_bytes))
                     for op in sess.ops),
        "decisions": tuple((_det_snap(s), d.action, d.target, d.reason)
                           for s, d in asc.decisions),
        "repairs": tuple((_det_snap(s), m) for s, m in asc.repairs),
        "shed": tuple(sorted(src.telemetry.shed.items())),
        "events": tuple(src.events),
    }


@pytest.fixture(scope="module")
def serving_graph():
    from repro.graphs import ctr_like

    g = ctr_like(600, 1200, nnz_per_row=12, clusters=8, locality=0.85,
                 seed=0)
    labels = np.where(np.random.default_rng(0).random(g.num_u) < 0.5,
                      1.0, -1.0).astype(np.float32)
    return g, labels


def _pkgs(serving_graph=None):
    g = serving_graph[0] if serving_graph is not None else None
    return Pkg.of(False, g), Pkg.of(True, g)


def _chaos(pkg, events):
    return pkg.ChaosSchedule([pkg.ChaosEvent(**e) for e in events], seed=0)


def _closed_loop(pkg, labels, slo_kw, events=(), bandwidth=2.5e5,
                 max_backlog_s=None, tau_escalation=0, retry=None, seed=0):
    """``tests/test_autoscaler.py``'s full closed-loop stack in ``pkg``:
    an autoscaler-owned ``ElasticSession`` feeding a ``PSRequestSource``
    whose placement matches the session's."""
    cfg = _slo_cfg(pkg, **slo_kw)
    asc = pkg.SLOAutoscaler(cfg)
    sess = pkg.session(min_k=cfg.min_k, max_k=cfg.max_k, policy=asc)
    cluster = pkg.cluster(labels, parts_u=np.asarray(sess.parts).copy(),
                          bandwidth=bandwidth)
    scfg = pkg.ServingConfig(
        prefetch=True, warmup=2, seed=seed, pad_multiple=512,
        retry=retry if retry is not None else pkg.RetryPolicy(
            timeout_s=0.004, retries=0),
        service_model_s=2e-3, max_backlog_s=max_backlog_s,
        tau_escalation=tau_escalation, window_requests=cfg.window_requests)
    src = pkg.PSRequestSource(cluster, two_tenants(pkg), scfg,
                              chaos=_chaos(pkg, events) if events else None,
                              elastic=sess, autoscaler=asc)
    return pkg.ServingEngine(src), src, sess, asc


def _same_loop(j, t) -> None:
    """Two closed-loop stacks after the same run: signature, records,
    router, fleet state and ``w`` equal (``w`` within ``REL``)."""
    (je, jsrc, jsess, jasc), (te, tsrc, tsess, tasc) = j, t
    assert _signature(tasc, tsrc, tsess) == _signature(jasc, jsrc, jsess)
    same_records(je, te, jsrc.cluster, tsrc.cluster)
    assert (tsrc.dead, tsrc.suspect) == (jsrc.dead, jsrc.suspect)
    assert tsrc.breaker.open_links() == jsrc.breaker.open_links()
    assert tsrc.router.version == jsrc.router.version
    rw = (tsrc.router.weights, jsrc.router.weights)
    assert (rw[0] is None) == (rw[1] is None)
    if rw[0] is not None:
        assert np.array_equal(rw[0], rw[1])
    assert np.array_equal(tsess.parts, jsess.parts)
    assert tsess.k == jsess.k == tsrc.cluster.k


# --------------------------------------------------- LatencyWindow (ring)
def test_latency_window_cold_start_never_reads_zeros():
    for pkg in _pkgs():
        w = pkg.LatencyWindow(8)
        assert w.filled == 0 and w.percentile(99) == 0.0 and w.mean() == 0.0
        w.add(10.0)
        assert w.percentile(1) == 10.0 and w.percentile(99) == 10.0
        assert w.mean() == 10.0 and w.filled == 1
        w.add(30.0)
        assert w.percentile(50) == 20.0 and w.filled == 2


def test_latency_window_wraparound_overwrites_oldest():
    for pkg in _pkgs():
        w = pkg.LatencyWindow(4)
        for v in (1.0, 2.0, 3.0, 4.0, 100.0, 200.0):
            w.add(v)
        assert w.filled == 4 and w.total_observed == 6
        assert set(w.values()) == {3.0, 4.0, 100.0, 200.0}
        w.reset()
        assert w.filled == 0 and w.percentile(99) == 0.0
        w.add(7.0)
        assert w.values().tolist() == [7.0]
        with pytest.raises(ValueError):
            pkg.LatencyWindow(0)


def test_recorder_sliding_window_tracks_recent_not_alltime():
    out = []
    for pkg in _pkgs():
        from_pkg = pkg.serving.latency
        rec = pkg.LatencyRecorder(window_requests=4)

        def add(step, lat, warm=False):
            rec.add(from_pkg.RequestRecord(
                tenant="t", step=step, home=0, examples=1, tokens=1,
                latency_s=lat, wire_s=lat, wait_s=0.0, blocked_s=0.0,
                compute_s=0.0, warmup=warm))

        add(0, 9.9, warm=True)
        for i in range(4):
            add(i + 1, 1.0)
        for i in range(4):
            add(i + 5, 0.001)
        w = rec.windowed()
        assert w["requests"] == 4
        assert w["p99_ms"] == pytest.approx(1.0)
        s = rec.summary(wall_s=1.0)
        assert s["p99_window_ms"] == pytest.approx(1.0)
        assert s["p99_ms"] > 100
        assert pkg.LatencyRecorder(window_requests=None)._win is None
        with pytest.raises(ValueError):
            pkg.LatencyRecorder().windowed()
        out.append((w, s))
    assert out[1] == out[0]


# ----------------------------------------------- circuit half-open probe
def test_breaker_half_open_probe_closes_on_recovery():
    for pkg in _pkgs():
        b = pkg.CircuitBreaker(2, cooldown_s=0.1, max_cooldown_s=1.0, seed=0)
        assert b.allow(1, now=0.0) and b.state(1) == "closed"
        assert b.record(1, delivered=False, now=0.0)
        assert b.state(1) == "open" and b.open_links() == (1,)
        assert not b.allow(1, now=0.05)
        assert b.allow(1, now=0.11)
        assert b.state(1) == "half_open"
        assert not b.record(1, delivered=True, now=0.11)
        assert b.state(1) == "closed" and b.open_links() == ()
        with pytest.raises(ValueError):
            pkg.CircuitBreaker(2, cooldown_s=0.0)
        with pytest.raises(ValueError):
            pkg.CircuitBreaker(2, cooldown_s=0.1, max_cooldown_s=0.05)


def test_breaker_failed_probe_backs_off_with_decorrelated_jitter():
    """The same seeded draws as JAX's breaker, probe after probe: every
    cooldown from U(base, 3 × prev), capped, jittered and replayable."""
    got = []
    for pkg in _pkgs():
        b = pkg.CircuitBreaker(1, cooldown_s=0.1, max_cooldown_s=0.5, seed=3)
        b.record(0, delivered=False, now=0.0)
        sleeps = []
        for _ in range(6):
            now = float(b._until[0])
            assert b.allow(0, now=now)
            b.record(0, delivered=False, now=now)
            sleeps.append(float(b._sleep[0]))
        assert all(0.1 <= s <= 0.5 for s in sleeps)
        assert len(set(sleeps)) > 1
        b2 = pkg.CircuitBreaker(1, cooldown_s=0.1, max_cooldown_s=0.5,
                                seed=3)
        b2.record(0, delivered=False, now=0.0)
        replay = []
        for _ in range(6):
            n2 = float(b2._until[0])
            b2.allow(0, now=n2)
            b2.record(0, delivered=False, now=n2)
            replay.append(float(b2._sleep[0]))
        assert replay == sleeps
        b.reset(0)
        assert b.state(0) == "closed" and b._sleep[0] == 0.1
        got.append(sleeps)
    assert got[1] == got[0]


def test_breaker_resize_and_scripted_transitions_match_jax():
    """A scripted run of allows, records, resizes and resets over several
    links: the same states, open links, deadlines and draws in both."""
    rng = np.random.default_rng(11)
    script = [(int(rng.integers(0, 6)), bool(rng.random() < 0.4),
               float(t) * 0.01) for t in range(200)]
    traces = []
    for pkg in _pkgs():
        b = pkg.CircuitBreaker(4, cooldown_s=0.02, max_cooldown_s=0.3,
                               seed=7)
        trace = []
        for i, (link, ok, now) in enumerate(script):
            if i == 60:
                b.resize(6)
            if i == 140:
                b.resize(3)
            if i % 37 == 0:
                b.reset(link % b.k)
            link %= b.k
            allowed = b.allow(link, now)
            opened = b.record(link, ok, now) if allowed else None
            trace.append((allowed, opened, b.state(link), b.open_links(),
                          float(b._until[link]), float(b._sleep[link])))
        traces.append(trace)
    assert traces[1] == traces[0]


def test_kill_then_recover_returns_to_direct_serving(serving_graph):
    """The half-open probe rediscovers a killed-then-recovered link —
    nobody tells serving the shard came back — at the slot JAX's does."""
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        chaos = _chaos(pkg, [dict(feed=3, kind="kill", machine=1),
                             dict(feed=8, kind="recover", machine=1)])
        cluster = pkg.cluster(labels)
        cfg = pkg.ServingConfig(
            prefetch=True, warmup=2, seed=0, pad_multiple=512,
            retry=pkg.RetryPolicy(timeout_s=0.002, retries=1),
            breaker_cooldown_s=0.004, service_model_s=2e-3)
        src = pkg.PSRequestSource(cluster, two_tenants(pkg), cfg, chaos=chaos)
        engine = pkg.ServingEngine(src)
        runs.append((engine, src, cluster, engine.run(24)))
    (je, jsrc, jc, js), (te, tsrc, tc, s) = runs
    same_records(je, te, jc, tc)
    assert tsrc.events == jsrc.events
    assert (3, "kill", 1) in tsrc.events and (8, "recover", 1) in tsrc.events
    assert tsrc.breaker.state(1) == "closed"
    assert 1 not in tsrc.suspect and tsrc.dead == set()
    assert s["stale_entries"] == js["stale_entries"] > 0
    tail = [r for r in te.recorder.records if r.step >= 16]
    assert all(r.stale_entries == 0 for r in tail)


# ------------------------------------------------------ admission control
def test_admission_sheds_lowest_weight_tenant_first(serving_graph):
    g, labels = serving_graph
    seen = []
    for pkg in _pkgs(serving_graph):
        cluster = pkg.cluster(labels)
        cfg = pkg.ServingConfig(prefetch=True, warmup=0, seed=0,
                                pad_multiple=512, service_model_s=2e-3,
                                max_backlog_s=0.03)
        src = pkg.PSRequestSource(cluster, two_tenants(pkg), cfg)
        src.vtime = 0.0
        heavy = src.next_request(0)
        src.vlink.free_at[:] = 0.02
        light = heavy
        drawn = [heavy.tenant]
        while light.tenant != "light" or heavy.tenant != "heavy":
            r = src.next_request(0)
            drawn.append(r.tenant)
            if r.tenant == "light":
                light = r
            else:
                heavy = r
        assert src.admit(heavy) and not src.admit(light)
        src.vlink.free_at[:] = 0.05
        assert not src.admit(heavy)
        src.vlink.free_at[:] = 0.0
        assert src.admit(light) and src.admit(heavy)
        assert src.admit(light) is True
        seen.append((drawn, light.rows.tolist(), heavy.rows.tolist(),
                     light.need.tolist(), heavy.tokens))
    assert seen[1] == seen[0]


def test_shed_slots_advance_the_virtual_clock(serving_graph):
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        cluster = pkg.cluster(labels, bandwidth=4e4)
        cfg = pkg.ServingConfig(prefetch=True, warmup=2, seed=0,
                                pad_multiple=512, service_model_s=1e-3,
                                max_backlog_s=0.004, window_requests=16)
        src = pkg.PSRequestSource(
            cluster, two_tenants(pkg), cfg,
            telemetry=pkg.TelemetryBus(K, window_requests=16))
        engine = pkg.ServingEngine(src)
        runs.append((engine, src, cluster, engine.run(40)))
    (je, jsrc, jc, js), (te, tsrc, tc, s) = runs
    same_records(je, te, jc, tc)
    n = 40
    assert s["shed_requests"] == js["shed_requests"] > 0
    assert s["requests"] + s["shed_requests"] == n - 2
    assert s["shed_per_tenant"] == tsrc.telemetry.shed == jsrc.telemetry.shed
    assert tsrc.telemetry.shed.get("light", 0) >= 1
    assert tsrc.vtime == jsrc.vtime == pytest.approx((n - 1) * 1e-3)
    assert 0.0 < s["shed_frac"] == js["shed_frac"] < 1.0


# ---------------------------------------------------------- telemetry bus
def test_telemetry_bus_windows_and_snapshot_equality():
    snaps = []
    for pkg in _pkgs():
        bus = pkg.TelemetryBus(3, window_requests=8)
        for i in range(10):
            bus.observe(0.005 + i * 1e-4, 0.009,
                        src_times=np.array([1.0, 2.0, np.nan]))
        snap = bus.snapshot(step=9, occupancy=[0.1, 0.0, 0.2],
                            footprint=[10, 30, 20], sizes=[5, 5, 5],
                            open_circuits=(1,), load_factor=2.0)
        assert snap.window == 8 and snap.served == 10
        assert snap.p99_ms > snap.p50_ms > 0
        assert snap.max_occupancy == pytest.approx(0.2)
        assert snap.hot_part == 1
        assert snap.open_circuits == (1,)
        assert snap.speeds[1] < snap.speeds[0]
        snap2 = bus.snapshot(step=9, occupancy=[0.1, 0.0, 0.2],
                             footprint=[10, 30, 20], sizes=[5, 5, 5],
                             open_circuits=(1,), load_factor=2.0)
        assert snap == snap2
        with pytest.raises(ValueError):
            pkg.TelemetryBus(3, window_requests=0)
        snaps.append(dataclasses.astuple(snap))
    assert snaps[1] == snaps[0]


def test_telemetry_bus_resize_preserves_survivor_ewma():
    got = []
    for pkg in _pkgs():
        bus = pkg.TelemetryBus(3, window_requests=4)
        for _ in range(6):
            bus.observe(1e-3, 1e-3, src_times=np.array([1.0, 4.0, 1.0]))
        slow = bus.ewma.weights()[1]
        assert slow < 1.0
        bus.resize(4)
        assert bus.k == 4
        assert bus.ewma.weights()[1] == pytest.approx(slow, rel=0.2)
        w4 = bus.ewma.weights().tolist()
        bus.observe(1e-3, 1e-3, src_times=np.array([1.0, 4.0, 1.0]))
        bus.resize(2)
        assert bus.ewma.weights().shape == (2,)
        bus.resize(2)
        assert bus.k == 2
        got.append((slow, w4, bus.ewma.weights().tolist(),
                    bus.ewma._seen.tolist()))
    assert got[1] == got[0]


def test_hot_part_skips_unsplittable_parts():
    for pkg in _pkgs():
        bus = pkg.TelemetryBus(3, window_requests=4)
        snap = bus.snapshot(step=0, occupancy=[0.0] * 3,
                            footprint=[50, 40, 10], sizes=[1, 8, 8])
        assert snap.hot_part == 1
        assert bus.snapshot(0, [], [], []).hot_part == 0


# ------------------------------------------------- autoscaler unit logic
def _snap(pkg, p99=10.0, occ=0.0, k=4, speeds=None, window=8, sizes=None):
    bus = pkg.TelemetryBus(4, window_requests=8)
    for _ in range(window):
        bus.observe(p99 * 1e-3, p99 * 1e-3)
    snap = bus.snapshot(0, [occ] * k, [10] * k,
                        sizes if sizes is not None else [8] * k)
    over = {"k": k}
    if speeds is not None:
        over["speeds"] = speeds
    return dataclasses.replace(snap, **over)


def _slo_cfg(pkg, **kw):
    base = dict(slo_ms=20.0, window_requests=8, decide_every=4,
                warmup_windows=1, patience=2, shrink_patience=2,
                cooldown_windows=1, shrink_p99_frac=0.4,
                shrink_occupancy_s=0.01, min_k=2, max_k=6,
                drift_ratio=2.0)
    base.update(kw)
    return pkg.SLOConfig(**base)


def _decisions(asc) -> list[tuple]:
    return [(_det_snap(s), d.action, d.target, d.reason)
            for s, d in asc.decisions]


def test_autoscaler_patience_then_grow_targets_hot_part():
    out = []
    for pkg in _pkgs():
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg))
        assert asc.decide(_snap(pkg, p99=30.0)).reason == "warmup"
        assert asc.decide(_snap(pkg, p99=30.0)).action == "hold"
        d = asc.decide(_snap(pkg, p99=30.0))
        assert d.action == "grow" and d.reason.startswith("p99")
        assert d.target == 0
        assert asc.decide(_snap(pkg, p99=30.0)).reason == "cooldown"
        assert len(asc.decisions) == 4
        assert asc.decide(_snap(pkg, p99=30.0)).action == "hold"
        assert asc.decide(_snap(pkg, p99=10.0, occ=1.0)).action == "hold"
        assert asc.decide(_snap(pkg, p99=30.0)).action == "hold"
        assert asc.decide(_snap(pkg, p99=30.0)).action == "grow"
        out.append(_decisions(asc))
    assert out[1] == out[0]


def test_autoscaler_shrink_needs_cold_p99_and_idle_nics():
    out = []
    for pkg in _pkgs():
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0,
                                         cooldown_windows=0))
        assert asc.decide(_snap(pkg, p99=5.0, occ=0.0)).action == "hold"
        assert asc.decide(_snap(pkg, p99=5.0, occ=0.0)).action == "shrink"
        asc2 = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0))
        asc2.decide(_snap(pkg, p99=5.0, occ=0.5))
        asc2.decide(_snap(pkg, p99=5.0, occ=0.5))
        assert all(d.action == "hold" for _, d in asc2.decisions)
        out.append((_decisions(asc), _decisions(asc2)))
    assert out[1] == out[0]


def test_autoscaler_respects_k_bounds():
    for pkg in _pkgs():
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0, patience=1,
                                         max_k=4))
        assert asc.decide(_snap(pkg, p99=30.0, k=4)).action == "hold"
        asc2 = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0,
                                          shrink_patience=1, min_k=4))
        assert asc2.decide(_snap(pkg, p99=1.0, k=4)).action == "hold"
        assert (asc.min_partitions, asc.max_partitions) == (2, 4)


def test_autoscaler_rebalance_on_ewma_drift():
    out = []
    for pkg in _pkgs():
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0))
        d = asc.decide(_snap(pkg, p99=10.0, speeds=(1.2, 1.2, 1.2, 0.4)))
        assert d.action == "rebalance" and "0.40x" in d.reason
        d2 = asc.decide(_snap(pkg, p99=10.0, speeds=(1.1, 1.0, 1.0, 0.9)))
        assert d2.action == "hold"
        assert asc.rebalance(None, np.ones(4)).tolist() == [1.0] * 4
        out.append(_decisions(asc))
    assert out[1] == out[0]


def test_autoscaler_single_shot_consent():
    for pkg in _pkgs():
        FleetState = pkg.elastic.FleetState
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg))
        state = FleetState(k=4, feed_index=0, sizes=np.full(4, 8),
                           footprint=np.full(4, 10))
        assert not asc.grow(state)
        asc.approve("grow")
        assert asc.grow(state)
        assert not asc.grow(state)
        asc.approve("shrink")
        assert not asc.grow(state)
        assert asc.shrink(state)
        asc.approve("grow")
        assert not asc.grow(FleetState(k=6, feed_index=0,
                                       sizes=np.full(6, 8),
                                       footprint=np.full(6, 10)))
        assert asc.repair(state) == "warm"
        with pytest.raises(ValueError):
            asc.approve("repair")
        assert isinstance(asc, pkg.elastic.ElasticPolicy)


def test_autoscaler_note_repair_holds_cooldown():
    out = []
    for pkg in _pkgs():
        asc = pkg.SLOAutoscaler(_slo_cfg(pkg, warmup_windows=0, patience=1))
        asc.note_repair(_snap(pkg), machine=2)
        assert asc.repairs[0][1] == 2
        assert asc.decide(_snap(pkg, p99=30.0)).reason == "cooldown"
        assert asc.decide(_snap(pkg, p99=30.0)).action == "grow"
        out.append(_decisions(asc))
    assert out[1] == out[0]


def test_slo_config_validation():
    for pkg in _pkgs():
        for bad in (dict(slo_ms=0.0), dict(decide_every=0), dict(patience=0),
                    dict(shrink_patience=0), dict(min_k=5, max_k=4),
                    dict(shrink_p99_frac=1.0), dict(drift_ratio=1.0)):
            with pytest.raises(ValueError):
                _slo_cfg(pkg, **bad)
        # the obs hook is left out of equality and hashing
        a, b = _slo_cfg(pkg), _slo_cfg(pkg, obs=object())
        assert a == b and hash(a) == hash(b)


# --------------------------------------- chaos composition (closed loop)
def test_closed_loop_repair_on_kill(serving_graph):
    """Kill with the autoscaler attached: the loop discovers the loss via
    its own breaker and repairs at end-of-slot (one
    ``elastic_repair_scan``), as JAX's does, slot for slot."""
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        stack = _closed_loop(pkg, labels, dict(slo_ms=500.0, decide_every=8,
                                               warmup_windows=1),
                             events=[dict(feed=4, kind="kill", machine=2)])
        v0 = stack[1].cluster.placement_version
        with pkg.dispatch_counter() as counts:
            s = stack[0].run(16)
        runs.append((stack, counts, s, v0))
    (jst, jcounts, js, _), (tst, counts, s, v0) = runs
    _same_loop(jst, tst)
    assert dict(counts) == dict(jcounts)
    engine, src, sess, asc = tst
    assert src.dead == set() and 2 not in src.suspect
    assert src.breaker.state(2) == "closed"
    repairs = [op for op in sess.ops if op.kind == "repair"]
    assert len(repairs) == 1 and repairs[0].committed
    assert repairs[0].telemetry is not None
    assert repairs[0].telemetry.open_circuits == (2,)
    assert asc.repairs and asc.repairs[0][1] == 2
    assert counts["elastic_repair_scan"] == 1
    assert src.cluster.placement_version > v0
    assert src.router.version == src.cluster.placement_version
    assert s["requests"] == 14


def test_closed_loop_straggle_recover_rebalances_routing(serving_graph):
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        stack = _closed_loop(
            pkg, labels, dict(slo_ms=500.0, decide_every=8,
                              warmup_windows=1, drift_ratio=1.5),
            events=[dict(feed=4, kind="straggle", machine=1, factor=8.0),
                    dict(feed=40, kind="recover", machine=1)])
        stack[0].run(48)
        runs.append(stack)
    _same_loop(*runs)
    engine, src, sess, asc = runs[1]
    acts = [d.action for _, d in asc.decisions]
    assert "rebalance" in acts
    i = acts.index("rebalance")
    snap = asc.decisions[i][0]
    assert min(snap.speeds) == snap.speeds[1]
    assert src.router.weights is not None
    assert np.argmin(src.router.weights) == 1
    homes = [r.home for r in engine.recorder.records if r.step > 8 * (i + 1)]
    assert homes.count(1) < len(homes) / K


def test_closed_loop_grow_single_scan_and_tau_escalation(serving_graph):
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        stack = _closed_loop(
            pkg, labels, dict(slo_ms=4.0, decide_every=8, warmup_windows=1,
                              patience=1, max_k=6),
            events=[dict(feed=2, kind="burst", factor=4.0)],
            bandwidth=1e5, tau_escalation=4)
        with pkg.dispatch_counter() as counts:
            stack[0].run(32)
        runs.append((stack, counts))
    (jst, jcounts), (tst, counts) = runs
    _same_loop(jst, tst)
    assert dict(counts) == dict(jcounts)
    engine, src, sess, asc = tst
    grows = [op for op in sess.ops if op.kind == "grow"]
    assert grows and all(op.committed for op in grows)
    assert counts["elastic_grow_scan"] == len(grows)
    assert sess.k > K and src.cluster.k == sess.k
    assert grows[0].telemetry is not None
    assert grows[0].telemetry.p99_ms > asc.config.slo_ms
    t_op = min(r.step for r in engine.recorder.records
               if r.step > 8 and r.stale_entries > 0)
    stale = [r for r in engine.recorder.records
             if t_op <= r.step < t_op + 3]
    assert stale and all(r.wire_s == 0.0 for r in stale)


def test_closed_loop_replay_is_bit_deterministic(serving_graph):
    """Same seeded chaos, two fresh stacks of the port and one of JAX's:
    identical events, ops, decisions and shed counts."""
    g, labels = serving_graph

    def run_once(pkg):
        stack = _closed_loop(
            pkg, labels, dict(slo_ms=8.0, decide_every=8, warmup_windows=1,
                              patience=1, max_k=6),
            events=[dict(feed=2, kind="burst", factor=4.0),
                    dict(feed=10, kind="kill", machine=1),
                    dict(feed=20, kind="straggle", machine=2, factor=4.0)],
            bandwidth=1e5, max_backlog_s=0.02, tau_escalation=2)
        stack[0].run(32)
        return stack

    jp, tp = _pkgs(serving_graph)
    a, b, want = run_once(tp), run_once(tp), run_once(jp)
    sig = _signature(a[3], a[1], a[2])
    assert sig == _signature(b[3], b[1], b[2])
    assert records(a[0]) == records(b[0])
    assert np.array_equal(host_w(a[1].cluster), host_w(b[1].cluster))
    _same_loop(want, a)
    assert sig["ops"] and sig["events"]


def test_kill_then_add_composition_through_engine(serving_graph):
    """kill -> add with an elastic session (no autoscaler): the warm
    repair and the forced grow land mid-serve, one scan each, in the same
    places as JAX's, and the placement version reaches the router."""
    g, labels = serving_graph
    runs = []
    for pkg in _pkgs(serving_graph):
        sess = pkg.session()
        cluster = pkg.cluster(labels, parts_u=np.asarray(sess.parts).copy())
        chaos = _chaos(pkg, [dict(feed=3, kind="kill", machine=1),
                             dict(feed=8, kind="add")])
        cfg = pkg.ServingConfig(prefetch=True, warmup=2, seed=0,
                                pad_multiple=512)
        src = pkg.PSRequestSource(cluster, two_tenants(pkg), cfg, chaos=chaos,
                                  elastic=sess)
        engine = pkg.ServingEngine(src)
        with pkg.dispatch_counter() as counts:
            s = engine.run(14)
        runs.append((engine, src, sess, cluster, counts, s))
    (je, jsrc, jsess, jc, jcounts, _), (te, src, sess, tc, counts, s) = runs
    same_records(je, te, jc, tc)
    assert np.array_equal(tc.owner, jc.owner)
    assert src.events == jsrc.events
    assert dict(counts) == dict(jcounts)
    assert [op.kind for op in sess.ops] == ["repair", "grow"]
    assert [(o.machine, o.partner, o.moved_u) for o in sess.ops] == \
        [(o.machine, o.partner, o.moved_u) for o in jsess.ops]
    assert counts["elastic_repair_scan"] == 1
    assert counts["elastic_grow_scan"] == 1
    assert src.dead == set()
    assert sess.k == K + 1 and src.cluster.k == K + 1
    assert src.router.version == src.cluster.placement_version
    assert src.router.k == K + 1
    assert s["requests"] == 12


_JAX_WALLCLOCK = r"""
import json, sys
import jax, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.api import ParsaConfig, ParsaStreamConfig
from repro.elastic import (ChaosEvent, ChaosSchedule, ElasticConfig,
                           ElasticSession)
from repro.graphs import ctr_like_stream

k, workers, out_path = json.loads(sys.argv[1])
scfg = ParsaStreamConfig(base=ParsaConfig(
    k=k, backend="parallel_device", workers=workers, block_size=32,
    merge_every=1, refine_v=False, seed=0, use_kernel=False))
sess = ElasticSession(
    ElasticConfig(stream=scfg, observe_wallclock=True, straggler_bias=True),
    num_v=1200,
    chaos=ChaosSchedule([ChaosEvent(feed=1, kind="straggle", machine=0,
                                    factor=100.0)], seed=0))
weights, seen = [], []
for ch in ctr_like_stream(600, 1200, chunks=3, nnz_per_row=10, clusters=6,
                          locality=0.8, seed=0):
    sess.feed(ch)
    weights.append(sess.ewma.weights())
    seen.append(np.asarray(sess.ewma._seen))
np.savez(out_path, weights=np.stack(weights), seen=np.stack(seen),
         parts=sess.parts)
print("JAX_WALLCLOCK_DONE")
"""


def test_observe_wallclock_mode_feeds_measured_times(tmp_path):
    """``observe_wallclock=True``: the session EWMA ingests *measured* scan
    wall time, one observation per lane, so an injected 100x factor is
    invisible by design.  JAX's ``parallel_device`` runs in a subprocess
    on 8 forced host devices (the device count is fixed when JAX starts);
    the port runs the worker axis in process.  Every lane sees one fused
    dispatch's time in both, so the weights after each feed, ``_seen`` and
    the parts must be equal, and the weights all 1.0."""
    from repro.graphs import ctr_like_stream

    tp = Pkg.of(True)
    workers = 4
    path = tmp_path / "wallclock.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"))
    run = subprocess.run(
        [sys.executable, "-c", _JAX_WALLCLOCK,
         json.dumps([K, workers, str(path)])], env=env, capture_output=True,
        text=True, timeout=600)
    assert "JAX_WALLCLOCK_DONE" in run.stdout, run.stdout + run.stderr
    want = dict(np.load(path))
    chunks = [Pkg.of(True, c).g for c in ctr_like_stream(
        600, 1200, chunks=3, nnz_per_row=10, clusters=6, locality=0.8,
        seed=0)]
    scfg = tp.api.ParsaStreamConfig(base=tp.parsa(
        k=K, backend="parallel_device", workers=workers, block_size=32,
        merge_every=1, refine_v=False, seed=0))
    sess = tp.ElasticSession(
        tp.ElasticConfig(stream=scfg, observe_wallclock=True,
                         straggler_bias=True),
        num_v=1200,
        chaos=tp.ChaosSchedule([tp.ChaosEvent(feed=1, kind="straggle",
                                              machine=0, factor=100.0)],
                               seed=0), device="cpu")
    weights, seen = [], []
    for ch in chunks:
        sess.feed(ch)
        weights.append(sess.ewma.weights())
        seen.append(np.asarray(sess.ewma._seen))
    assert np.array_equal(np.stack(weights), want["weights"])
    assert np.array_equal(np.stack(seen), want["seen"])
    assert np.array_equal(sess.parts, want["parts"])
    w = sess.ewma.weights()
    assert w.shape == (workers,) and np.isfinite(w).all()
    assert np.allclose(w, 1.0)
    assert sess.ewma._seen.all()


def test_router_smooth_wrr_biases_away_from_slow(serving_graph):
    g, labels = serving_graph
    got = []
    for pkg in _pkgs(serving_graph):
        r = pkg.Router(pkg.cluster(labels))
        r.set_weights([1.0, 1.0, 1.0, 0.2])
        homes = [r.next_home() for _ in range(32)]
        assert homes.count(3) < homes.count(0)
        assert set(homes) == {0, 1, 2, 3}
        with pytest.raises(ValueError):
            r.set_weights([1.0, 1.0])
        with pytest.raises(ValueError):
            r.set_weights([1.0, 1.0, 1.0, 0.0])
        r.set_weights(None)
        assert r.weights is None
        homes += [r.next_home(dead={2}) for _ in range(8)]
        got.append(homes)
    assert got[1] == got[0]


def test_bandwidth_model_and_link_clock_match_jax():
    """The pricing and NIC-booking primitives under the modeled latency:
    per-source seconds, ingress sums with exclusions, backlogs and
    bookings across resizes, equal float for float."""
    rng = np.random.default_rng(5)
    src_bytes = rng.integers(0, 5000, size=(60, 4)) * 4
    straggle = np.array([1.0, 4.0, 1.0, 1.5])
    out = []
    for pkg in _pkgs():
        lat = pkg.serving.latency
        bw, clock = lat.BandwidthModel(7.5e4), lat.LinkClock(4)
        trace = []
        for t, src in enumerate(src_bytes):
            home = t % 3
            secs = bw.per_source(src, home, straggle)
            wire = bw.ingress_seconds(src, home, straggle,
                                      exclude={(t + 1) % 4})
            now = t * 2e-3
            trace.append((secs.tolist(), wire, clock.backlog(home, now),
                          clock.acquire(home, now, wire)))
            if t in (30, 45):
                clock.resize(6 if t == 30 else 3)
            trace.append(clock.free_at.tolist())
        out.append(trace)
    assert out[1] == out[0]
