"""The port's host-side observability modules (``trace``, ``tracing``,
``slo``, ``export``: copies of the reference's, which need no device)
against what the reference's tests check (``tests/test_distributed_
tracing.py``'s unit classes, ``tests/test_slo_quantiles.py``), and
against the reference itself: the same inputs give the same documents,
texts, trees, quantiles and burn rates in both packages."""

import bisect
import json
import os

import numpy as np
import pytest

from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.observability import slo as jax_slo
from paddle_tpu.observability import tracing as jax_tracing

from paddle_tpu_torch.observability import export as oexport
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.observability import slo as oslo
from paddle_tpu_torch.observability import trace as otrace
from paddle_tpu_torch.observability import tracing as otracing
from paddle_tpu_torch.observability.slo import histogram_quantile


@pytest.fixture(autouse=True)
def _fresh_state():
    om.default_registry().clear()
    otrace.clear()
    yield
    om.default_registry().clear()
    otrace.clear()


# ---------------------------------------------------------------------------
# TraceContext + traceparent
# ---------------------------------------------------------------------------
class TestTraceContext:
    def test_traceparent_round_trip(self):
        ctx = otracing.mint()
        hdr = otracing.format_traceparent(ctx)
        back = otracing.parse_traceparent(hdr)
        assert back.trace_id == ctx.trace_id
        assert back.span_id == ctx.span_id

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "00-abc-def-01",
        "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",      # version ff
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",      # zero trace
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01",      # zero span
        "00-" + "g" * 32 + "-" + "b" * 16 + "-01",      # non-hex
        "00-" + "a" * 31 + "-" + "b" * 16 + "-01",      # short trace
    ])
    def test_parse_rejects_malformed(self, bad):
        assert otracing.parse_traceparent(bad) is None
        assert jax_tracing.parse_traceparent(bad) is None

    def test_parse_agrees_with_reference(self):
        hdr = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        mine, ref = (m.parse_traceparent(hdr)
                     for m in (otracing, jax_tracing))
        assert (mine.trace_id, mine.span_id, mine.parent_id) \
            == (ref.trace_id, ref.span_id, ref.parent_id)
        assert otracing.format_traceparent(mine) \
            == jax_tracing.format_traceparent(ref) == hdr

    def test_adopt_continues_remote_trace(self):
        remote = otracing.mint()
        ctx = otracing.adopt(otracing.format_traceparent(remote))
        assert ctx.trace_id == remote.trace_id
        assert ctx.parent_id == remote.span_id
        assert ctx.span_id != remote.span_id

    def test_adopt_mints_fresh_on_invalid(self):
        a = otracing.adopt("not-a-traceparent")
        b = otracing.adopt(None)
        assert a is not None and b is not None
        assert a.trace_id != b.trace_id
        assert a.parent_id is None

    def test_child_links_parent(self):
        root = otracing.mint()
        kid = root.child()
        assert kid.trace_id == root.trace_id
        assert kid.parent_id == root.span_id

    def test_wire_round_trip(self):
        ctx = otracing.mint().child()
        with otracing.activate(ctx):
            wire = otracing.inject()
        back = otracing.extract(wire)
        assert (back.trace_id, back.span_id, back.parent_id) \
            == (ctx.trace_id, ctx.span_id, ctx.parent_id)
        assert otracing.extract(None) is None
        assert otracing.extract({"span_id": "x"}) is None

    def test_kill_switch_returns_none(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        assert otracing.mint() is None
        assert otracing.adopt("00-" + "a" * 32 + "-" + "b" * 16
                              + "-01") is None
        assert otracing.inject() is None
        assert otracing.current() is None
        assert otracing.write_span_shard(tmp_path, "w0") is None
        assert not (tmp_path / otracing.SHARD_DIR).exists()
        assert otracing.record_clock_handshake(tmp_path, "w0") is None
        assert list(tmp_path.iterdir()) == []

    def test_kill_switch_beats_activated_context(self, monkeypatch):
        ctx = otracing.mint()
        with otracing.activate(ctx):
            monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
            assert otracing.current() is None
            assert otracing.inject() is None


# ---------------------------------------------------------------------------
# span <-> context integration
# ---------------------------------------------------------------------------
class TestSpanChaining:
    def test_nested_spans_chain_to_active_context(self):
        buf = otrace.TraceBuffer()
        root = otracing.mint()
        with otracing.activate(root):
            with otrace.span("outer", buffer=buf):
                with otrace.span("inner", buffer=buf):
                    pass
        inner, outer = buf.events()
        assert outer["name"] == "outer"
        assert outer["args"]["trace_id"] == root.trace_id
        assert outer["args"]["parent_id"] == root.span_id
        assert inner["args"]["parent_id"] == outer["args"]["span_id"]

    def test_span_without_context_records_plain(self):
        buf = otrace.TraceBuffer()
        with otrace.span("plain", buffer=buf, k=1):
            pass
        (ev,) = buf.events()
        assert ev["args"] == {"k": 1}
        assert "trace_id" not in ev["args"]

    def test_explicit_trace_ctx_installs_verbatim(self):
        buf = otrace.TraceBuffer()
        ctx = otracing.mint().child()
        with otrace.span("rpc.call", buffer=buf, trace_ctx=ctx):
            with otrace.span("attempt", buffer=buf):
                pass
        att, call = buf.events()
        assert call["args"]["span_id"] == ctx.span_id
        assert att["args"]["parent_id"] == ctx.span_id

    def test_context_restored_after_span(self):
        root = otracing.mint()
        with otracing.activate(root):
            with otrace.span("s"):
                assert otracing.current().parent_id == root.span_id
            assert otracing.current() is root
        assert otracing.current() is None


# ---------------------------------------------------------------------------
# shards, clock alignment, merge, tree
# ---------------------------------------------------------------------------
def _shard(worker, pid, epoch_unix, events):
    return {"worker": worker, "pid": pid, "epoch_unix": epoch_unix,
            "events": events}


def _ev(name, ts, dur, pid, trace_id=None, span_id=None,
        parent_id=None):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": pid,
          "tid": 1}
    if trace_id:
        ev["args"] = {"trace_id": trace_id, "span_id": span_id,
                      "parent_id": parent_id}
    return ev


class TestMergeShards:
    def test_offset_alignment_orders_cross_process_parent_first(self):
        t = "a" * 32
        parent = _ev("rpc.call", 5e6, 4e6, 1, t, "p" * 16)
        child = _ev("rpc.handle", 2.5e6, 1e6, 2, t, "c" * 16, "p" * 16)
        shards = [_shard("router", 1, 100.0, [parent]),
                  _shard("w0", 2, 103.0, [child])]
        merged = otracing.merge_shards(shards)
        spans = [e for e in merged["traceEvents"] if e["ph"] == "X"]
        by_name = {e["name"]: e for e in spans}
        assert by_name["rpc.handle"]["ts"] == pytest.approx(
            2.5e6 + 3e6 * 1.0)
        assert by_name["rpc.call"]["ts"] < by_name["rpc.handle"]["ts"]
        assert merged == jax_tracing.merge_shards(shards)

    def test_process_metadata_first_and_named(self):
        merged = otracing.merge_shards([
            _shard("w1", 7, 50.0, [_ev("x", 1.0, 1.0, 7)]),
            _shard("w2", 8, 51.0, [_ev("y", 1.0, 1.0, 8)])])
        evs = merged["traceEvents"]
        metas = [e for e in evs if e["ph"] == "M"]
        assert [m["args"]["name"] for m in metas] == ["w1", "w2"]
        assert evs[:len(metas)] == metas

    def test_empty_and_torn_shards_skipped(self, tmp_path):
        sd = tmp_path / otracing.SHARD_DIR
        sd.mkdir()
        (sd / "torn.trace.json").write_text('{"events": [')
        (sd / "foreign.txt").write_text("hi")
        path = otracing.write_span_shard(tmp_path, "good")
        assert path is not None and os.path.exists(path)
        shards = otracing.harvest_shards(tmp_path)
        assert [s["worker"] for s in shards] == ["good"]
        assert otracing.merge_shards([])["traceEvents"] == []

    def test_shard_flush_is_atomic_overwrite(self, tmp_path):
        buf = otrace.TraceBuffer()
        with otrace.span("one", buffer=buf):
            pass
        otracing.write_span_shard(tmp_path, "w0", buffer=buf)
        with otrace.span("two", buffer=buf):
            pass
        otracing.write_span_shard(tmp_path, "w0", buffer=buf)
        (doc,) = otracing.harvest_shards(tmp_path)
        assert [e["name"] for e in doc["events"]] == ["one", "two"]
        files = os.listdir(tmp_path / otracing.SHARD_DIR)
        assert files == ["w0.trace.json"]

    def test_reference_reads_the_port_s_shards(self, tmp_path):
        with otrace.span("port.work"):
            pass
        otracing.write_span_shard(tmp_path, "port")
        (doc,) = jax_tracing.harvest_shards(tmp_path)
        assert doc["worker"] == "port"
        assert [e["name"] for e in doc["events"]] == ["port.work"]

    def test_clock_handshake_round_trip(self, tmp_path):
        path = otracing.record_clock_handshake(tmp_path, "w3")
        assert os.path.basename(path).startswith(".traceclock.")
        hs = otracing.read_clock_handshakes(tmp_path)
        assert hs["w3"]["pid"] == os.getpid()
        assert hs["w3"]["epoch_unix"] == pytest.approx(
            otrace.epoch_unix())


class TestSpanTree:
    def test_tree_nests_by_parent_and_filters_by_trace(self):
        t, other = "a" * 32, "b" * 32
        events = [
            _ev("root", 0.0, 10.0, 1, t, "r" * 16),
            _ev("mid", 2.0, 5.0, 1, t, "m" * 16, "r" * 16),
            _ev("leaf", 3.0, 1.0, 2, t, "l" * 16, "m" * 16),
            _ev("noise", 0.0, 1.0, 3, other, "n" * 16),
            _ev("untraced", 0.0, 1.0, 3),
        ]
        (root,) = otracing.span_tree(events, t)
        assert root["name"] == "root"
        (mid,) = root["children"]
        assert mid["name"] == "mid"
        assert [c["name"] for c in mid["children"]] == ["leaf"]
        assert otracing.span_tree(events, t) \
            == jax_tracing.span_tree(events, t)

    def test_orphaned_parent_surfaces_as_root(self):
        t = "a" * 32
        events = [_ev("leaf", 3.0, 1.0, 2, t, "l" * 16, "gone" * 4)]
        (root,) = otracing.span_tree(events, t)
        assert root["name"] == "leaf"


# ---------------------------------------------------------------------------
# one-pane snapshot merge
# ---------------------------------------------------------------------------
def _replica_registry(mod, admitted, ttfts):
    r = mod.MetricsRegistry()
    c = r.counter("serving_requests_admitted_total", "h")
    c.inc(admitted)
    h = r.histogram("serving_ttft_seconds", "h", buckets=(0.1, 1.0))
    for v in ttfts:
        h.observe(v)
    r.counter("router_requests_routed_total", "h",
              labelnames=("replica",)).labels("x").inc(2)
    return r


class TestSnapshotMerge:
    def test_merge_labels_preserved_and_aggregate_exact(self):
        r0 = _replica_registry(om, 3, [0.05, 0.5])
        r1 = _replica_registry(om, 4, [0.5, 2.0, 2.0])
        merged = oexport.merge_snapshots(
            [("replica-0", oexport.json_snapshot(r0)),
             ("replica-1", oexport.json_snapshot(r1))])
        by_name = {e["name"]: e for e in merged}
        ctr = by_name["serving_requests_admitted_total"]
        assert ctr["labelnames"] == ["replica"]
        assert {tuple(s["labels"]): s["value"]
                for s in ctr["samples"]} == {("replica-0",): 3.0,
                                             ("replica-1",): 4.0}
        routed = by_name["router_requests_routed_total"]
        assert ["replica-0", "x"] in [s["labels"]
                                      for s in routed["samples"]]
        agg = {e["name"]: e for e in oexport.aggregate_snapshot(merged)}
        assert agg["serving_requests_admitted_total"]["samples"][0][
            "value"] == 7.0
        hist = agg["serving_ttft_seconds"]["samples"][0]
        assert hist["counts"] == [1, 2, 2]
        assert hist["count"] == 5
        assert hist["sum"] == pytest.approx(0.05 + 0.5 + 0.5 + 4.0)
        text = oexport.snapshot_to_prometheus(merged)
        assert 'replica="replica-0"' in text
        assert 'replica="replica-1"' in text

    def test_schema_skew_skipped_not_fatal(self):
        r0 = om.MetricsRegistry()
        r0.counter("m_total", "h").inc()
        r1 = om.MetricsRegistry()
        r1.gauge("m_total", "h").set(5)     # skewed replica
        merged = oexport.merge_snapshots(
            [("a", oexport.json_snapshot(r0)),
             ("b", oexport.json_snapshot(r1))])
        (entry,) = merged
        assert entry["type"] == "counter"
        assert [s["labels"] for s in entry["samples"]] == [["a"]]

    def test_port_and_reference_panes_merge(self):
        """A port replica's snapshot and a reference replica's merge into
        one pane, and both packages render the same snapshot to the same
        text."""
        mine = oexport.json_snapshot(_replica_registry(om, 3, [0.05]))
        ref = jax_export.json_snapshot(_replica_registry(jax_om, 4,
                                                          [0.5]))
        assert mine == json.loads(json.dumps(mine))
        merged = oexport.merge_snapshots([("port", mine),
                                          ("reference", ref)])
        assert merged == jax_export.merge_snapshots([("port", mine),
                                                     ("reference", ref)])
        assert oexport.snapshot_to_prometheus(merged) \
            == jax_export.snapshot_to_prometheus(merged)
        agg = oexport.aggregate_snapshot(merged)
        assert agg == jax_export.aggregate_snapshot(merged)


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------
class TestSloEngine:
    def test_burn_rate_from_cumulative_deltas(self):
        eng = oslo.SloEngine(
            slos=[oslo.SloSpec("ttft", "serving_ttft_seconds", 0.5,
                               objective=0.99)],
            windows=(60.0,), registry=om.MetricsRegistry())
        buckets = (0.1, 0.5, 1.0)
        eng.observe("ttft", buckets, [5, 5, 0, 0], now=1000.0)
        eng.observe("ttft", buckets, [9, 9, 1, 1], now=1030.0)
        rates = eng.burn_rates(now=1030.0)
        assert rates["ttft"]["60s"] == pytest.approx((2 / 20) / 0.01)

    def test_window_baseline_and_no_traffic(self):
        eng = oslo.SloEngine(
            slos=[oslo.SloSpec("ttft", "m", 0.5, objective=0.9)],
            windows=(10.0, 1000.0), registry=om.MetricsRegistry())
        eng.observe("ttft", (0.5,), [10, 0], now=0.0)
        eng.observe("ttft", (0.5,), [10, 5], now=100.0)
        rates = eng.burn_rates(now=100.0)
        assert rates["ttft"]["10s"] == pytest.approx(1.0 / 0.1)
        assert rates["ttft"]["1000s"] == pytest.approx((5 / 15) / 0.1)
        eng.observe("ttft", (0.5,), [10, 5], now=200.0)
        assert eng.burn_rates(now=200.0)["ttft"]["10s"] == 0.0

    def test_counter_reset_reports_zero_not_negative(self):
        eng = oslo.SloEngine(
            slos=[oslo.SloSpec("ttft", "m", 0.5)],
            windows=(60.0,), registry=om.MetricsRegistry())
        eng.observe("ttft", (0.5,), [100, 50], now=0.0)
        eng.observe("ttft", (0.5,), [2, 0], now=100.0)
        assert eng.burn_rates(now=100.0)["ttft"]["60s"] == 0.0

    def test_threshold_inside_bucket_counts_bucket_good(self):
        good, bad = oslo._split_counts((0.1, 1.0), [3, 4, 5], 0.5)
        assert (good, bad) == (3, 9)
        good, bad = oslo._split_counts((0.1, 1.0), [3, 4, 5], 1.0)
        assert (good, bad) == (7, 5)

    def test_gauge_published_with_slo_and_window_labels(self):
        reg = om.MetricsRegistry()
        eng = oslo.SloEngine(windows=(60.0,), registry=reg)
        eng.observe("ttft", (0.5,), [1, 1], now=0.0)
        eng.burn_rates(now=0.0)
        m = reg.get("serving_slo_burn_rate")
        assert m.labelnames == ("slo", "window")
        assert {v for v, _ in m.samples()} >= {("ttft", "60s"),
                                               ("tpot", "60s")}

    def test_kill_switch_noop(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        eng = oslo.SloEngine(windows=(60.0,))
        eng.observe("ttft", (0.5,), [1, 1])
        assert eng.burn_rates()["ttft"]["60s"] == 0.0

    def test_burn_rates_are_the_reference_s(self):
        rng = np.random.RandomState(3)
        buckets = (0.05, 0.1, 0.5, 1.0)
        engines = [m.SloEngine(windows=(30.0, 300.0),
                               registry=r.MetricsRegistry())
                   for m, r in ((oslo, om), (jax_slo, jax_om))]
        counts = np.zeros(len(buckets) + 1, np.int64)
        for step in range(12):
            counts += rng.randint(0, 20, counts.shape)
            for eng in engines:
                eng.observe("ttft", buckets, counts.tolist(),
                            now=10.0 * step)
                eng.observe("tpot", buckets, (2 * counts).tolist(),
                            now=10.0 * step)
        got, want = (e.burn_rates(now=110.0) for e in engines)
        assert got == want


# ---------------------------------------------------------------------------
# histogram_quantile (tests/test_slo_quantiles.py)
# ---------------------------------------------------------------------------
def _bucketize(values, buckets):
    counts = [0] * (len(buckets) + 1)
    for v in values:
        counts[bisect.bisect_left(buckets, v)] += 1
    return counts


BUCKETS = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5]


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99])
def test_dense_uniform_within_bucket_width(q):
    rng = np.random.RandomState(0)
    vals = rng.uniform(0.0, 1.0, 20000)
    counts = _bucketize(vals, BUCKETS)
    est = histogram_quantile(BUCKETS, counts, q)
    assert est == jax_slo.histogram_quantile(BUCKETS, counts, q)
    exact = float(np.quantile(vals, q))
    i = bisect.bisect_left(BUCKETS, exact)
    lo = BUCKETS[i - 1] if i > 0 else 0.0
    width = BUCKETS[min(i, len(BUCKETS) - 1)] - lo
    assert abs(est - exact) <= width + 1e-9


def test_exact_on_bucket_boundaries():
    counts = [0] * (len(BUCKETS) + 1)
    counts[4] = 100
    assert histogram_quantile(BUCKETS, counts, 1.0) == pytest.approx(0.1)
    assert histogram_quantile(BUCKETS, counts, 0.5) == \
        pytest.approx(0.075)


def test_sparse_buckets():
    rng = np.random.RandomState(1)
    vals = np.concatenate([rng.uniform(0.006, 0.009, 900),
                           rng.uniform(0.6, 0.9, 100)])
    counts = _bucketize(vals, BUCKETS)
    p50 = histogram_quantile(BUCKETS, counts, 0.5)
    p99 = histogram_quantile(BUCKETS, counts, 0.99)
    assert 0.005 < p50 <= 0.01
    assert 0.5 < p99 <= 1.0
    assert abs(p99 - float(np.quantile(vals, 0.99))) <= 0.5


def test_all_in_one_bucket():
    counts = [0] * (len(BUCKETS) + 1)
    counts[2] = 57
    for q in (0.01, 0.5, 0.99):
        assert 0.01 <= histogram_quantile(BUCKETS, counts, q) <= 0.025
    assert histogram_quantile(BUCKETS, counts, 0.5) == \
        pytest.approx(0.01 + 0.015 * 0.5)


def test_inf_tail_clamps_to_highest_finite_bound():
    counts = [0] * (len(BUCKETS) + 1)
    counts[-1] = 10
    assert histogram_quantile(BUCKETS, counts, 0.5) == BUCKETS[-1]
    counts = [0] * (len(BUCKETS) + 1)
    counts[0] = 90
    counts[-1] = 10
    assert histogram_quantile(BUCKETS, counts, 0.5) <= BUCKETS[0]
    assert histogram_quantile(BUCKETS, counts, 0.99) == BUCKETS[-1]


def test_delta_of_cumulative_snapshots():
    rng = np.random.RandomState(2)
    old = rng.uniform(0.0, 0.05, 5000)
    new = rng.uniform(0.2, 0.5, 5000)
    c1 = np.array(_bucketize(old, BUCKETS))
    c2 = c1 + np.array(_bucketize(new, BUCKETS))
    delta = (c2 - c1).tolist()
    est = histogram_quantile(BUCKETS, delta, 0.5)
    assert abs(est - float(np.quantile(new, 0.5))) <= 0.25
    assert est > histogram_quantile(BUCKETS, c2.tolist(), 0.5)


def test_empty_and_reset_return_none():
    counts = [0] * (len(BUCKETS) + 1)
    assert histogram_quantile(BUCKETS, counts, 0.5) is None
    counts[0], counts[1] = 5, -3
    assert histogram_quantile(BUCKETS, counts, 0.5) is None


def test_input_validation():
    with pytest.raises(ValueError):
        histogram_quantile(BUCKETS, [0] * (len(BUCKETS) + 1), 1.5)
    with pytest.raises(ValueError):
        histogram_quantile(BUCKETS, [0] * len(BUCKETS), 0.5)


def test_quantiles_are_the_reference_s_on_random_histograms():
    rng = np.random.RandomState(4)
    for _ in range(50):
        counts = rng.randint(0, 30, len(BUCKETS) + 1).tolist()
        for q in (0.1, 0.5, 0.9, 0.99, 1.0):
            assert histogram_quantile(BUCKETS, counts, q) \
                == jax_slo.histogram_quantile(BUCKETS, counts, q)
