"""The port's observability layer (``paddle_tpu_torch/observability``)
against what the reference's ``tests/test_observability.py`` and
``tests/test_perf_attribution.py`` check: registry semantics, the
exporters and the scrape endpoint, spans and their chrome-trace export,
the compile watcher (kernel builds and loads, CUDA-graph captures, the
recompile storm, the shape registry, device-memory gauges), the flight
recorder, the step watchdog's series, the allocator's counters, the perf
attribution layer, and the parts deferred to later ROADMAP items raising
with their item. The serving engine's wiring is
``tests/test_torch_metrics_parity.py``."""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability import metrics as jax_om

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import compile_watch as ocw
from paddle_tpu_torch.observability import export as oexport
from paddle_tpu_torch.observability import flight_recorder as ofr
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.observability import perf
from paddle_tpu_torch.observability import trace as otrace


@pytest.fixture(autouse=True)
def _fresh_default_registry():
    om.default_registry().clear()
    otrace.clear()
    ocw.reset()
    perf.reset()
    ofr.uninstall()
    yield
    om.default_registry().clear()
    otrace.clear()
    ocw.reset()
    perf.reset()
    ofr.uninstall()


def _strict_loads(text):
    """json.loads that rejects the non-standard Infinity/NaN literals."""
    def _reject(value):
        raise ValueError(f"non-strict JSON constant {value!r}")

    return json.loads(text, parse_constant=_reject)


def _bundle_dirs(log_dir):
    root = os.path.join(str(log_dir), "postmortem")
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root))


def _peek(name, *labels):
    m = om.default_registry().get(name)
    if m is None:
        return None
    child = m.peek(*labels)
    return None if child is None else child.value


# ---------------------------------------------------------------------------
# registry + metric semantics
# ---------------------------------------------------------------------------
class TestRegistry:
    def test_counter_inc(self):
        c = om.counter("c_total", "help text")
        c.inc()
        c.inc(4)
        assert c.value == 5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_get_or_create_idempotent(self):
        assert om.counter("same_total") is om.counter("same_total")
        with pytest.raises(ValueError):
            om.gauge("same_total")

    def test_reregistration_spec_conflicts(self):
        om.counter("spec_total")
        with pytest.raises(ValueError):
            om.counter("spec_total", labelnames=("k",))
        om.histogram("spec_lat", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            om.histogram("spec_lat", buckets=(5.0,))
        assert om.histogram("spec_lat", buckets=(2.0, 1.0)) is \
            om.histogram("spec_lat", buckets=(1.0, 2.0))

    def test_labels_children(self):
        c = om.counter("by_verb_total", labelnames=("verb",))
        c.labels("GET").inc(2)
        c.labels(verb="GET").inc()
        c.labels("POST").inc()
        assert c.labels("GET").value == 3
        assert c.labels("POST").value == 1
        with pytest.raises(ValueError):
            c.inc()
        with pytest.raises(ValueError):
            c.labels("a", "b")

    def test_histogram_buckets_and_edges(self):
        h = om.histogram("lat", buckets=(0.1, 1.0, 5.0))
        for v in (0.05, 0.5, 0.5, 2.0, 50.0, 1.0):
            h.observe(v)
        assert h.raw_counts == [1, 3, 1, 1]
        assert h.cumulative_counts() == [1, 4, 5, 6]
        assert abs(h.sum - 54.05) < 1e-9

    def test_disabled_registers_nothing(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        c = om.counter("ghost_total")
        c.inc()
        c.labels("x").observe(3)
        assert c is om.NULL
        assert om.default_registry().collect() == []

    def test_thread_safety(self):
        c = om.counter("race_total")
        h = om.histogram("race_lat", buckets=(0.5,))

        def work():
            for _ in range(1000):
                c.inc()
                h.observe(0.1)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == 8000 and h.count == 8000


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def _demo_registry(mod=om):
    r = mod.MetricsRegistry()
    r.counter("reqs_total", "requests", labelnames=("verb",)) \
        .labels("GET").inc(3)
    r.gauge("depth", "queue depth").set(2)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(7.0)
    return r


class TestExport:
    def test_prometheus_text_format(self):
        lines = oexport.prometheus_text(_demo_registry()).splitlines()
        for want in ("# TYPE reqs_total counter", 'reqs_total{verb="GET"} 3',
                     "# TYPE depth gauge", "depth 2",
                     "# TYPE lat_seconds histogram",
                     'lat_seconds_bucket{le="0.1"} 1',
                     'lat_seconds_bucket{le="1"} 2',
                     'lat_seconds_bucket{le="+Inf"} 3',
                     "lat_seconds_count 3"):
            assert want in lines
        assert any(line.startswith("lat_seconds_sum ") for line in lines)

    def test_text_is_the_reference_s(self):
        assert oexport.prometheus_text(_demo_registry()) \
            == jax_export.prometheus_text(_demo_registry(jax_om))

    def test_non_finite_values_do_not_break_export(self):
        r = om.MetricsRegistry()
        r.gauge("weird").set(float("inf"))
        r.gauge("weirder").set(float("nan"))
        h = r.histogram("h", buckets=(0.1, float("inf")))
        assert h.buckets == (0.1,)
        h.observe(5.0)
        h.observe(float("nan"))
        assert h.raw_counts == [0, 2]
        text = oexport.prometheus_text(r)
        assert "weird +Inf" in text and "weirder NaN" in text
        snap = json.loads(json.dumps(oexport.json_snapshot(r),
                                     allow_nan=False))
        assert oexport.snapshot_to_prometheus(snap) == text

    def test_text_round_trips_through_json_snapshot(self):
        r = _demo_registry()
        text = oexport.prometheus_text(r)
        snap = json.loads(json.dumps(oexport.json_snapshot(r)))
        assert oexport.snapshot_to_prometheus(snap) == text

    def test_http_scrape_endpoint(self):
        srv = oexport.start_http_server(port=0, registry=_demo_registry())
        try:
            base = f"http://127.0.0.1:{srv.port}"
            body = urllib.request.urlopen(f"{base}/metrics").read().decode()
            assert 'reqs_total{verb="GET"} 3' in body
            snap = json.loads(
                urllib.request.urlopen(f"{base}/metrics.json").read())
            assert {e["name"] for e in snap} == \
                {"reqs_total", "depth", "lat_seconds",
                 "paddle_tpu_build_info"}
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"{base}/nope")
        finally:
            srv.stop()

    def test_healthz_readyz_and_head_support(self):
        ready = [True]
        srv = oexport.start_http_server(port=0, registry=_demo_registry(),
                                        ready=lambda: ready[0])
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(f"{base}/healthz") as resp:
                doc = _strict_loads(resp.read().decode())
            assert doc["status"] == "ok" and doc["pid"] == os.getpid()
            assert doc["uptime_seconds"] >= 0
            get_body = urllib.request.urlopen(f"{base}/metrics").read()
            head = urllib.request.Request(f"{base}/metrics", method="HEAD")
            with urllib.request.urlopen(head) as resp:
                assert resp.status == 200
                assert int(resp.headers["Content-Length"]) \
                    == len(get_body)
                assert resp.read() == b""
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(urllib.request.Request(
                    f"{base}/nope", method="HEAD"))
            assert urllib.request.urlopen(f"{base}/readyz").status == 200
            ready[0] = False
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/readyz")
            assert e.value.code == 503
        finally:
            srv.stop()

    def test_debug_profile_names_its_item(self, monkeypatch):
        """The local profiler capture comes with ROADMAP A9: the route
        says so (500), and under the kill switch answers 503 as the
        reference."""
        srv = oexport.start_http_server(port=0, registry=_demo_registry())
        try:
            url = f"http://127.0.0.1:{srv.port}/debug/profile?seconds=0"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url)
            assert e.value.code == 500 and b"A9" in e.value.read()
            monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url)
            assert e.value.code == 503
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class TestTrace:
    def test_span_context_manager_records(self):
        with obs.span("unit.work", k=1):
            time.sleep(0.01)
        (ev,) = otrace.get_events()
        assert ev["name"] == "unit.work" and ev["ph"] == "X"
        assert ev["dur"] >= 10_000 * 0.5
        assert ev["args"] == {"k": 1}

    def test_span_decorator(self):
        @obs.span("unit.fn")
        def fn(x):
            return x + 1

        assert fn(1) == 2 and fn(2) == 3
        assert [e["name"] for e in otrace.get_events()] \
            == ["unit.fn", "unit.fn"]

    def test_span_disabled(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        with obs.span("ghost"):
            pass
        assert otrace.get_events() == []

    def test_ring_buffer_capacity(self):
        buf = otrace.TraceBuffer(capacity=4)
        for i in range(10):
            with obs.span(f"s{i}", buffer=buf):
                pass
        assert [e["name"] for e in buf.events()] \
            == ["s6", "s7", "s8", "s9"]

    def test_chrome_trace_export_layout_and_no_collisions(self, tmp_path):
        with obs.span("exported"):
            pass
        p1 = obs.export_chrome_trace(str(tmp_path), worker_name="w0")
        p2 = obs.export_chrome_trace(str(tmp_path), worker_name="w0")
        assert "/plugins/profile/" in p1 and p1 != p2
        assert p1.endswith("w0.host_spans.trace.json")
        with open(p1) as f:
            assert json.load(f)["traceEvents"][0]["name"] == "exported"
        empty = obs.export_chrome_trace(str(tmp_path), worker_name="w1",
                                        buffer=otrace.TraceBuffer())
        with open(empty) as f:
            assert json.load(f)["traceEvents"] == []


# ---------------------------------------------------------------------------
# the compile watcher: kernel builds and loads, graph captures
# ---------------------------------------------------------------------------
class TestCompileWatch:
    def test_library_tallies_once_per_process(self):
        ocw.note_library("ragged_paged_attention", built=True)
        ocw.note_library("ragged_paged_attention", built=False)
        ocw.note_library("sampling", built=False)
        ocw.note_build("ragged_paged_attention", 12.5)
        reg = om.default_registry()
        assert reg.get("compile_cache_miss_total").value == 1
        assert reg.get("compile_cache_hit_total").value == 1
        assert reg.get("paddle_tpu_xla_backend_compile_total").value == 1
        assert reg.get("paddle_tpu_xla_backend_compile_seconds").count == 1
        assert ocw.persistent_cache_stats()["hits"] == 1
        (ev,) = ocw.recent_compile_events()
        assert ev["kind"] == "backend_compile"
        assert ev["name"] == "kernel:ragged_paged_attention"

    def test_build_all_reports_hits_for_built_libraries(self, tmp_path,
                                                        monkeypatch):
        """``_build.build_all`` finds a library on disk: a cache hit, no
        backend compile (a source whose library is missing would need
        ``nvcc``, which the CPU has not)."""
        from paddle_tpu_torch.ops import _build
        monkeypatch.setattr(_build, "BUILD", str(tmp_path))
        path = _build._lib_path("sampling")
        os.makedirs(os.path.dirname(path))
        open(path, "wb").close()
        assert _build.build_all(["sampling"]) == {"sampling": path}
        reg = om.default_registry()
        assert reg.get("compile_cache_hit_total").value == 1
        assert reg.get("paddle_tpu_xla_backend_compile_total") is None

    def test_captures_count_per_callable_and_signature(self):
        for key in ("greedy", "bias", "greedy"):
            ocw.note_capture("serving.decode_tick", key, 0.2)
        reg = om.default_registry()
        assert reg.get("paddle_tpu_xla_compile_total") \
            .labels("serving.decode_tick").value == 3
        assert reg.get("paddle_tpu_xla_distinct_signatures") \
            .labels("serving.decode_tick").value == 2
        assert reg.get("paddle_tpu_xla_compile_seconds") \
            .labels("serving.decode_tick").count == 3
        storms = reg.get("paddle_tpu_xla_recompile_storm_total")
        assert storms is None
        names = [e["name"] for e in ocw.recent_compile_events()]
        assert names == ["serving.decode_tick"] * 3

    def test_capture_churn_is_a_recompile_storm(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_RECOMPILE_STORM_SIGS", "2")
        for max_len in (64, 96, 128, 160):
            ocw.note_capture("generate.decode_step",
                             (("greedy",), 4, max_len), 0.1)
        reg = om.default_registry()
        assert reg.get("paddle_tpu_xla_recompile_storm_total") \
            .labels("generate.decode_step").value == 2
        diag = ocw._watch("generate.decode_step").last_diagnosis
        assert "generate.decode_step" in diag and "graph churns 4" in diag

    def test_step_graphs_name_their_captures(self):
        from paddle_tpu_torch.ops._graphs import StepGraphs
        assert StepGraphs("cpu").name == "graphs"
        assert StepGraphs("cpu", name="serving.decode_tick").name \
            == "serving.decode_tick"

    def test_disabled_counts_nothing(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        ocw.note_library("x", built=True)
        ocw.note_build("x", 1.0)
        ocw.note_capture("g", "k", 1.0)
        assert om.default_registry().collect() == []
        assert ocw.recent_compile_events() == []
        assert ocw._watch("g") is ocw.NULL_WATCH
        # the tallies replicas report stay on, as the reference's
        assert ocw.persistent_cache_stats()["misses"] == 1

    def test_deferred_wrappers_name_their_items(self):
        with pytest.raises(NotImplementedError, match="A11.*A13"):
            obs.watch("x")
        with pytest.raises(NotImplementedError, match="A11.*A13"):
            obs.watched_jit(lambda x: x)

    def test_shape_registry_round_trip(self, tmp_path):
        reg = ocw.SignatureRegistry(str(tmp_path / "s" / "shapes.json"))
        assert reg.record("k", "mixed", 16) is True
        assert reg.record("k", "mixed", 4) is True
        assert reg.record("k", "mixed", 16) is False
        reg.record("k", "scan", 8)
        assert reg.lookup("k") == {"mixed": [4, 16], "scan": [8]}
        assert reg.lookup("other") == {}
        assert not [f for f in os.listdir(tmp_path / "s") if "tmp" in f]

    def test_cache_dir_and_kill_switch(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR",
                           str(tmp_path / "c"))
        assert ocw.default_cache_dir() == str(tmp_path / "c")
        monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "0")
        assert ocw.enable_persistent_cache() is None

    def test_sample_device_memory_gauges(self):
        sample = obs.sample_device_memory()
        reg = om.default_registry()
        assert sample["bytes_in_use"] > 0
        assert reg.get("paddle_tpu_device_bytes_in_use").value \
            == sample["bytes_in_use"]
        assert reg.get("paddle_tpu_live_array_bytes").value > 0
        assert reg.get("paddle_tpu_device_peak_bytes_in_use").value \
            >= reg.get("paddle_tpu_device_bytes_in_use").value
        # throttled per registry
        assert obs.sample_device_memory(min_interval=60.0) is not None
        assert obs.sample_device_memory(min_interval=60.0) is None

    def test_sample_device_memory_skips_under_capture(self):
        from paddle_tpu_torch.ops._graphs import CAPTURE_LOCK
        got = []
        with CAPTURE_LOCK:
            t = threading.Thread(
                target=lambda: got.append(obs.sample_device_memory()))
            t.start()
            t.join()
        assert got == [None]
        assert om.default_registry().get(
            "paddle_tpu_device_bytes_in_use") is None

    def test_sample_device_memory_disabled(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        assert obs.sample_device_memory() is None
        assert om.default_registry().collect() == []


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_dump_bundle_is_loadable(self, tmp_path):
        rec = ofr.install(log_dir=str(tmp_path))
        with obs.span("fr.work", step=1):
            pass
        with obs.span("fr.nan", loss=float("nan"), cfg=object()):
            pass
        ocw.note_capture("fr.graphs", "greedy", 0.25)
        om.counter("fr_steps_total").inc(5)
        rec.note_snapshot(force=True)
        out = ofr.dump(reason="unit-test")
        assert out is not None and os.path.isdir(out)
        with open(os.path.join(out, "trace.json")) as f:
            doc = _strict_loads(f.read())
        names = [e["name"] for e in doc["traceEvents"]]
        assert "fr.work" in names
        assert "xla_compile:fr.graphs" in names
        (nan_ev,) = [e for e in doc["traceEvents"]
                     if e["name"] == "fr.nan"]
        assert nan_ev["args"]["loss"] == "NaN"
        with open(os.path.join(out, "metrics.json")) as f:
            metrics_doc = _strict_loads(f.read())
        assert "fr_steps_total" in {e["name"]
                                    for e in metrics_doc["snapshot"]}
        assert len(metrics_doc["history"]) == 1
        with open(os.path.join(out, "compile_log.txt")) as f:
            assert "fr.graphs" in f.read()
        with open(os.path.join(out, "env.json")) as f:
            env_doc = _strict_loads(f.read())
        assert env_doc["reason"] == "unit-test"
        assert env_doc["pid"] == os.getpid()
        assert "torch_version" in env_doc and "memory_stats" in env_doc

    def test_device_queries_guarded_one_by_one(self, tmp_path,
                                               monkeypatch):
        """A device query that fails (as after a sticky CUDA error) costs
        its key, never the bundle."""
        import torch
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

        def dead(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")
        for name in ("memory_stats", "mem_get_info", "memory_allocated",
                     "memory_reserved", "max_memory_allocated",
                     "device_count"):
            monkeypatch.setattr(torch.cuda, name, dead)
        ofr.install(log_dir=str(tmp_path))
        out = ofr.dump(reason="sticky", exc=RuntimeError("illegal"))
        with open(os.path.join(out, "env.json")) as f:
            doc = _strict_loads(f.read())
        assert doc["reason"] == "sticky" and doc["backend"] == "cuda"
        assert "illegal memory access" in doc["mem_get_info_error"]
        assert doc["memory_stats"] == {}
        for name in ("trace.json", "metrics.json", "error.txt"):
            assert os.path.exists(os.path.join(out, name))

    def test_excepthook_dumps_and_chains(self, tmp_path):
        seen = []
        prev = sys.excepthook
        sys.excepthook = lambda *a: seen.append(a)
        try:
            ofr.install(log_dir=str(tmp_path))
            try:
                raise RuntimeError("mid-step crash")
            except RuntimeError:
                sys.excepthook(*sys.exc_info())
        finally:
            ofr.uninstall()
            sys.excepthook = prev
        assert len(seen) == 1
        (bundle,) = _bundle_dirs(tmp_path)
        with open(os.path.join(bundle, "error.txt")) as f:
            assert "mid-step crash" in f.read()

    def test_exception_dumped_once_across_nested_paths(self, tmp_path):
        ofr.install(log_dir=str(tmp_path))
        err = RuntimeError("boom")
        assert ofr.on_fatal("serving.step", err) is not None
        assert ofr.on_fatal("serving.generate", err) is None
        assert ofr.on_fatal("serving.step", RuntimeError("again")) is None
        assert len(_bundle_dirs(tmp_path)) == 1

    def test_dump_budget_is_bounded(self, tmp_path):
        ofr.install(log_dir=str(tmp_path))
        outs = [ofr.dump(reason=f"r{i}") for i in range(ofr.MAX_DUMPS + 2)]
        assert sum(o is not None for o in outs) == ofr.MAX_DUMPS
        assert len(_bundle_dirs(tmp_path)) == ofr.MAX_DUMPS

    def test_install_repoints_and_periodic_snapshot(self, tmp_path):
        rec = ofr.install(log_dir=str(tmp_path / "a"),
                          snapshot_interval=0.0)
        assert ofr.installed() is rec
        assert ofr.install(log_dir=str(tmp_path / "b")) is rec
        assert rec.log_dir == str(tmp_path / "b")
        assert ofr.periodic_snapshot() is True
        ofr.uninstall()
        assert ofr.installed() is None and ofr.periodic_snapshot() is False

    def test_disabled_is_noop_no_files(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        assert ofr.install(log_dir=str(tmp_path)) is None
        assert ofr.dump(reason="nope") is None
        assert ofr.on_fatal("nope") is None
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               "postmortem"))


# ---------------------------------------------------------------------------
# the step watchdog's series and post-mortem
# ---------------------------------------------------------------------------
class TestWatchdog:
    def test_watchdog_counters(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        fired = []
        wd = StepWatchdog(timeout=0.05, poll=0.02, on_timeout=fired.append)
        reg = om.default_registry()
        with wd:
            time.sleep(0.3)
            age_live = reg.get("watchdog_heartbeat_age_seconds") \
                .labels(wd.name).value
        assert fired and age_live > 0
        assert reg.get("watchdog_timeouts_total") \
            .labels(wd.name).value >= 1
        assert all(v != (wd.name,) for v, _ in
                   reg.get("watchdog_heartbeat_age_seconds").samples())

    def test_watchdog_stop_drops_zero_count_children(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        wd = StepWatchdog(timeout=30)
        with wd:
            wd.beat()
        reg = om.default_registry()
        for metric in ("watchdog_heartbeat_age_seconds",
                       "watchdog_timeouts_total"):
            assert all(v != (wd.name,) for v, _ in
                       reg.get(metric).samples())

    def test_watchdog_same_name_survivor_keeps_series(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        first = StepWatchdog(timeout=30, name="shared")
        second = StepWatchdog(timeout=30, name="shared")
        first.start()
        second.start()
        first.stop()
        second.beat()
        age = om.default_registry().get("watchdog_heartbeat_age_seconds")
        assert any(v == ("shared",) for v, _ in age.samples())
        second.stop()
        assert all(v != ("shared",) for v, _ in age.samples())

    def test_abandoned_watchdog_does_not_pin_series_removal(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        StepWatchdog(timeout=30, name="pinned")
        with StepWatchdog(timeout=30, name="pinned"):
            pass
        age = om.default_registry().get("watchdog_heartbeat_age_seconds")
        assert all(v != ("pinned",) for v, _ in age.samples())

    def test_watchdog_started_after_sibling_stop_reexports(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        first = StepWatchdog(timeout=30, name="reborn")
        first.start()
        second = StepWatchdog(timeout=30, name="reborn")
        first.stop()
        second.start()
        second.beat()
        age = om.default_registry().get("watchdog_heartbeat_age_seconds")
        assert any(v == ("reborn",) for v, _ in age.samples())
        second.stop()
        assert all(v != ("reborn",) for v, _ in age.samples())

    def test_watchdog_instances_do_not_share_age_gauge(self):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        stalled = StepWatchdog(timeout=30, name="stalled")
        healthy = StepWatchdog(timeout=30)
        assert healthy.name != stalled.name
        assert healthy.name != StepWatchdog(timeout=30).name
        stalled._m_age.set(40.0)
        healthy.beat()
        age = om.default_registry().get("watchdog_heartbeat_age_seconds")
        assert age.labels("stalled").value == 40.0
        assert age.labels(healthy.name).value == 0.0

    def test_watchdog_timeout_dumps(self, tmp_path):
        from paddle_tpu_torch.distributed.watchdog import StepWatchdog
        ofr.install(log_dir=str(tmp_path))
        fired = []
        with StepWatchdog(timeout=0.05, poll=0.02,
                          on_timeout=fired.append):
            time.sleep(0.3)
        assert fired
        bundles = _bundle_dirs(tmp_path)
        assert len(bundles) >= 1
        with open(os.path.join(bundles[0], "env.json")) as f:
            doc = _strict_loads(f.read())
        assert doc["reason"].startswith("watchdog_timeout:")
        assert doc["info"]["gap_seconds"] > 0.05


# ---------------------------------------------------------------------------
# the allocator's counters
# ---------------------------------------------------------------------------
class TestAllocatorCounters:
    def test_cow_and_double_free_counted_as_reference(self):
        from paddle_tpu.inference.paged_cache import \
            PageAllocator as JaxAllocator

        from paddle_tpu_torch.inference.paged_cache import PageAllocator
        jax_om.default_registry().clear()
        counts = []
        for alloc_cls, reg in ((JaxAllocator, jax_om.default_registry()),
                               (PageAllocator, om.default_registry())):
            alloc = alloc_cls(8, 4)
            t1 = alloc.admit(1, 4)
            alloc.incref(t1[0])
            alloc.admit(2, 2, shared_pages=[t1[0]])
            alloc.extend(2, 1)
            assert alloc.ensure_writable(2, 2) is not None
            alloc.release(1)
            with pytest.warns(RuntimeWarning):
                alloc.release(1)
            with pytest.warns(RuntimeWarning):
                alloc.decref(7)
            counts.append((alloc.cow_count, alloc.double_free_count,
                           reg.get("kv_page_cow_total").value,
                           reg.get("kv_page_double_free_total").value))
        jax_om.default_registry().clear()
        assert counts[0] == counts[1] == (1, 2, 1, 2)

    def test_metric_specs_are_the_reference_s(self):
        from paddle_tpu.inference.paged_cache import \
            PageAllocator as JaxAllocator

        from paddle_tpu_torch.inference.paged_cache import PageAllocator
        mine, ref = PageAllocator(4, 4), JaxAllocator(4, 4)
        for a, b in ((mine._m_cow, ref._m_cow),
                     (mine._m_double_free, ref._m_double_free)):
            assert (a.name, a.kind, a.help, a.labelnames) \
                == (b.name, b.kind, b.help, b.labelnames)
        jax_om.default_registry().clear()


# ---------------------------------------------------------------------------
# perf attribution
# ---------------------------------------------------------------------------
def _feed(name, ms, n):
    last = None
    for _ in range(n):
        last = perf.observe(name, ms / 1e3, flops=1e9)
    return last


class TestPerf:
    def test_observe_publishes_fractions_against_peaks(self):
        peak_flops, peak_bw, kind = perf.device_peaks()
        assert kind == "cpu"
        s = perf.observe("m", 1e-3, flops=0.1 * peak_flops * 1e-3,
                         bytes_accessed=0.1 * peak_bw * 1e-3)
        assert s["attained_flops_frac"] == pytest.approx(0.1)
        assert s["attained_hbm_bw_frac"] == pytest.approx(0.1)
        assert _peek("paddle_tpu_perf_device_ms", "m") == \
            pytest.approx(1.0)
        assert _peek("paddle_tpu_perf_fenced_samples_total", "m") == 1.0

    def test_fractions_clamp_and_missing_cost(self):
        peak_flops, _, _ = perf.device_peaks()
        s = perf.observe("m", 1e-3, flops=5.0 * peak_flops * 1e-3)
        assert s["attained_flops_frac"] == 1.0
        s = perf.observe("n", 1e-3)
        assert "attained_flops_frac" not in s
        assert "attained_hbm_bw_frac" not in s

    def test_h100_row_and_env_overrides(self, monkeypatch):
        assert perf.PEAKS["NVIDIA H100 80GB HBM3"] == (989e12, 3.35e12)
        monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "2e12")
        monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_GBS", "100")
        perf.reset()
        flops, bw, _ = perf.device_peaks()
        assert (flops, bw) == (2e12, 100e9)

    def test_kill_switches(self, monkeypatch):
        for var in ("PADDLE_TPU_METRICS", "PADDLE_TPU_PERF"):
            monkeypatch.setenv(var, "0")
            assert not perf.enabled()
            assert perf.observe("m", 1e-3, flops=1e9) is None
            assert perf.fence("m") is None
            assert perf.note_dispatch("m", 0.0) is None
            monkeypatch.delenv(var)
        assert perf.enabled()

    def test_fence_throttle_and_host_clock(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_PERF_FENCE_INTERVAL", "60")
        t0 = time.perf_counter()
        f = perf.fence("d")
        assert f is not None and perf.fence("d") is None
        time.sleep(0.01)
        f.stop()
        s = perf.note_dispatch("d", t0, f, flops=1e6, bytes_accessed=1e6)
        assert s["device_ms"] >= 5.0
        assert perf.note_dispatch("d", t0) is None       # host only
        st = perf.recorders()["d"]
        assert st["samples"] == 1 and st["host_ewma_ms"] > 0

    def test_silent_on_steady_and_noise(self):
        _feed("steady", 1.0, 40)
        assert perf.recorders()["steady"]["regressions"] == 0
        rng = np.random.RandomState(0)
        for _ in range(60):
            perf.observe("noisy", rng.uniform(0.8e-3, 1.2e-3))
        assert perf.recorders()["noisy"]["regressions"] == 0

    def test_fires_on_sustained_slowdown_and_dumps(self, tmp_path):
        ofr.install(log_dir=str(tmp_path))
        _feed("hot", 1.0, 12)
        _feed("hot", 3.0, 8)
        assert perf.recorders()["hot"]["regressions"] >= 1
        assert _peek("paddle_tpu_perf_regressions_total", "hot") >= 1.0
        (bundle,) = _bundle_dirs(tmp_path)
        with open(os.path.join(bundle, "env.json")) as f:
            doc = json.loads(f.read())
        assert doc["reason"] == "perf_regression"
        assert doc["info"]["callable"] == "hot"
        assert doc["info"]["slowdown_x"] > 1.5

    def test_rebaselines_and_no_fire_during_warmup(self):
        _feed("rb", 1.0, 12)
        _feed("rb", 3.0, 8)
        fired = perf.recorders()["rb"]["regressions"]
        assert fired >= 1
        _feed("rb", 3.0, 20)
        assert perf.recorders()["rb"]["regressions"] == fired
        _feed("young", 1.0, 3)
        _feed("young", 5.0, 4)
        assert perf.recorders()["young"]["regressions"] == 0

    def test_dump_rate_limited_but_counter_ticks(self, monkeypatch):
        calls = []
        monkeypatch.setattr(ofr, "dump",
                            lambda **kw: calls.append(kw) or "/x")
        _feed("rl", 1.0, 12)
        _feed("rl", 3.0, 8)
        _feed("rl", 9.0, 8)
        assert perf.recorders()["rl"]["regressions"] == 2
        assert len(calls) == 1

    def test_build_info_fields_and_scrape(self, monkeypatch):
        import torch
        info = perf.build_info()
        assert set(info) == {"git_commit", "torch_version", "device_kind"}
        assert info["torch_version"] == torch.__version__
        srv = oexport.start_http_server(port=0)
        try:
            snap = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics.json").read())
        finally:
            srv.stop()
        (entry,) = [e for e in snap if e["name"] == "paddle_tpu_build_info"]
        assert entry["labelnames"] == ["git_commit", "torch_version",
                                       "device_kind"]
        assert entry["samples"][0]["value"] == 1.0
        monkeypatch.setenv("PADDLE_TPU_BUILD_COMMIT", "deadbeef")
        perf.reset()
        assert perf.build_info()["git_commit"] == "deadbeef"
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        assert perf.ensure_build_info() is None

    def test_capture_names_its_item(self, monkeypatch):
        with pytest.raises(NotImplementedError, match="A9"):
            obs.capture_local(0.1)
        with pytest.raises(NotImplementedError, match="A9"):
            obs.capture_bundle(0.1)
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        assert obs.capture_bundle(0.1) is None


def test_exports_are_the_reference_s_minus_the_deferred():
    """The package exports the reference's names (``NULL`` besides); the
    deferred ones exist and raise naming their item."""
    import paddle_tpu.observability as ref
    assert set(ref.__all__) <= set(obs.__all__)
    for name in ("watch", "watched_jit", "capture_local", "capture_bundle"):
        assert callable(getattr(obs, name))
