"""The port's serving engine wired to the observability layer, against
the reference engine's wiring (``tests/test_observability.py``'s serving
classes, ``TestMemoryIntegration``, the serving fatal path).

One shared workload runs through both engines in lockstep, each on a
cleared registry, over one tiny model fitted by ``fit_on_prompts`` (a
random-init model's logits are near-ties): a shared prefix, an eviction,
a shed, a cancel, a deadline and speculative decoding (``spec_k``, the
n-gram drafter), the reference on its two-op path (``fused_kv=False``:
the fused reference engine is not a trusted oracle on the CPU). Every
``serving_*``, ``kv_page_*`` and ``watchdog_*`` counter value and
histogram count must be equal; the sums and buckets of the time
histograms (TTFT, per-token latency) are wall-clock readings of two
different programs and are exempt. The shape registries both engines
write must hold the same recipe. Then the port alone: its metric set is
the reference's (names, kinds, help, labels, buckets), every name it can
register is one the reference registers (``tools/check_metrics_docs.py``),
``PADDLE_TPU_METRICS=0`` is bitwise the enabled run with nothing
registered, recorded or warmed, the warm-up dispatch leaves every page
as it was, the analytic ``serving_mixed_hbm_bytes`` puts the fused KV
write strictly below the two-op path, spans count the dispatches, the
generated-token count holds graphed and single-step, a raise inside
``step`` leaves one post-mortem, a stalled dispatch counts one watchdog
timeout, and a restarted engine's ``prewarm()`` warms the recorded
shapes.
"""

import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import compile_watch as jax_cw
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference import SamplingParams, serving
from paddle_tpu_torch.inference.serving import (AdmissionError,
                                                LlamaServingEngine, Request)
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import compile_watch as ocw
from paddle_tpu_torch.observability import flight_recorder as ofr
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.observability import perf
from paddle_tpu_torch.observability import trace as otrace
from paddle_tpu_torch.observability import tracing as otracing

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GEOM = dict(max_batch=3, page_size=8, num_pages=40, chunk_block=8,
            chunk_budget=16, decode_ticks=4)
#: the families the parity holds: every counter value, every histogram's
#: count
COMPARED = ("serving_", "kv_page_", "watchdog_")


@pytest.fixture(scope="module")
def fitted():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    quality.fit_on_prompts(jm, steps=20)
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


def _models(fitted):
    jm = JaxLlama(jax_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in fitted.items()})
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return jm, load_numpy_state(tm, fitted).eval()


@pytest.fixture(scope="module")
def port_model(fitted):
    return _models(fitted)[1]


@pytest.fixture(autouse=True)
def _fresh():
    om.default_registry().clear()
    otrace.clear()
    ocw.reset()
    ofr.uninstall()
    yield
    om.default_registry().clear()
    otrace.clear()
    ocw.reset()
    ofr.uninstall()


def _prompts(seed, lens, block=None):
    """Seeded prompts; with ``block``, each a repeated seeded block (the
    n-gram drafter proposes from repeats)."""
    rng = np.random.RandomState(seed)
    if block is None:
        return [rng.randint(0, 128, (n,)).tolist() for n in lens]
    out = []
    for n in lens:
        b = rng.randint(0, 128, (block,)).tolist()
        out.append((b * (n // block + 1))[:n])
    return out


def _counts(reg):
    """``{(name, labels): value}`` of every compared counter and
    ``{(name, labels): count}`` of every compared histogram."""
    out = {}
    for m in reg.collect():
        if not m.name.startswith(COMPARED) or m.kind == "gauge":
            continue
        for values, leaf in m.samples():
            out[(m.name, tuple(values))] = leaf.count \
                if m.kind == "histogram" else leaf.value
    return out


# ---------------------------------------------------------------------------
# the shared workload through both engines
# ---------------------------------------------------------------------------
def _workload(engine, mod):
    """Drive one engine through the shared workload; returns what both
    engines must agree on besides the registry."""
    prefix = _prompts(1, (16,), block=4)[0]
    suffixes = _prompts(2, (5, 7, 3, 6, 4, 9, 5))
    reqs = {}

    def req(name, tail, new=6, **kw):
        reqs[name] = mod.Request(prefix + tail, max_new_tokens=new, **kw)
        return reqs[name]

    def settle(names):
        for _ in range(200):
            if all(reqs[n].done for n in names):
                return
            engine.decode_many(4)
        raise AssertionError(f"not done: {names}")

    # a cold prompt fills the prefix cache; the next ones hit it
    engine.add_request(req("cold", suffixes[0]))
    settle(["cold"])
    engine.add_request(req("warm", suffixes[1], priority=2))
    # a deadline that lapses before the next boundary
    engine._admit(req("late", suffixes[2], deadline=1e-4))
    time.sleep(0.01)
    engine.step()
    assert reqs["late"].status == "deadline_exceeded"
    # two low-priority prompts fill the batch; a higher-priority one
    # evicts the least progressed (requeued, retried later)
    engine._admit(req("low0", suffixes[3]))
    engine._admit(req("low1", suffixes[4]))
    engine._admit(req("high", suffixes[5], priority=2))
    assert reqs["low0"].status == "requeued"
    # an equal-priority prompt against a full batch is shed
    with pytest.raises(MemoryError):
        engine._admit(req("shed", suffixes[6]))
    engine.step()
    engine.cancel(reqs["low1"])
    settle(["warm", "high", "low0"])
    return {n: (r.status, list(r.output_ids)) for n, r in reqs.items()}


@pytest.fixture(scope="module")
def shared_run(fitted, tmp_path_factory):
    """The shared workload on the reference engine, then on the port's,
    each on a cleared registry with its own shape registry; returns each
    side's outcome, counts, spec stats and recipe."""
    d = tmp_path_factory.mktemp("shapes")
    mp = pytest.MonkeyPatch()
    jm, tm = _models(fitted)
    runs = {}
    try:
        for name, mod, cw, reg, model, kw in (
                ("reference", jax_serving, jax_cw, jax_om.default_registry(),
                 jm, {"fused_kv": False}),
                ("port", serving, ocw, om.default_registry(), tm, {})):
            mp.setenv("PADDLE_TPU_SHAPE_REGISTRY", str(d / f"{name}.json"))
            mp.setattr(cw, "_shape_registry", None)
            reg.clear()
            e = mod.LlamaServingEngine(model, spec_k=2, sampling=False,
                                       **kw, **GEOM)
            outcome = _workload(e, mod)
            runs[name] = dict(outcome=outcome, counts=_counts(reg),
                              spec=e.spec_stats(), names={
                                  m.name for m in reg.collect()},
                              recipe=cw.shape_registry().lookup(
                                  e._shape_key)
                              if e._cache_dir is not None else None,
                              warm=e._warm_dispatches,
                              free=e.alloc.free_pages
                              + (e.prefix.pages if e.prefix else 0))
            e.close()
            reg.clear()
    finally:
        mp.undo()
    return runs


def test_shared_workload_runs_alike(shared_run):
    ref, port = shared_run["reference"], shared_run["port"]
    assert port["outcome"] == ref["outcome"]
    statuses = {n: s for n, (s, _) in port["outcome"].items()}
    assert statuses == {"cold": "completed", "warm": "completed",
                        "late": "deadline_exceeded", "low0": "completed",
                        "low1": "cancelled", "high": "completed",
                        "shed": "pending"}
    assert port["spec"] == ref["spec"] and port["spec"]["proposed"] > 0
    assert port["warm"] == ref["warm"] > 0
    assert port["free"] == ref["free"] == GEOM["num_pages"] - 1


def test_counters_and_histogram_counts_equal_reference(shared_run):
    """Every compared counter's value and histogram's count is the
    reference engine's (time histograms' sums and buckets exempt)."""
    ref, port = shared_run["reference"]["counts"], \
        shared_run["port"]["counts"]
    assert port == ref
    want = {("serving_requests_admitted_total", ()): 7.0,
            ("serving_requests_completed_total", ()): 4.0,
            ("serving_requests_evicted_total", ()): 1.0,
            ("serving_deadline_exceeded_total", ()): 1.0,
            ("serving_cancelled_total", ()): 1.0,
            ("serving_degraded_total", ("evict",)): 1.0,
            ("serving_degraded_total", ("shed",)): 1.0,
            ("serving_prefix_cache_lookup_total", ()): 7.0,
            ("serving_ttft_seconds", ()): 5.0}
    for key, value in want.items():
        assert port[key] == value, key
    outcome = shared_run["port"]["outcome"]
    assert port[("serving_generated_tokens_total", ())] \
        == sum(len(o) for _, o in outcome.values())
    assert port[("serving_prefix_cache_hit_total", ())] >= 5
    assert port[("serving_spec_proposed_tokens_total", ())] \
        == shared_run["port"]["spec"]["proposed"]
    assert port[("serving_token_latency_seconds", ())] > 0


def test_shape_recipes_equal_reference(shared_run):
    ref, port = shared_run["reference"]["recipe"], \
        shared_run["port"]["recipe"]
    assert port == ref and port["mixed"] and port["scan"]


def test_registered_names_are_the_reference_s(shared_run):
    """Every metric name the port registers is one the reference
    registers: the port's registry after the workload, and a static scan
    of the port's sources with the docs check's own pattern."""
    sys.path.insert(0, str(ROOT / "tools"))
    import check_metrics_docs as cmd
    registered = set(cmd.registered_metrics())
    assert shared_run["port"]["names"] <= registered
    static = set()
    for path in (ROOT / "paddle_tpu_torch").rglob("*.py"):
        static |= set(cmd._REG_RE.findall(path.read_text()))
    assert static and static <= registered, sorted(static - registered)
    assert {"serving_ttft_seconds", "kv_page_cow_total",
            "watchdog_timeouts_total", "paddle_tpu_xla_compile_total",
            "paddle_tpu_perf_device_ms"} <= static


def test_metric_set_is_the_reference_s():
    mine, ref = serving._serving_metrics(), jax_serving._serving_metrics()
    assert set(mine) == set(ref)
    for key in ref:
        a, b = mine[key], ref[key]
        assert (a.name, a.kind, a.help, a.labelnames) \
            == (b.name, b.kind, b.help, b.labelnames), key
        assert getattr(a, "buckets", None) == getattr(b, "buckets", None)
    assert serving._LATENCY_BUCKETS == jax_serving._LATENCY_BUCKETS
    jax_om.default_registry().clear()


# ---------------------------------------------------------------------------
# the port's engine alone
# ---------------------------------------------------------------------------
def _engine(model, **kw):
    return LlamaServingEngine(model, **{**GEOM, "num_pages": 64, **kw})


def test_generate_populates_registry(port_model):
    e = _engine(port_model)
    out = e.generate(_prompts(0, (5, 9, 3)), max_new_tokens=5)
    reg = om.default_registry()
    assert reg.get("serving_requests_completed_total").value == 3
    assert reg.get("serving_requests_admitted_total").value == 3
    ttft = reg.get("serving_ttft_seconds")
    assert ttft.count == 3 and ttft.sum > 0
    assert reg.get("serving_generated_tokens_total").value \
        == sum(len(o) for o in out)
    e.generate(_prompts(0, (5, 9, 3)), max_new_tokens=5)
    assert reg.get("serving_token_latency_seconds").count > 0
    e.prefix.clear()
    e._set_pool_gauges()
    assert reg.get("serving_kv_page_utilization").value == 0.0
    assert reg.get("serving_queue_depth").value == 0.0
    assert reg.get("kv_page_bytes_per_token").value \
        == e.kv_bytes_per_token
    assert reg.get("serving_weight_bytes_per_param").value == 4.0
    assert reg.get("paddle_tpu_live_array_bytes").value > 0
    assert "serving.mixed_step" in {ev["name"]
                                    for ev in otrace.get_events()}
    e.close()


def test_utilization_nonzero_while_live(port_model):
    e = _engine(port_model, max_batch=2, num_pages=16)
    e.add_request(Request([1, 2, 3], max_new_tokens=4))
    reg = om.default_registry()
    assert reg.get("serving_kv_page_utilization").value > 0
    assert reg.get("serving_queue_depth").value == 1
    while e.step():
        pass
    assert reg.get("serving_kv_page_utilization").value == 0.0
    e.close()


def test_tpot_not_cold_inflated(port_model):
    """With metrics on, a cold shape's first use runs in a warm-up
    dispatch before the timed one, so the first real decode step is
    warm and observed, and the warm-up's time is moved out of the
    request's TTFT and deadline clocks."""
    e = _engine(port_model, max_batch=2, num_pages=16, decode_ticks=1)
    r = Request([1, 2, 3], max_new_tokens=4, deadline=600.0)
    admitted = time.perf_counter()
    e.add_request(r)
    assert e._warm_dispatches == 1
    assert r._expires_at > admitted + 600.0
    reg = om.default_registry()
    c0 = reg.get("serving_token_latency_seconds").count
    e.step()                # the decode-only shape: warmed, then observed
    assert e._warm_dispatches == 2
    assert reg.get("serving_token_latency_seconds").count == c0 + 1
    e.step()
    assert reg.get("serving_token_latency_seconds").count == c0 + 2
    e.close()


def test_shed_and_constraint_counters(port_model):
    e = _engine(port_model, max_batch=1, num_pages=16, sampling=True)
    e.add_request(Request([1, 2, 3], max_new_tokens=64))
    with pytest.raises(MemoryError):
        e._admit(Request([4, 5], max_new_tokens=4))
    reg = om.default_registry()
    assert reg.get("serving_requests_evicted_total").value == 1
    assert reg.get("serving_degraded_total").labels("shed").value == 1
    e.close()

    def raising(prompt, out):
        raise RuntimeError("hook failed")
    for hook, key in ((raising, "serving_constraint_errors_total"),
                      (lambda p, o: [], "serving_constraint_errors_total"),
                      (lambda p, o: list(range(20)),
                       "serving_constraint_truncated_total")):
        om.default_registry().clear()
        e = _engine(port_model, sampling=True)
        r = Request([1, 2, 3], max_new_tokens=1,
                    sampling=SamplingParams(constraint=hook))
        e.add_request(r)
        assert r.done
        assert om.default_registry().get(key).value == 1
        e.close()


def test_stop_token_hit_counted(port_model):
    e = _engine(port_model)
    want = e.generate([[7, 8, 9]], max_new_tokens=6)[0]
    # the first token not emitted before it
    i = next(i for i in range(1, 6) if want[i] not in want[:i])
    om.default_registry().clear()
    e = _engine(port_model)
    r = Request([7, 8, 9], max_new_tokens=6, stop=(want[i],))
    e.generate([r])
    reg = om.default_registry()
    assert r.output_ids == want[:i]
    assert reg.get("serving_stop_token_hits_total").value == 1
    assert reg.get("serving_requests_completed_total").value == 1
    e.close()


def test_disabled_is_byte_identical_and_unregistered(port_model,
                                                     monkeypatch):
    prompts = _prompts(3, (13, 6, 21), block=3)
    e = _engine(port_model, spec_k=2)
    want = e.generate(prompts, max_new_tokens=9)
    assert e._warm_dispatches > 0
    monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
    om.default_registry().clear()
    otrace.clear()
    e2 = _engine(port_model, spec_k=2)
    assert e2.generate(prompts, max_new_tokens=9) == want
    assert om.default_registry().collect() == []
    assert otrace.get_events() == []
    assert e2._warm_dispatches == 0
    e.close()
    e2.close()


@pytest.mark.parametrize("path", [{}, {"fused_rope": False},
                                  {"fused_kv": False},
                                  {"kv_dtype": "int8"}])
def test_warm_up_leaves_every_page_as_it_was(port_model, path):
    """A cold-shape warm-up in the middle of serving: every page, and
    every scale, bitwise unchanged (the trash page the two-op scatter
    writes is put back), the cached prefix pages and a paused request's
    host copy included."""
    e = _engine(port_model, kv_tier=True, **path)
    prefix = _prompts(4, (16,))[0]
    e.generate([prefix + [1, 2, 3]], max_new_tokens=3)     # cached pages
    assert e.prefix.pages > 0
    parked = Request(prefix + [5, 6], max_new_tokens=8)
    e.add_request(parked)
    with e._lock:
        e._pause(parked)
    assert parked.status == "paused"
    host = e.tier.stats()["bytes"]
    pools = e.k_pools + e.v_pools + e.k_scales + e.v_scales
    before = [t.clone() for t in pools]
    e._warmed_keys.clear()
    for t_cap in (e.chunk_budget, e.max_batch):
        assert e._warm_mixed(t_cap)
    for b, a in zip(before, pools):
        assert torch.equal(b, a)
    assert e.tier.stats()["bytes"] == host
    e.close()


def test_mixed_hbm_bytes_fused_below_unfused(port_model):
    """The gauge's property: the fused KV write moves strictly fewer bytes
    than the two-op path's scatter, and the rope-fused call fewer than
    the separate rope op."""
    got = {}
    for name, kw in (("rope-fused", {}), ("fused-kv", {"fused_rope": False}),
                     ("two-op", {"fused_kv": False})):
        om.default_registry().clear()
        e = _engine(port_model, **kw)
        e.add_request(Request([1, 2, 3, 4], max_new_tokens=2))
        got[name] = om.default_registry().get(
            "serving_mixed_hbm_bytes").value
        assert got[name] == e._mixed_bytes[e.chunk_budget] > 0
        e.close()
    assert got["rope-fused"] < got["fused-kv"] < got["two-op"]


def test_spans_count_dispatches_and_first_tokens(port_model, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PERF_FENCE_INTERVAL", "0")
    perf.reset()
    e = _engine(port_model)
    counts = {"mixed": 0, "scan": 0}
    dispatch, scan = e._dispatch_rows, e._decode_scan

    def counted_dispatch(rows, cow=()):
        counts["mixed"] += 1
        return dispatch(rows, cow)

    def counted_scan(n):
        out = scan(n)
        counts["scan"] += bool(out)
        return out
    e._dispatch_rows, e._decode_scan = counted_dispatch, counted_scan
    reqs = [Request(p, max_new_tokens=9) for p in _prompts(5, (7, 12, 4))]
    for r in reqs:
        r._trace = otracing.mint()
    e.generate(reqs)
    names = [ev["name"] for ev in otrace.get_events()]
    assert names.count("serving.mixed_step") == counts["mixed"] > 0
    assert names.count("serving.decode_scan") == counts["scan"] > 0
    firsts = [ev for ev in otrace.get_events()
              if ev["name"] == "serving.first_token"]
    assert sorted(ev["args"]["trace_id"] for ev in firsts) \
        == sorted(r._trace.trace_id for r in reqs)
    rec = perf.recorders()
    assert rec["serving.mixed_step"]["samples"] == counts["mixed"]
    assert sum(s["samples"] for n, s in rec.items()
               if n.startswith("serving.mixed_scan[")) == counts["scan"]
    assert rec["serving.mixed_step"]["flops"] > 0
    perf.reset()
    e.close()


@pytest.mark.parametrize("ticks", [None, 1])
def test_generated_tokens_graphed_and_single(port_model, ticks):
    e = _engine(port_model, decode_ticks=ticks)
    out = e.generate(_prompts(6, (9, 17, 5)), max_new_tokens=11)
    assert om.default_registry().get(
        "serving_generated_tokens_total").value == sum(map(len, out)) == 33
    e.close()


def test_fatal_path_dumps_once(port_model, tmp_path):
    ofr.install(log_dir=str(tmp_path))
    e = _engine(port_model)
    e.add_request(Request([1, 2, 3], max_new_tokens=4))

    def explode(*a, **k):
        raise RuntimeError("decode died")
    e._mixed_forward = explode
    with pytest.raises(RuntimeError, match="decode died"):
        e.step()
    root = tmp_path / "postmortem"
    (bundle,) = list(root.iterdir())
    doc = json.loads((bundle / "env.json").read_text())
    assert doc["reason"] == "serving.step"
    assert "memory_stats" in doc
    assert "decode died" in (bundle / "error.txt").read_text()
    e.close()
    # an admission shed is routine (no post-mortem); a device out of
    # memory is a RuntimeError and dumps
    def shed():
        raise AdmissionError("engine full", 1, 1, 0, 8)

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(AdmissionError):
        serving._fatal_guard("serving.generate")(shed)()
    assert len(list(root.iterdir())) == 1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        serving._fatal_guard("serving.drain")(oom)()
    assert len(list(root.iterdir())) == 2


def test_stalled_dispatch_counts_one_timeout(port_model, tmp_path):
    ofr.install(log_dir=str(tmp_path))
    e = _engine(port_model, stuck_min_timeout=0.05, decode_ticks=1)
    e.add_request(Request([1, 2, 3], max_new_tokens=8))
    e.step()
    e._dispatch_times.extend([0.001] * 16)
    forward = e._mixed_forward

    def stalled(*a, **k):
        time.sleep(2.5)     # well past the watchdog's 1 s poll
        return forward(*a, **k)
    e._mixed_forward = stalled
    e.step()
    reg = om.default_registry()
    assert reg.get("watchdog_timeouts_total") \
        .labels("serving.decode").value == 1
    doc = json.loads(next((tmp_path / "postmortem").iterdir())
                     .joinpath("env.json").read_text())
    assert doc["reason"] == "watchdog_timeout:serving.decode"
    e.close()


def test_restarted_engine_prewarms_recorded_shapes(port_model, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SHAPE_REGISTRY",
                       str(tmp_path / "shapes.json"))
    monkeypatch.setattr(ocw, "_shape_registry", None)
    e = _engine(port_model)
    e.generate(_prompts(7, (11, 20)), max_new_tokens=9)
    seen = sorted(k[1] for k in e._warmed_keys if k[0] == "mixed"), \
        sorted(k[1] for k in e._warmed_keys if k[0] == "scan")
    e.close()
    restarted = _engine(port_model)
    done = restarted.prewarm()
    assert (done["mixed"], done["scan"]) == seen
    assert done["mixed"] and done["scan"]
    assert restarted._warm_dispatches == len(done["mixed"]) \
        + len(done["scan"])
    names = [ev["name"] for ev in otrace.get_events()]
    assert names.count("serving.prewarm") == 1
    # another geometry records under another key: nothing to warm
    assert _engine(port_model, max_batch=2).prewarm() \
        == {"mixed": [], "scan": []}
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "0")
    assert _engine(port_model).prewarm() == {"mixed": [], "scan": []}
    restarted.close()


def test_docs_name_the_port_s_families():
    """README's port section lists the families the port registers and
    what the compile watcher's count on the card."""
    readme = (ROOT / "README.md").read_text()
    section = readme[readme.index("## PyTorch/CUDA port"):]
    nxt = section.find("\n## ", 1)
    section = section if nxt < 0 else section[:nxt]
    sys.path.insert(0, str(ROOT / "tools"))
    import check_metrics_docs as cmd
    exact, prefixes = cmd.documented_names(section)
    static = set()
    for path in (ROOT / "paddle_tpu_torch").rglob("*.py"):
        static |= set(cmd._REG_RE.findall(path.read_text()))
    missing = [n for n in sorted(static) if n not in exact
               and not any(n.startswith(p) for p in prefixes)]
    assert static and not missing, missing
