"""The port's request lifecycle against the reference (mirrors
``tests/test_serving_lifecycle.py``): request validation, idempotent
release, cancel (concurrent admission never overshooting ``max_batch``,
the deferred release), deadlines, the degradation ladder (the
fault-driven rung order included), drain and readiness, the stuck-dispatch
watchdog, and the fault plans of ``testing/faults.py``.

Every case runs on both packages' engines (``pkg``), which must behave
alike; the lockstep cases hold the host state of both equal (statuses,
errors' fields, requeue order, the allocator). The engines' lifecycle
counters are held equal in ``tests/test_torch_metrics_parity.py``. Phase 14b of
``chip_smoke.py`` (retirement under a shed, a deadline, two cancels)
runs here at tiny width on both engines and must give the statuses the
card is held to.
"""

import json
import logging
import pathlib
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import watchdog as jax_watchdog
from paddle_tpu.inference import paged_cache as jax_paged
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.inference import paged_cache, serving
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)
from paddle_tpu_torch.testing import faults

ROOT = pathlib.Path(__file__).resolve().parent.parent


class Pkg:
    """One package's serving classes and a tiny model of its own."""

    def __init__(self, name, serving_mod, paged_mod, faults_mod, wd_mod,
                 model):
        self.name = name
        self.Engine = serving_mod.LlamaServingEngine
        self.Request = serving_mod.Request
        self.AdmissionError = serving_mod.AdmissionError
        self.DeadlineExceeded = serving_mod.DeadlineExceeded
        self.PageAllocator = paged_mod.PageAllocator
        self.faults = faults_mod
        self.StepWatchdog = wd_mod.StepWatchdog
        self.model = model

    def engine(self, **kw):
        extra = {"fused_kv": False} if self.name == "reference" else {}
        return self.Engine(self.model, **extra, **kw)


@pytest.fixture(scope="module")
def packages():
    paddle.seed(0)
    # positions up to phase 4's longest prompt plus its new tokens
    jm = JaxLlama(jax_tiny(max_position_embeddings=1024))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = load_numpy_state(LlamaForCausalLM(
        tiny_llama_config(max_position_embeddings=1024), device="cpu"),
        arrays).eval()
    return {"reference": Pkg("reference", jax_serving, jax_paged, jax_faults,
                             jax_watchdog, jm),
            "port": Pkg("port", serving, paged_cache, faults, watchdog, tm)}


@pytest.fixture(params=["reference", "port"])
def pkg(request, packages):
    return packages[request.param]


@pytest.fixture()
def engine(pkg):
    e = pkg.engine(max_batch=2, page_size=8, num_pages=16)
    yield e
    e.close()


# ---------------------------------------------------------------------
# Request validation
# ---------------------------------------------------------------------
class TestRequestValidation:
    def test_empty_prompt(self, pkg):
        with pytest.raises(ValueError, match="prompt_ids is empty"):
            pkg.Request([])

    def test_nonpositive_max_new_tokens(self, pkg):
        with pytest.raises(ValueError, match="max_new_tokens"):
            pkg.Request([1], max_new_tokens=0)
        with pytest.raises(ValueError, match="max_new_tokens"):
            pkg.Request([1], max_new_tokens=-3)

    def test_bad_budgets(self, pkg):
        with pytest.raises(ValueError, match="deadline"):
            pkg.Request([1], deadline=0)
        with pytest.raises(ValueError, match="token_budget"):
            pkg.Request([1], token_budget=-1.0)
        with pytest.raises(ValueError, match="retry_budget"):
            pkg.Request([1], retry_budget=-1)

    def test_prompt_beyond_pool_capacity_names_limit(self, pkg, engine):
        cap = engine.alloc.num_pages * engine.page_size
        with pytest.raises(ValueError) as ei:
            engine._admit(pkg.Request(list(range(cap + 1)),
                                      max_new_tokens=4))
        assert str(cap) in str(ei.value)
        assert "KV capacity" in str(ei.value)

    def test_validation_beats_opaque_shape_error(self, pkg, engine):
        cap = engine.alloc.num_pages * engine.page_size
        with pytest.raises(ValueError, match="KV capacity"):
            engine.add_request(pkg.Request(list(range(cap + 50))))


# ---------------------------------------------------------------------
# PageAllocator idempotent release
# ---------------------------------------------------------------------
class TestIdempotentRelease:
    def test_double_release_is_noop_with_counter(self, pkg):
        alloc = pkg.PageAllocator(8, 4)
        alloc.admit(0, 6)           # 2 pages
        free_after_admit = alloc.free_pages
        alloc.release(0)
        assert alloc.free_pages == free_after_admit + 2
        with pytest.warns(RuntimeWarning, match="already-released"):
            alloc.release(0)
        assert alloc.free_pages == free_after_admit + 2
        assert alloc.double_free_count == 1
        assert len(alloc._free) == len(set(alloc._free)) == 8

    def test_release_unknown_sequence(self, pkg):
        alloc = pkg.PageAllocator(4, 4)
        with pytest.warns(RuntimeWarning):
            alloc.release(99)
        assert alloc.double_free_count == 1
        assert alloc.free_pages == 4

    def test_readmit_after_release_stays_consistent(self, pkg):
        alloc = pkg.PageAllocator(4, 4)
        alloc.admit(0, 4)
        alloc.release(0)
        with pytest.warns(RuntimeWarning):
            alloc.release(0)
        alloc.admit(1, 16)
        assert alloc.free_pages == 0
        alloc.release(1)
        assert alloc.free_pages == 4


# ---------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------
class TestCancel:
    def test_cancel_releases_pages_and_is_idempotent(self, pkg, engine):
        free0 = engine.alloc.free_pages
        r = pkg.Request([1, 2, 3], max_new_tokens=8)
        engine._admit(r)
        assert engine.alloc.free_pages < free0
        assert engine.cancel(r) is True
        assert r.done and r.status == "cancelled"
        assert engine.alloc.free_pages == free0
        assert r.seq_id not in engine._live
        assert engine.cancel(r) is False
        assert engine.cancel(r.seq_id) is False

    def test_cancel_unknown_request(self, engine):
        assert engine.cancel(12345) is False

    def test_cancel_pending_and_requeued_requests(self, pkg):
        """A never-admitted request is terminal at once; a request parked
        on the requeue is removed, never pumped back in."""
        e = pkg.engine(max_batch=2, page_size=8, num_pages=16)
        pending = pkg.Request([4, 5], max_new_tokens=3)
        assert e.cancel(pending) is True and pending.status == "cancelled"
        r = pkg.Request([1, 2], max_new_tokens=8, priority=0, retry_budget=1)
        e._admit(r)
        with e._lock:
            e._evict(r)                     # -> requeue, seq_id None
        assert r in e._requeue and r.status == "requeued"
        assert e.cancel(r) is True
        assert r.done and r.status == "cancelled"
        assert r not in e._requeue
        assert e.cancel(r) is False
        e.close()

    def test_cancel_popped_mid_readmission_is_honored(self, pkg):
        """A request the requeue pump popped (neither live nor parked) is
        flagged; its re-admission honors the flag."""
        e = pkg.engine(max_batch=2, page_size=8, num_pages=16)
        r = pkg.Request([1, 2], max_new_tokens=8, retry_budget=1)
        e._admit(r)
        with e._lock:
            e._evict(r)
            e._requeue.remove(r)            # as the pump pops it
        assert e.cancel(r) is True and not r.done
        e._admit(r)
        assert r.done and r.status == "cancelled" and not e._live
        e.close()

    def test_concurrent_admission_never_overshoots_max_batch(self, pkg):
        e = pkg.engine(max_batch=4, page_size=8, num_pages=64)
        admitted, shed = [], []

        def admitter(i):
            try:
                e._admit(pkg.Request([i + 1], max_new_tokens=8))
                admitted.append(i)
            except pkg.AdmissionError:
                shed.append(i)

        ts = [threading.Thread(target=admitter, args=(i,))
              for i in range(32)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)     # interleave the admitters finely
        try:
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in ts)
        assert len(e._live) == 4
        assert len(admitted) == 4 and len(shed) == 28
        e.close()

    def test_cancel_keeps_partial_output(self, pkg, engine):
        r = pkg.Request([1, 2], max_new_tokens=8)
        engine._admit(r)
        r.output_ids = [7, 8]
        engine.cancel(r)
        assert r.output_ids == [7, 8]
        assert r.error is None

    def test_cancel_during_dispatch_defers_page_release(self, pkg, engine):
        free0 = engine.alloc.free_pages
        r = pkg.Request([1, 2, 3], max_new_tokens=8)
        engine._admit(r)
        with engine._lock:
            engine._in_dispatch = True
        try:
            engine.cancel(r)
            assert r.done and r.status == "cancelled"
            assert engine.alloc.free_pages < free0
            assert engine._deferred_release == [r.seq_id]
        finally:
            with engine._lock:
                engine._in_dispatch = False
        engine._flush_deferred()
        assert engine.alloc.free_pages == free0

    def test_cancel_from_another_thread_mid_entry_defers(self, pkg, engine):
        """While another thread is inside an engine entry, a release is
        deferred to that entry's end."""
        free0 = engine.alloc.free_pages
        r = pkg.Request([1, 2, 3], max_new_tokens=8)
        engine._admit(r)
        with engine._entry():
            t = threading.Thread(target=engine.cancel, args=(r,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and r.status == "cancelled"
            assert engine.alloc.free_pages < free0
        assert engine.alloc.free_pages == free0


# ---------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------
class TestDeadlines:
    def test_expiry_releases_pages_and_types_result(self, pkg, engine):
        free0 = engine.alloc.free_pages
        r = pkg.Request([1, 2, 3], max_new_tokens=8, deadline=60.0)
        engine._admit(r)
        assert r._expires_at is not None
        r.output_ids = [4]
        r._expires_at = time.perf_counter() - 0.01
        engine._expire_deadlines()
        assert r.done and r.status == "deadline_exceeded"
        assert isinstance(r.error, pkg.DeadlineExceeded)
        assert r.error.tokens_emitted == 1 and r.error.reason == "deadline"
        assert r.output_ids == [4]
        assert engine.alloc.free_pages == free0

    def test_token_budget_sets_tighter_deadline(self, pkg, engine):
        r = pkg.Request([1], max_new_tokens=10, deadline=100.0,
                        token_budget=0.5)
        engine._admit(r)
        assert r._expires_at - r._t_admit == pytest.approx(5.0, abs=0.1)

    def test_next_admission_reuses_expired_pages(self, pkg, engine):
        big = pkg.Request(list(range(100)), max_new_tokens=4, deadline=50.0)
        engine._admit(big)
        assert engine.alloc.free_pages < 3
        big._expires_at = time.perf_counter() - 0.01
        nxt = pkg.Request(list(range(40)), max_new_tokens=4)
        engine._admit(nxt)
        assert big.status == "deadline_exceeded"
        assert nxt.seq_id in engine._live

    def test_deadline_exceeded_pickles_its_fields(self, pkg):
        import pickle
        e = pkg.DeadlineExceeded("late", seq_id=3, elapsed=1.5,
                                 tokens_emitted=2, reason="drain")
        back = pickle.loads(pickle.dumps(e))
        assert (back.args[0], back.seq_id, back.elapsed,
                back.tokens_emitted, back.reason) == ("late", 3, 1.5, 2,
                                                      "drain")


# ---------------------------------------------------------------------
# degradation ladder: trim -> evict -> shed
# ---------------------------------------------------------------------
class TestDegradationLadder:
    def test_trim_retires_lowest_priority_with_partial_output(self, pkg):
        e = pkg.engine(max_batch=2, page_size=8, num_pages=16)
        lo1 = pkg.Request([1, 2], max_new_tokens=16, priority=0)
        lo2 = pkg.Request([3, 4], max_new_tokens=16, priority=0)
        e._admit(lo1)
        e._admit(lo2)
        lo1.output_ids = [9, 9, 9]
        lo2.output_ids = [9]
        hi = pkg.Request([5, 6], max_new_tokens=4, priority=1)
        e._admit(hi)
        assert lo2.done and lo2.status == "completed" and lo2.trimmed
        assert lo2.max_new_tokens == 1 and lo2.output_ids == [9]
        assert not lo1.done
        assert hi.seq_id in e._live
        e.close()

    def test_evict_requeues_with_retry_budget(self, pkg):
        e = pkg.engine(max_batch=2, page_size=8, num_pages=16)
        lo1 = pkg.Request([1, 2], max_new_tokens=16, retry_budget=1)
        lo2 = pkg.Request([3, 4], max_new_tokens=16, retry_budget=1)
        e._admit(lo1)
        e._admit(lo2)
        hi = pkg.Request([5, 6], max_new_tokens=4, priority=1)
        e._admit(hi)
        requeued = [r for r in (lo1, lo2) if r.status == "requeued"]
        assert len(requeued) == 1
        v = requeued[0]
        assert not v.done and v.retry_budget == 0
        assert v.output_ids == [] and v.seq_id is None
        assert v in e._requeue
        assert hi.seq_id in e._live
        e.close()

    def test_evict_without_budget_fails_typed(self, pkg):
        e = pkg.engine(max_batch=1, page_size=8, num_pages=16)
        lo = pkg.Request([1, 2], max_new_tokens=16, retry_budget=0)
        e._admit(lo)
        e._admit(pkg.Request([3], max_new_tokens=4, priority=1))
        assert lo.done and lo.status == "evicted"
        assert isinstance(lo.error, pkg.AdmissionError)
        assert lo not in e._requeue
        e.close()

    def test_shed_carries_retry_after(self, pkg):
        e = pkg.engine(max_batch=1, page_size=8, num_pages=16)
        e._admit(pkg.Request([1, 2], max_new_tokens=16, priority=5))
        with pytest.raises(pkg.AdmissionError) as ei:
            e._admit(pkg.Request([3], max_new_tokens=4, priority=5))
        assert ei.value.reason == "engine full"
        assert ei.value.retry_after is not None and ei.value.retry_after > 0
        e.close()

    def test_backoff_retries_before_the_shed(self, pkg):
        e = pkg.engine(max_batch=1, page_size=8, num_pages=16,
                       admit_retries=2, admit_backoff=0.001)
        e._admit(pkg.Request([1, 2], max_new_tokens=16))
        t0 = time.perf_counter()
        with pytest.raises(pkg.AdmissionError) as ei:
            e._admit(pkg.Request([3], max_new_tokens=4))
        assert ei.value.retries == 2
        assert time.perf_counter() - t0 >= 0.003      # 1 ms + 2 ms
        e.close()

    def test_decode_boundary_pressure_evicts_instead_of_crashing(self, pkg):
        e = pkg.engine(max_batch=2, page_size=8, num_pages=3)
        r1 = pkg.Request(list(range(8)), max_new_tokens=50)
        r2 = pkg.Request(list(range(8)), max_new_tokens=50)
        e._admit(r1)
        e._admit(r2)
        r1.output_ids = [1, 2]      # r2 is least progressed -> victim
        assert e.alloc.free_pages == 0
        with e._lock:
            survivors = e._relieve_pressure([r1, r2], 1)
        assert survivors == [r1]
        assert r2.status == "requeued" and r2 in e._requeue
        assert e.alloc.free_pages == 1
        e.close()

    def test_pressure_postpones_while_another_thread_is_in_entry(self, pkg):
        """Releases would be deferred, so evicting frees no page: every
        row that does not fit sits the dispatch out with no state
        change (here both, since postponing frees nothing either)."""
        e = pkg.engine(max_batch=2, page_size=8, num_pages=3,
                       prefix_cache=False)
        r1 = pkg.Request(list(range(8)), max_new_tokens=50)
        r2 = pkg.Request(list(range(8)), max_new_tokens=50)
        e._admit(r1)
        e._admit(r2)
        r1.output_ids = [1, 2]
        other = threading.Thread(target=lambda: None)
        with e._lock:
            e._entry_threads[other] = 1
            try:
                survivors = e._relieve_pressure([r1, r2], 1)
            finally:
                e._entry_threads.pop(other)
        assert survivors == [] and r1.status == r2.status == "live"
        assert not e._requeue and e.alloc.free_pages == 0
        e.close()

    def test_ladder_order_under_fault_driven_pressure(self, pkg,
                                                      monkeypatch):
        """A fault plan injects MemoryError at serve.admit (the
        pool-exhausted signal): the ladder walks trim -> evict -> shed."""
        plan = [{"point": "serve.admit", "action": "raise",
                 "exc": "MemoryError", "count": 6}]
        e = pkg.engine(max_batch=8, page_size=8, num_pages=64)
        lo1 = pkg.Request([1, 2], max_new_tokens=16, priority=0)
        lo2 = pkg.Request([3, 4], max_new_tokens=16, priority=0)
        monkeypatch.delenv(pkg.faults.PLAN_ENV, raising=False)
        pkg.faults.reset()
        e._admit(lo1)
        e._admit(lo2)
        lo1.output_ids = [9, 9]
        monkeypatch.setenv(pkg.faults.PLAN_ENV, json.dumps(plan))
        pkg.faults.reset()
        try:
            with pytest.raises(pkg.AdmissionError) as ei:
                e._admit(pkg.Request([5, 6], max_new_tokens=4, priority=1))
            assert ei.value.reason == "KV page pool exhausted"
            assert lo1.done and lo1.status == "completed" and lo1.trimmed
            assert lo2.status == "requeued"
        finally:
            pkg.faults.reset()
        e.close()


def _ladder_trace(p, e):
    """A ladder workload with host-visible outcomes only: returns what
    the two packages must agree on."""
    out = []
    reqs = [p.Request([i + 1, i + 2], max_new_tokens=16, priority=i % 3,
                      retry_budget=i % 2) for i in range(6)]
    for i, r in enumerate(reqs):
        if i < 4:
            r.output_ids = []
        try:
            e._admit(r)
            out.append(("admitted", i, r.seq_id))
        except MemoryError as err:
            out.append(("shed", i, err.reason, err.live, err.max_batch,
                        err.free_pages, err.num_pages, err.retries,
                        err.retry_after))
        if i == 1:
            reqs[0].output_ids = [7]
        out.append([(x.status, x.trimmed, x.seq_id, x.retry_budget,
                     type(x.error).__name__ if x.error else None)
                    for x in reqs])
        out.append([reqs.index(x) for x in e._requeue])
        out.append((e.alloc.free_pages, sorted(e.alloc._tables)))
    return out


def test_ladder_matches_reference_in_lockstep(packages):
    """The same admissions of mixed priorities and retry budgets into a
    full engine: every status, trim, eviction, requeue order, seq id and
    shed error's fields equal between the packages."""
    traces = []
    for name in ("reference", "port"):
        p = packages[name]
        e = p.engine(max_batch=3, page_size=8, num_pages=16)
        traces.append(_ladder_trace(p, e))
        e.close()
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------
# drain, readiness
# ---------------------------------------------------------------------
class TestDrain:
    def test_drain_empty_engine(self, pkg, engine):
        stats = engine.drain(timeout=1.0)
        assert stats["completed"] == 0 and stats["expired"] == 0
        assert not engine.is_ready()
        with pytest.raises(pkg.AdmissionError) as ei:
            engine._admit(pkg.Request([1], max_new_tokens=2))
        assert ei.value.reason == "draining"
        engine.resume_admission()
        assert engine.is_ready()
        engine._admit(pkg.Request([1], max_new_tokens=2))

    def test_drain_expires_stragglers_at_grace(self, pkg, engine):
        free0 = engine.alloc.free_pages
        r = pkg.Request([1, 2, 3], max_new_tokens=8)
        engine._admit(r)
        r.output_ids = [5]
        stats = engine.drain(timeout=0.0)
        assert r.done and r.status == "deadline_exceeded"
        assert isinstance(r.error, pkg.DeadlineExceeded)
        assert r.error.reason == "drain grace window"
        assert engine.alloc.free_pages == free0
        assert stats["expired"] == 1 and stats["completed"] == 0

    def test_drain_counts_expired_deadline_as_drained(self, pkg, engine):
        r = pkg.Request([1, 2], max_new_tokens=8, deadline=30.0)
        engine._admit(r)
        r._expires_at = time.perf_counter() - 0.01
        stats = engine.drain(timeout=5.0)
        assert r.status == "deadline_exceeded"
        assert stats["expired"] == 1

    def test_drain_expires_requeued_requests(self, pkg, engine):
        r = pkg.Request([1, 2], max_new_tokens=8, retry_budget=1)
        engine._admit(r)
        with engine._lock:
            engine._evict(r)
        engine.drain(timeout=0.0)
        assert r.status == "deadline_exceeded" and not engine._requeue

    def test_readiness_and_backlog(self, pkg, engine):
        assert engine.is_ready() and engine.prefill_backlog() == 0
        engine._admit(pkg.Request(list(range(20)), max_new_tokens=4))
        engine._admit(pkg.Request(list(range(7)), max_new_tokens=4))
        assert engine.prefill_backlog() == 27
        engine.close()
        assert not engine.is_ready()

    def test_sigterm_mid_entry_defers_the_drain(self, pkg, engine):
        """A preemption signal landing inside an entry closes admission
        and records the drain for the entry's boundary (the handler is
        called directly; the record is cleared before the boundary so
        the test process does not exit)."""
        prev = engine.install_drain_handler(grace=1.0,
                                            signals=(signal.SIGUSR1,))
        try:
            handler = signal.getsignal(signal.SIGUSR1)
            with engine._entry():
                handler(signal.SIGUSR1, None)
                assert not engine.is_ready()
                with engine._lock:
                    assert engine._pending_drain[0] == 1.0
                    engine._pending_drain = None
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
        assert engine._draining


# ---------------------------------------------------------------------
# stuck-dispatch watchdog
# ---------------------------------------------------------------------
class TestStuckWatchdog:
    def test_arm_skips_cold_and_thin_history(self, engine):
        engine._arm_watchdog(cold=True)
        assert engine._wd is None
        engine._dispatch_times.extend([0.01] * 4)   # < 8 samples
        engine._arm_watchdog(cold=False)
        assert engine._wd is None

    def test_arm_uses_p99_with_floor(self, engine):
        engine.stuck_min_timeout = 0.5
        engine._dispatch_times.extend([0.01] * 16)
        engine._arm_watchdog(cold=False)
        assert engine._wd is not None
        assert engine._wd.timeout == pytest.approx(0.5)
        engine._dispatch_times.extend([1.0] * 16)
        engine._arm_watchdog(cold=False)
        assert engine._wd.timeout == pytest.approx(8.0)
        engine._disarm_watchdog()
        assert engine._wd.timeout == float("inf")

    def test_stall_fires_watchdog(self, engine):
        engine.stuck_min_timeout = 0.05
        engine._dispatch_times.extend([0.005] * 16)
        engine._arm_watchdog(cold=False)
        wd = engine._wd
        deadline = time.monotonic() + 5.0
        while wd.timeouts == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert wd.timeouts >= 1
        engine._disarm_watchdog()

    def test_close_is_idempotent(self, engine):
        engine._dispatch_times.extend([0.01] * 16)
        engine._arm_watchdog(cold=False)
        engine.close()
        assert engine._wd is None
        engine.close()
        engine._arm_watchdog(cold=False)    # closed: never restarted
        assert engine._wd is None

    def test_disabled_by_a_zero_factor(self, pkg):
        e = pkg.engine(max_batch=2, page_size=8, num_pages=16,
                       stuck_factor=0)
        e._dispatch_times.extend([0.01] * 16)
        e._arm_watchdog(cold=False)
        assert e._wd is None
        e.close()


def test_step_watchdog_fires_once_per_stall(packages):
    """The watchdog's own contract, both packages: ``on_timeout(gap)``
    once per stall, a beat re-arms it, ``disarm`` never fires."""
    for name in ("reference", "port"):
        gaps = []
        wd = packages[name].StepWatchdog(timeout=0.05, poll=0.01,
                                         on_timeout=gaps.append).start()
        time.sleep(0.2)
        assert wd.timeouts == 1 and len(gaps) == 1 and gaps[0] > 0.05
        wd.beat()
        time.sleep(0.2)
        assert wd.timeouts == 2
        wd.disarm()
        time.sleep(0.1)
        assert wd.timeouts == 2
        wd.stop()


def test_port_stall_is_logged(caplog):
    """A stall of the port's engine shows as one warning naming the
    watchdog (beside the post-mortem, which needs an installed flight
    recorder)."""
    wd = watchdog.StepWatchdog(timeout=0.05, poll=0.01,
                               name="serving.decode").start()
    with caplog.at_level(logging.WARNING, logger=watchdog.__name__):
        time.sleep(0.2)
    wd.stop()
    msgs = [r.getMessage() for r in caplog.records
            if r.name == watchdog.__name__]
    assert len(msgs) == 1 and msgs[0].startswith(
        "watchdog serving.decode: no beat for")


# ---------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------
class TestFaultExc:
    def test_raise_custom_exception_type(self, pkg, monkeypatch):
        plan = [{"point": "serve.admit", "action": "raise",
                 "exc": "MemoryError"}]
        monkeypatch.setenv(pkg.faults.PLAN_ENV, json.dumps(plan))
        pkg.faults.reset()
        try:
            with pytest.raises(MemoryError, match="serve.admit"):
                pkg.faults.fire("serve.admit")
        finally:
            pkg.faults.reset()

    def test_unknown_exc_rejected_at_parse(self, pkg):
        with pytest.raises(ValueError, match="unknown exc"):
            pkg.faults.FaultRule({"point": "serve.admit", "action": "raise",
                                  "exc": "SystemExit"})

    def test_default_exc_is_oserror(self, pkg):
        rule = pkg.faults.FaultRule({"point": "serve.admit",
                                     "action": "raise"})
        with pytest.raises(OSError):
            rule.perform("serve.admit", None, None)


@pytest.mark.parametrize("spec", [
    {"point": "serve.typo", "action": "raise"},
    {"point": "serve.admit", "action": "explode"},
    {"point": "serve.admit", "action": "raise", "when": 3},
])
def test_fault_plans_are_validated_as_the_reference(spec):
    """A typo'd plan fails at parse time in both packages, with the same
    message."""
    msgs = []
    for mod in (jax_faults, faults):
        with pytest.raises(ValueError) as ei:
            mod.FaultPlan([spec])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", [
    {"point": "rpc.send", "action": "drop", "p": 0.4, "seed": 7},
    {"point": "rpc.reply", "action": "duplicate", "copies": 2, "count": 3},
    {"point": "store.frame", "action": "slow", "seconds": 0.01},
])
def test_network_and_store_rules_wait_for_their_call_sites(spec):
    """A rule at a message or socket point parses in both packages since
    their call sites came with the serving stack (ROADMAP A9): the rules
    are the reference's, and so are the process, message and socket
    points."""
    plans = [mod.FaultPlan([spec]) for mod in (jax_faults, faults)]
    kinds = [(len(p.rules), len(p.net_rules), len(p.store_rules))
             for p in plans]
    assert kinds[0] == kinds[1] and kinds[1][0] == 0
    assert faults.PROCESS_POINTS == jax_faults.PROCESS_POINTS
    assert faults.NETWORK_POINTS == jax_faults.NETWORK_POINTS
    assert faults.STORE_POINTS == jax_faults.STORE_POINTS


def test_admission_error_retry_after_in_message(pkg):
    e = pkg.AdmissionError("engine full", live=1, max_batch=1, free_pages=3,
                           num_pages=8, retries=0, retry_after=0.25)
    assert "retry after 0.250s" in str(e)
    assert e.retry_after == 0.25
    e2 = pkg.AdmissionError("engine full", 1, 1, 3, 8, 0)
    assert e2.retry_after is None


# ---------------------------------------------------------------------
# chip_smoke phase 14b's schedule at tiny width
# ---------------------------------------------------------------------
def _ref_in_scan(engine, fn):
    """The reference's scan in flight: ``fn`` runs once right before its
    compiled scan is called (``_in_dispatch`` is set)."""
    ensure = engine._ensure_scan_compiled

    def hooked(n):
        sf = ensure(n)
        engine._ensure_scan_compiled = ensure

        def call(*a, **k):
            fn()
            return sf(*a, **k)
        return call
    engine._ensure_scan_compiled = hooked


def test_lifecycle_schedule_gives_the_card_s_values(packages):
    """Phase 14b on both engines at tiny width (a pool that holds
    everything, ``admit_retries=2``): the 9th admission shed as "engine
    full" after two backoffs; the statuses (and, where timing does not
    decide them, the lengths) are ``chip_smoke.LIFECYCLE_END``; the
    thread's cancel inside the scan deferred its release past the scan;
    the fresh request completes on what it released."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    prompts = cs.serving_prompts(128)
    ends = []
    for name, hook in (("reference", _ref_in_scan),
                       ("port", cs.in_first_tick)):
        p = packages[name]
        e = p.engine(max_batch=8, page_size=16, num_pages=cs.PREFIX_POOL,
                     admit_retries=2, max_pages_per_seq=40)
        reqs, shed, fresh, seen = cs.lifecycle_schedule(e, p.Request,
                                                        prompts, hook)
        assert isinstance(shed, p.AdmissionError)
        assert (shed.reason, shed.retries, shed.live) == ("engine full", 2, 8)
        assert shed.retry_after > 0
        end = tuple((r.status, len(r.output_ids)) for r in reqs)
        for (s, m), (want, n) in zip(end, cs.LIFECYCLE_END):
            assert s == want and (n is None or m == n), (name, end)
        victim = reqs[cs.LC_THREAD_CANCEL]
        assert seen["tables"] and seen["deferred"] == [victim.seq_id]
        assert set(seen["table"]) & set(seen["fresh_table"])
        assert fresh.status == "completed" and len(fresh.output_ids) == cs.NEW
        assert e.alloc.free_pages + e.prefix.pages == e.alloc.num_pages
        assert not e.alloc._tables and e.alloc.double_free_count == 0
        ends.append([(r.status, r.output_ids) for r in reqs
                     if r.status == "completed"] + [fresh.output_ids])
        e.close()
    assert ends[0] == ends[1]


def _host_state(engine, reqs):
    """What both engines must agree on after every call."""
    a = engine.alloc
    return (list(a._free), {k: list(v) for k, v in a._tables.items()},
            dict(a._lens), dict(a._refs), a.double_free_count,
            engine.prefix.stats() if engine.prefix is not None else None,
            [(r.status, len(r.output_ids), r.seq_id, r.trimmed,
              r.retry_budget, type(r.error).__name__ if r.error else None,
              getattr(r.error, "reason", None)) for r in reqs],
            [reqs.index(r) for r in engine._requeue], sorted(engine._live),
            engine._deferred_release)


def test_lifecycle_lockstep_with_dispatches(packages):
    """Both engines through one driven run in a tight pool, host state
    equal after every call: prefill steps, a higher-priority admission
    into the full engine (trimmed victim), a shed, decode pressure (the
    ladder evicts, the pump re-admits), a cancel, a forced deadline,
    scans, then a drain."""
    runs = []
    for name in ("reference", "port"):
        p = packages[name]
        e = p.engine(max_batch=3, page_size=8, num_pages=10)
        rng = np.random.RandomState(5)
        reqs = [p.Request(rng.randint(0, 128, n).tolist(), max_new_tokens=m,
                          priority=pr, retry_budget=1)
                for n, m, pr in ((11, 30, 0), (19, 24, 1), (6, 40, 1),
                                 (9, 26, 2), (14, 5, 0))]
        trace, events = [], []

        def note(what):
            events.append(what)
            trace.append(_host_state(e, reqs))
        for r in reqs[:3]:
            e.add_request(r)
            note("add")
        e._admit(reqs[3])                   # full: the ladder trims
        note("admit 3")
        try:
            e._admit(reqs[4])               # no lower priority: shed
        except MemoryError as err:
            note(("shed", err.reason, err.retries))
        for _ in range(4):
            e.decode_many(4)
            note("decode")
        live = [r for r in reqs if r.status == "live"]
        e.cancel(live[0])
        note("cancel")
        live[1]._expires_at = time.perf_counter() - 1.0
        for _ in range(8):
            e.decode_many(4)
            note("decode")
        e.drain(timeout=60.0)
        note("drain")
        runs.append((events, trace))
        e.close()
    assert runs[0] == runs[1]
    seen = {s for state in runs[1][1] for s, *_ in state[6]}
    assert {"completed", "cancelled", "deadline_exceeded"} <= seen, seen
    assert "requeued" in seen or "evicted" in seen, seen
