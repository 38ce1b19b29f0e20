"""The port's host KV tier (``inference/kv_tier.py``) and the engine's
pause rung against the reference (mirrors ``tests/test_kv_tier.py``).

The allocator's tier API and the fault points run on both packages. The
tier unit takes the same numpy pools (f32, bf16, int8 pages with f32
scale sidecars) into both packages' ``KvPageTier``: the per-page CRCs,
byte counts, ``stats()`` and error types must be the reference's, and
round trips bitwise. The engine cases run the reference engine (its
two-op path, ``fused_kv=False``) and the port's over the same fitted tiny
model (``fit_on_prompts``): a paused and resumed request's tokens equal
the uninterrupted run's and the reference engine's; under the copy-chaos
plan both engines give the same statuses, outputs, tier stats, allocator
and metric deltas. The port's restores and promotions write the pools in
place (``data_ptr()`` unchanged), and a pause from a second thread while
a decode scan is in flight resumes bitwise. The reference's three
``slow`` marks sit on the same cases.
"""

import json
import os
import pathlib
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
from paddle_tpu.inference import kv_tier as jax_tier
from paddle_tpu.inference.paged_cache import PageAllocator as JaxAllocator
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.quant import quality
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.inference import kv_tier
from paddle_tpu_torch.inference.kv_tier import (
    KvPageTier, TierCapacityError, TierCorruptError, TierError,
    TierExportError, TierRestoreError)
from paddle_tpu_torch.inference.paged_cache import PageAllocator
from paddle_tpu_torch.inference.serving import (
    AdmissionError, DeadlineExceeded, LlamaServingEngine, Request)
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.testing import faults

ALLOCATORS = {"reference": JaxAllocator, "port": PageAllocator}
FAULTS = {"reference": jax_faults, "port": faults}


@pytest.fixture()
def clean_faults():
    for f in FAULTS.values():
        f.reset()
    yield
    os.environ.pop(faults.PLAN_ENV, None)
    for f in FAULTS.values():
        f.reset()


def _plan(rules):
    os.environ[faults.PLAN_ENV] = json.dumps(rules)
    for f in FAULTS.values():
        f.reset()


def _value(counter, *labels):
    if counter is om.NULL or counter is jax_om.NULL:
        return 0.0
    return (counter.labels(*labels) if labels else counter).value


# ---------------------------------------------------------------------
# the allocator's tier API, both packages
# ---------------------------------------------------------------------
@pytest.fixture(params=sorted(ALLOCATORS))
def alloc_cls(request):
    return ALLOCATORS[request.param]


class TestAllocatorTierApi:
    def test_export_table_snapshot(self, alloc_cls):
        a = alloc_cls(num_pages=8, page_size=4)
        a.admit(1, 6)
        table, n = a.export_table(1)
        assert n == 6 and len(table) == 2
        table.append(99)
        assert len(a._tables[1]) == 2

    def test_export_table_unknown_seq(self, alloc_cls):
        with pytest.raises(KeyError):
            alloc_cls(num_pages=8, page_size=4).export_table(7)

    def test_import_table_exclusive_pages(self, alloc_cls):
        a = alloc_cls(num_pages=8, page_size=4)
        free0 = a.free_pages
        a.import_table(3, 6)
        assert a._lens[3] == 6 and len(a._tables[3]) == 2
        assert a.free_pages == free0 - 2
        assert all(a._refs[p] == 1 for p in a._tables[3])
        a.release(3)
        assert a.free_pages == free0

    def test_take_pages_atomic(self, alloc_cls):
        a = alloc_cls(num_pages=6, page_size=4)
        free0 = a.free_pages
        got = a.take_pages(2)
        assert len(got) == 2 and a.free_pages == free0 - 2
        with pytest.raises(MemoryError):
            a.take_pages(free0)
        assert a.free_pages == free0 - 2
        for p in got:
            a.decref(p)
        assert a.free_pages == free0


# ---------------------------------------------------------------------
# the copy fault points, both packages' plans
# ---------------------------------------------------------------------
class TestTierFaultPoints:
    def test_points_registered(self):
        for f in FAULTS.values():
            assert {"tier.d2h", "tier.h2d"} <= f.PROCESS_POINTS
        assert "fire_copy" in faults.__all__

    def test_cookbook_plan_validates(self, clean_faults):
        plan = [{"point": "tier.d2h", "action": "sleep",
                 "seconds": 0.05, "count": 2},
                {"point": "tier.h2d", "action": "bitflip", "count": 1}]
        faults.FaultPlan(plan)
        _plan(plan)
        assert faults.plan() is not None and faults.active()

    def test_unknown_point_rejected(self):
        with pytest.raises(ValueError, match="tier"):
            faults.FaultPlan([{"point": "tier.dh2", "action": "raise"}])

    def test_message_points_wait_on_a9(self):
        with pytest.raises(ValueError, match="ROADMAP A9") as e:
            faults.FaultPlan([{"point": "rpc.send", "action": "drop"}])
        assert "A7" not in str(e.value)

    def test_fire_copy_as_reference(self, clean_faults):
        """bitflip is consumed and reported as torn; raise and path
        scoping as the reference's ``fire_copy``."""
        _plan([{"point": "tier.h2d", "action": "bitflip", "count": 1},
               {"point": "tier.d2h", "action": "raise", "exc": "OSError",
                "path": "seq"}])
        for f in FAULTS.values():
            assert f.fire_copy("tier.h2d") is True
            assert f.fire_copy("tier.h2d") is False
            assert f.fire_copy("tier.d2h", path="prefix") is False
            with pytest.raises(OSError):
                f.fire_copy("tier.d2h", path="seq")

    def test_fire_copy_sleep_acts(self, clean_faults):
        _plan([{"point": "tier.d2h", "action": "sleep", "seconds": 0.05}])
        t0 = time.perf_counter()
        assert faults.fire_copy("tier.d2h") is False
        assert time.perf_counter() - t0 >= 0.05


# ---------------------------------------------------------------------
# KvPageTier on the same pools in both packages
# ---------------------------------------------------------------------
KINDS = ("f32", "bf16", "int8")


def _np_pools(kind, layers=2, num_pages=6, hk=2, page=4, d=8, seed=0):
    """Numpy K/V pools (and f32 scale sidecars for int8) of one kind:
    ``(k, v, ks, vs)`` lists; bf16 as its raw uint16 bits."""
    rng = np.random.default_rng(seed)
    shape = (num_pages, hk, page, d)

    def pool():
        if kind == "int8":
            return rng.integers(-127, 128, shape).astype(np.int8)
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "bf16":
            return (x.view(np.uint32) >> 16).astype(np.uint16)
        return x

    k = [pool() for _ in range(layers)]
    v = [pool() for _ in range(layers)]
    if kind != "int8":
        return k, v, None, None
    sc = [rng.random((num_pages, hk, page, 1)).astype(np.float32)
          for _ in range(2 * layers)]
    return k, v, sc[:layers], sc[layers:]


def _as_jax(a):
    if a.dtype == np.uint16:
        return jnp.asarray(a.view(jnp.bfloat16))
    return jnp.asarray(a)


def _as_torch(a):
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _both(kind, **kw):
    pools = _np_pools(kind, **kw)
    conv = lambda f: tuple(None if p is None else [f(a) for a in p]
                           for p in pools)
    return conv(_as_jax), conv(_as_torch)


def _bits(t):
    return t.view(torch.uint8).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


class TestKvPageTierUnit:
    @pytest.mark.parametrize("kind", KINDS)
    def test_crcs_bytes_and_stats_are_the_reference_s(self, kind,
                                                      clean_faults):
        jp, tp = _both(kind)
        jt = jax_tier.KvPageTier(max_bytes=1 << 20, prefetch=False)
        tt = KvPageTier(max_bytes=1 << 20, prefetch=False)
        jk = jt.export_seq(*jp, [1, 4, 2], 11)
        tk = tt.export_seq(*tp, [1, 4, 2], 11)
        assert tt._seqs[tk].crcs == jt._seqs[jk].crcs
        assert tt._seqs[tk].nbytes == jt._seqs[jk].nbytes
        assert tt.stats() == jt.stats() and tt.seq_tokens(tk) == 11
        # a demoted prefix page: the same CRC and bytes
        assert jt.put_prefix("ab", None, *jp, 3)
        assert tt.put_prefix("ab", None, *tp, 3)
        assert tt._prefix["ab"].crc == jt._prefix["ab"].crc
        assert tt.stats() == jt.stats()

    @pytest.mark.parametrize("kind", KINDS)
    def test_round_trip_is_bitwise_and_in_place(self, kind, clean_faults):
        _, src = _both(kind, seed=1)
        _, dst = _both(kind, seed=2)
        flat = [p for ps in dst if ps for p in ps]
        ptrs = [p.data_ptr() for p in flat]
        untouched = [p[[0, 1, 2]].clone() for p in flat]
        t = KvPageTier(max_bytes=1 << 20, prefetch=False)
        key = t.export_seq(*src, [1, 3, 5], 9)
        out = t.restore_seq(key, *dst, [4, 3, 5])
        assert all(a is b for a, b in zip(out, dst))       # the same lists
        assert [p.data_ptr() for p in flat] == ptrs        # no rebinding
        for s, d, u in zip([p for ps in src if ps for p in ps], flat,
                           untouched):
            assert np.array_equal(_bits(d[[4, 3, 5]]), _bits(s[[1, 3, 5]]))
            assert np.array_equal(_bits(d[[0, 1, 2]]), _bits(u))
        assert t.bytes == 0 and t.pages == 0
        assert (t.stats()["exports"], t.stats()["restores"]) == (1, 1)

    def test_export_restore_roundtrip_as_reference(self, clean_faults):
        jp, tp = _both("f32", layers=1)
        jt = jax_tier.KvPageTier(max_bytes=1 << 20, prefetch=False)
        tt = KvPageTier(max_bytes=1 << 20, prefetch=False)
        jk = jt.export_seq(*jp, [1, 3], 4)
        tk = tt.export_seq(*tp, [1, 3], 4)
        zj = [jnp.zeros_like(jp[0][0])], [jnp.zeros_like(jp[1][0])]
        zt = [torch.zeros_like(tp[0][0])], [torch.zeros_like(tp[1][0])]
        nk, nv, _, _ = jt.restore_seq(jk, *zj, None, None, [0, 2])
        tt.restore_seq(tk, *zt, None, None, [0, 2])
        assert np.array_equal(zt[0][0].numpy(), np.asarray(nk[0]))
        assert np.array_equal(zt[1][0].numpy(), np.asarray(nv[0]))
        assert tt.stats() == jt.stats()

    def test_free_idempotent(self, clean_faults):
        _, tp = _both("f32")
        t = KvPageTier(max_bytes=1 << 20, prefetch=False)
        key = t.export_seq(*tp, [0], 2)
        assert t.free(key) is True and t.free(key) is False
        assert t.bytes == 0

    # each failure: the same error type, the same stats in both packages
    FAILURES = {
        "torn d2h": ([{"point": "tier.d2h", "action": "bitflip",
                       "count": 1}], TierCorruptError, "crc_failures"),
        "failed h2d": ([{"point": "tier.h2d", "action": "raise",
                         "exc": "OSError", "count": 1}], TierRestoreError,
                       "restore_failures"),
        "torn h2d": ([{"point": "tier.h2d", "action": "bitflip",
                       "count": 1}], TierCorruptError, "crc_failures"),
    }

    @pytest.mark.parametrize("case", sorted(FAILURES))
    def test_restore_failures_typed_as_reference(self, case, clean_faults):
        rules, exc, stat = self.FAILURES[case]
        _plan(rules)
        jp, tp = _both("int8")
        jt = jax_tier.KvPageTier(max_bytes=1 << 20, prefetch=False)
        tt = KvPageTier(max_bytes=1 << 20, prefetch=False)
        jk = jt.export_seq(*jp, [0, 1], 3)
        tk = tt.export_seq(*tp, [0, 1], 3)
        with pytest.raises(getattr(jax_tier, exc.__name__)):
            jt.restore_seq(jk, *jp, [2, 3])
        with pytest.raises(exc):
            tt.restore_seq(tk, *tp, [2, 3])
        assert tt.bytes == 0 and tt.stats()[stat] == 1
        assert tt.stats() == jt.stats()

    def test_failed_d2h_is_typed(self, clean_faults):
        _plan([{"point": "tier.d2h", "action": "raise", "count": 1}])
        _, tp = _both("f32")
        t = KvPageTier(max_bytes=1 << 20, prefetch=False)
        with pytest.raises(TierExportError):
            t.export_seq(*tp, [0], 2)
        assert t.bytes == 0 and t.stats()["export_failures"] == 1

    def test_capacity_is_typed(self, clean_faults):
        _, tp = _both("f32")
        t = KvPageTier(max_bytes=1, prefetch=False)
        with pytest.raises(TierCapacityError):
            t.export_seq(*tp, [0], 2)
        assert t.bytes == 0 and t.stats()["capacity_rejections"] == 1

    def test_error_taxonomy(self):
        for exc in (TierCapacityError, TierExportError, TierRestoreError,
                    TierCorruptError):
            assert issubclass(exc, TierError)
        assert issubclass(TierCorruptError, TierRestoreError)
        assert issubclass(TierError, RuntimeError)

    def test_prefix_page_roundtrip(self, clean_faults):
        _, tp = _both("bf16")
        t = KvPageTier(max_bytes=1 << 20, prefetch=False)
        assert t.put_prefix("ab", None, *tp, 1)
        assert t.has_prefix("ab") and t.prefix_parent("ab") is None
        _, dst = _both("bf16", seed=3)
        t.restore_prefix("ab", *dst, 3)
        assert torch.equal(dst[0][1][3], tp[0][1][1])
        assert not t.has_prefix("ab") and t.bytes == 0

    def test_prefix_never_evicts_seqs(self, clean_faults):
        _, tp = _both("f32", layers=1)
        nbytes = 2 * tp[0][0][0].numel() * 4
        t = KvPageTier(max_bytes=nbytes, prefetch=False)
        key = t.export_seq(*tp, [0], 1)
        assert t.put_prefix("ab", None, *tp, 1) is False
        assert t.seq_tokens(key) == 1

    def test_staged_restore(self, clean_faults):
        """``stage`` verifies the host copy on the staging thread; the
        restore then takes the staged copy, bitwise the same."""
        _, src = _both("int8", seed=4)
        _, dst = _both("int8", seed=5)
        t = KvPageTier(max_bytes=1 << 20)
        try:
            key = t.export_seq(*src, [2, 0], 5)
            t.stage(key)
            t0 = time.perf_counter()
            while t._staged.get(key) is None \
                    and time.perf_counter() - t0 < 10:
                time.sleep(0.01)
            assert t._staged.get(key) is not None
            t.restore_seq(key, *dst, [1, 4])
            assert key not in t._staged and t.bytes == 0
            for s, d in zip([p for ps in src for p in ps],
                            [p for ps in dst for p in ps]):
                assert torch.equal(d[[1, 4]], s[[2, 0]])
        finally:
            t.close()
        assert t._stage_thread is None


# ---------------------------------------------------------------------
# engines over a fitted tiny model
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    quality.fit_on_prompts(jm, steps=20)
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def models(fitted):
    jm = JaxLlama(jax_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in fitted.items()})
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return jm, load_numpy_state(tm, fitted).eval()


def _engines(models, **kw):
    """(reference engine, port engine, reference Request, port
    Request) of one geometry."""
    return (_engine(models, 0, **kw), _engine(models, 1, **kw), JaxRequest,
            Request)


def _engine(models, k, **kw):
    """Package ``k``'s engine (0: the reference's two-op path, 1: the
    port's) over the fitted model."""
    jm, tm = models
    return JaxEngine(jm, fused_kv=False, **kw) if k == 0 \
        else LlamaServingEngine(tm, **kw)


def _complete(engine, req):
    engine.add_request(req)
    n = 0
    while not req.done and n < 1500:
        engine.step()
        n += 1
    assert req.done, req.status
    return req


def _drive(engine, reqs, max_steps=1500):
    """Client loop: admit with retry (AdmissionError is backpressure),
    step until every request is terminal."""
    pending = list(reqs)
    steps = 0
    while any(not r.done for r in reqs) and steps < max_steps:
        for r in list(pending):
            try:
                engine.add_request(r)
                pending.remove(r)
            except MemoryError:        # either package's AdmissionError
                pass
        engine.step()
        steps += 1
    assert all(r.done for r in reqs), [(r.status, len(r.output_ids))
                                       for r in reqs]


def _pools(engine):
    return engine.k_pools + engine.v_pools + engine.k_scales \
        + engine.v_scales


def _ptrs(engine):
    return [t.data_ptr() for t in _pools(engine)]


def _ladder_counts(engine):
    m = engine._m
    return (_value(m["paused"]), _value(m["resumed"]),
            _value(m["postponed"]),
            tuple(_value(m["degraded"], rung)
                  for rung in ("pause", "trim", "evict", "shed")))


class TestPauseResumeTokenExact:
    @pytest.mark.parametrize("kv_dtype,spec_k", [
        (None, 0),
        pytest.param("int8", 0, marks=pytest.mark.slow),
        pytest.param(None, 3, marks=pytest.mark.slow),
        ("int8", 3)],
        ids=["fp", "int8", "fp-spec", "int8-spec"])
    def test_resumed_tokens_bitwise_equal(self, models, kv_dtype, spec_k,
                                          clean_faults):
        """Uninterrupted, then paused at the 4th token and resumed: the
        same tokens, on both engines, and the reference's; the pools never
        rebound; the counters moved by one each; nothing leaked."""
        je, te, _, _ = _engines(
            models, max_batch=2, page_size=8, num_pages=32, kv_tier=True,
            prefix_cache=False, kv_dtype=kv_dtype, spec_k=spec_k)
        prompt = list(np.arange(1, 12) % 50)
        outs = []
        for e, req_cls in ((je, JaxRequest), (te, Request)):
            free0 = e.alloc.free_pages
            r0 = _complete(e, req_cls(prompt, max_new_tokens=12))
            r1 = req_cls(prompt, max_new_tokens=12)
            e.add_request(r1)
            while len(r1.output_ids) < 4:
                e.step()
            before = _ladder_counts(e)
            ptrs = _ptrs(e) if e is te else None
            with e._lock:
                e._pause(r1)
            assert r1.status == "paused" and r1.seq_id is None
            assert e.tier.pages > 0 and e.tier.bytes > 0
            assert e.alloc.free_pages == free0
            while not r1.done:
                e.step()
            assert r1.status == "completed"
            assert list(r1.output_ids) == list(r0.output_ids)
            after = _ladder_counts(e)
            assert (after[0] - before[0], after[1] - before[1],
                    after[3][0] - before[3][0]) == (1, 1, 1)
            assert e.tier.bytes == 0 and e.tier.pages == 0
            assert e.alloc.free_pages == free0
            assert e.alloc.double_free_count == 0
            if e is te:
                assert _ptrs(e) == ptrs
            outs.append(list(r0.output_ids))
            e.close()
        assert outs[0] == outs[1]


class TestLifecycleWhilePaused:
    @pytest.fixture()
    def tier_engine(self, models, clean_faults):
        _, tm = models
        e = LlamaServingEngine(tm, max_batch=2, page_size=8, num_pages=32,
                               kv_tier=True, prefix_cache=False)
        yield e
        e.close()

    def _paused_request(self, e, tokens=3, **kw):
        r = Request([1, 2, 3], max_new_tokens=64, **kw)
        e.add_request(r)
        while len(r.output_ids) < tokens:
            e.step()
        with e._lock:
            e._pause(r)
        assert r.status == "paused" and e.tier.bytes > 0
        return r

    def test_cancel_while_paused_frees_host_copy(self, tier_engine):
        e = tier_engine
        r = self._paused_request(e)
        assert e.cancel(r) is True
        assert r.done and r.status == "cancelled"
        assert e.tier.bytes == 0 and e.tier.pages == 0
        e.step()
        assert r not in e._requeue

    def test_deadline_expiry_while_paused(self, tier_engine):
        """The deadline keeps ticking while parked. The deadline is set
        to run out 50 ms after the pause (a loaded host may take longer
        than any fixed deadline to reach the pause point)."""
        e = tier_engine
        r = self._paused_request(e, deadline=60.0)
        r._expires_at = time.perf_counter() + 0.05
        time.sleep(0.1)
        e.step()
        assert r.done and r.status == "deadline_exceeded"
        assert isinstance(r.error, DeadlineExceeded)
        assert e.tier.bytes == 0 and e.tier.pages == 0

    def test_drain_with_parked_requests(self, tier_engine):
        e = tier_engine
        free_before = e.alloc.free_pages
        r = self._paused_request(e)
        assert e.alloc.free_pages == free_before
        stats = e.drain(timeout=0.5)
        assert r.done and r.status in ("completed", "deadline_exceeded")
        if r.status == "deadline_exceeded":
            assert isinstance(r.error, DeadlineExceeded)
        assert e.tier.bytes == 0 and e.tier.pages == 0
        with pytest.raises(AdmissionError):
            e.add_request(Request([1], max_new_tokens=1))
        assert stats["seconds"] >= 0

    def test_generate_resumes_a_paused_request(self, tier_engine):
        """``generate`` popping a paused request from the requeue resumes
        it (the reference re-admits it from its prompt)."""
        e = tier_engine
        want = _complete(e, Request([1, 2, 3], max_new_tokens=10))
        r = Request([1, 2, 3], max_new_tokens=10)
        e.add_request(r)
        while len(r.output_ids) < 3:
            e.step()
        with e._lock:
            e._pause(r)
        e.generate([[4, 5]], max_new_tokens=2)
        while not r.done:
            e.step()
        assert r.output_ids == want.output_ids and e.tier.bytes == 0

    def test_sigterm_races_inflight_d2h(self, models, monkeypatch,
                                        clean_faults):
        """SIGTERM while a pause's copy is in flight on another thread:
        the handler defers, the copy finishes, the deferred drain retires
        the freshly parked request typed and leak-free."""
        _plan([{"point": "tier.d2h", "action": "sleep", "seconds": 0.6,
                "count": 1}])
        _, tm = models
        e = LlamaServingEngine(tm, max_batch=2, page_size=8, num_pages=32,
                               kv_tier=True, prefix_cache=False)
        exits = []
        monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
        prev = e.install_drain_handler(grace=0.5)
        try:
            free0 = e.alloc.free_pages
            r = Request([1, 2, 3], max_new_tokens=100000)
            e.add_request(r)
            while len(r.output_ids) < 2:
                e.step()
            in_entry = threading.Event()

            def _pauser():
                with e._entry():
                    in_entry.set()
                    with e._lock:
                        e._pause(r)

            w = threading.Thread(target=_pauser)
            w.start()
            assert in_entry.wait(5.0)
            time.sleep(0.1)
            os.kill(os.getpid(), signal.SIGTERM)
            w.join(timeout=30.0)
            assert not w.is_alive()
            assert exits == [0]
            assert r.done and r.status == "deadline_exceeded"
            assert isinstance(r.error, DeadlineExceeded)
            assert e.tier.bytes == 0 and e.tier.pages == 0
            assert e.alloc.free_pages == free0
            assert e.alloc.double_free_count == 0
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
            e.close()


class TestInFlightPause:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_pause_from_a_second_thread_mid_scan(self, models, kv_dtype,
                                                 clean_faults):
        """A second thread pauses a request after the first tick of a
        decode scan that holds it: the export covers the tokens it has
        committed, not the scan's reservation; its release waits for the
        scan; the scan's tokens for its row are dropped; resumed, its
        tokens are the uninterrupted run's."""
        _, tm = models
        e = LlamaServingEngine(tm, max_batch=2, page_size=8, num_pages=32,
                               kv_tier=True, prefix_cache=False,
                               kv_dtype=kv_dtype, decode_ticks=8)
        try:
            prompt = [5, 9, 2, 7, 1]
            want = _complete(e, Request(prompt, max_new_tokens=20))
            r = Request(prompt, max_new_tokens=20)
            e.add_request(r)
            seen = {}
            run = e._run_tick

            def once(mode):
                e._run_tick = run
                out = run(mode)
                sid = r.seq_id
                seen["lens"] = e.alloc._lens[sid]
                seen["out"] = len(r.output_ids)

                def pause():
                    with e._lock:
                        e._pause(r)
                t = threading.Thread(target=pause)
                t.start()
                t.join(timeout=30)
                seen["deferred"] = sid in e._deferred_release
                seen["tokens"] = e.tier.seq_tokens(r._tier_key)
                return out
            e._run_tick = once
            e.decode_many(8)
            assert r.status == "paused", r.status
            assert seen["deferred"]
            committed = len(prompt) + seen["out"] - 1
            assert seen["tokens"] == committed < seen["lens"]
            assert len(r.output_ids) == seen["out"]      # scan's dropped
            while not r.done:
                e.step()
            assert r.output_ids == want.output_ids
            assert e.tier.bytes == 0 and not e.alloc._tables
        finally:
            e.close()


ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (phase 14d's chaos drive and values)

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)


def _tier_schedule(models, plan=None, kv_dtype=None,
                   retry_budget=cs.CHAOS_RETRIES):
    """Phase 14d's chaos drive (the reference test's: 3 requests, 7
    usable pages of 8 slots, 2 rows; :func:`chip_smoke.chaos_schedule`)
    on both engines, the tier on, under ``plan``: ``(outputs, statuses,
    typed errors, tier stats, free pages, double frees, ladder-counter
    deltas, tier-error deltas)`` of each."""
    runs = []
    for k in (0, 1):
        e = _engine(models, k, kv_tier=True, prefix_cache=False,
                    kv_dtype=kv_dtype, **cs.CHAOS_GEOM)
        req_cls = JaxRequest if k == 0 else Request
        if plan:
            _plan(plan)
        before = _ladder_counts(e)
        errs0 = {s: _value(e.tier._m["errors"], s)
                 for s in ("d2h", "h2d", "crc", "capacity")}
        reqs = cs.chaos_schedule(e, req_cls, retry_budget)
        after = _ladder_counts(e)
        runs.append((
            [list(r.output_ids) for r in reqs], [r.status for r in reqs],
            [type(r.error).__name__ for r in reqs], e.tier.stats(),
            e.alloc.free_pages, e.alloc.double_free_count,
            tuple(a - b for a, b in zip(after[:3], before[:3]))
            + tuple(a - b for a, b in zip(after[3], before[3])),
            {s: _value(e.tier._m["errors"], s) - v
             for s, v in errs0.items()}))
        e.close()
    return runs


class TestLadderRungs:
    @pytest.mark.slow
    def test_pressure_pauses_instead_of_evicting(self, models,
                                                 clean_faults):
        """No faults: the pressure rung pauses (work preserved); both
        engines alike, every request completes token-exact against a
        roomy un-pressured run."""
        _, tm = models
        roomy = LlamaServingEngine(tm, max_batch=4, page_size=8,
                                   num_pages=64, prefix_cache=False)
        want = [list(_complete(roomy, Request(p, max_new_tokens=40))
                     .output_ids) for p in cs.chaos_prompts()]
        roomy.close()
        ref, port = _tier_schedule(models, retry_budget=4)
        assert port == ref
        outs, statuses, _, st = port[:4]
        assert st["exports"] >= 1 and st["restores"] >= 1
        assert statuses == ["completed"] * 3 and outs == want

    def test_full_tier_degrades_to_evict(self, models, clean_faults):
        _, tm = models
        e = LlamaServingEngine(tm, max_batch=2, page_size=8, num_pages=32,
                               kv_tier=True, kv_tier_bytes=1,
                               prefix_cache=False)
        try:
            r = Request([1, 2, 3], max_new_tokens=24, retry_budget=2)
            e.add_request(r)
            while len(r.output_ids) < 3:
                e.step()
            with e._lock:
                e._pause(r)
            assert r.status == "requeued"
            assert e.tier.stats()["capacity_rejections"] >= 1
            assert e.tier.bytes == 0
            while not r.done:
                e.step()
            assert r.status == "completed"
        finally:
            e.close()

    def test_postponed_counter(self, models, clean_faults):
        """Another thread mid-entry: victims are postponed, not paused,
        and counted as the reference counts them; all complete."""
        deltas = []
        for k, req_cls in ((0, JaxRequest), (1, Request)):
            e = _engine(models, k, max_batch=2, page_size=8, num_pages=8,
                        kv_tier=True, prefix_cache=False)
            rs = [req_cls([1, 2, 3], max_new_tokens=8),
                  req_cls([4, 5, 6], max_new_tokens=8)]
            for r in rs:
                e.add_request(r)
            while any(len(r.output_ids) < 1 for r in rs):
                e.step()
            p0 = _value(e._m["postponed"])
            fake = object()
            with e._lock:
                e._entry_threads[fake] = 1
                try:
                    e._relieve_pressure(list(e._live.values()),
                                        5 * e.page_size)
                finally:
                    e._entry_threads.pop(fake, None)
            assert all(r.status == "live" for r in rs)
            deltas.append(_value(e._m["postponed"]) - p0)
            steps = 0
            while any(not r.done for r in rs) and steps < 400:
                e.step()
                steps += 1
            assert all(r.status == "completed" for r in rs)
            e.close()
        assert deltas[1] == deltas[0] > 0


class TestPrefixTiering:
    def test_cold_prefix_demotes_and_promotes(self, models, clean_faults):
        """Cold cached pages demote into the tier and a same-prefix
        admission promotes them back in place: both engines' tier stats
        alike, the tokens the warm run's and the reference's."""
        je, te, _, _ = _engines(models, max_batch=2, page_size=8,
                                num_pages=64, kv_tier=True,
                                prefix_cache=True)
        prompt = list(np.arange(1, 21) % 50)
        res = []
        for e, req_cls in ((je, JaxRequest), (te, Request)):
            r0 = _complete(e, req_cls(prompt, max_new_tokens=8))
            assert e.prefix.pages >= 1
            e.prefix.evict_pages(e.prefix.pages)
            st = e.tier.stats()
            assert st["prefix_demotions"] >= 1 and st["prefix_pages"] >= 1
            ptrs = _ptrs(e) if e is te else None
            r1 = _complete(e, req_cls(prompt, max_new_tokens=8))
            assert e.tier.stats()["prefix_promotions"] >= 1
            assert r1.status == "completed" and r1._cached_tokens == 16
            assert list(r1.output_ids) == list(r0.output_ids)
            if e is te:
                assert _ptrs(e) == ptrs
            res.append((list(r0.output_ids), e.tier.stats(),
                        e.prefix.stats()))
            e.close()
        assert res[0] == res[1]


class TestCopyChaos:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_no_request_silently_lost(self, models, kv_dtype, clean_faults):
        """The reference test's copy-chaos plan (phase 14d's) on both
        engines: every fault typed and degraded, every request completed
        token-exact or failed typed, the failure counts, statuses,
        outputs, counters and allocator the reference engine's and the
        values the card is held to (``CHAOS_STATS``), nothing leaked."""
        ref, port = _tier_schedule(models, list(cs.CHAOS_PLAN), kv_dtype)
        assert port == ref
        outs, statuses, errors, st, free, double, ladder, errs = port
        for s, e in zip(statuses, errors):
            assert s == "completed" or e != "NoneType", (s, e)
        assert {k: st[k] for k in cs.CHAOS_STATS} == cs.CHAOS_STATS
        assert st["bytes"] == 0 and st["pages"] == 0 and double == 0
        assert free == cs.CHAOS_GEOM["num_pages"] - 1
        assert errs == {"d2h": 1, "h2d": 1, "crc": 1, "capacity": 0}
        assert ladder[0] == ladder[3] == st["exports"]      # paused
        assert ladder[1] == st["restores"]                  # resumed


class TestTierMetrics:
    def test_metric_names_as_reference(self, models, monkeypatch):
        """The tier's four metrics and the ladder's four counters: the
        reference's names, kinds, help, labels and buckets."""
        monkeypatch.delenv("PADDLE_TPU_METRICS", raising=False)
        jm, tm = models
        je = JaxEngine(jm, fused_kv=False, max_batch=1, page_size=8,
                       num_pages=8, kv_tier=True, prefix_cache=False)
        e = LlamaServingEngine(tm, max_batch=1, page_size=8, num_pages=8,
                               kv_tier=True, prefix_cache=False)
        try:
            assert {"paused", "resumed", "postponed", "degraded"} \
                <= set(e._m)
            for mine, ref in ((e._m[k], je._m[k]) for k in
                              ("paused", "resumed", "postponed",
                               "degraded")):
                assert (mine.name, mine.kind, mine.help, mine.labelnames) \
                    == (ref.name, ref.kind, ref.help, ref.labelnames)
            for k in ("pages", "bytes", "restore_ms", "errors"):
                mine, ref = e.tier._m[k], je.tier._m[k]
                assert (mine.name, mine.kind, mine.help, mine.labelnames) \
                    == (ref.name, ref.kind, ref.help, ref.labelnames)
            assert e.tier._m["restore_ms"].buckets \
                == je.tier._m["restore_ms"].buckets
            names = {m.name for m in om.default_registry().collect()}
            assert {"kv_tier_pages", "kv_tier_bytes", "kv_tier_restore_ms",
                    "kv_tier_errors_total", "serving_paused_total",
                    "serving_resumed_total",
                    "serving_pressure_postponed_total",
                    "serving_degraded_total"} <= names
        finally:
            je.close()
            e.close()

    def test_null_when_metrics_off(self, models, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        _, tm = models
        e = LlamaServingEngine(tm, max_batch=1, page_size=8, num_pages=8,
                               kv_tier=True, prefix_cache=False)
        try:
            assert all(m is om.NULL for m in e._m.values())
            assert all(m is om.NULL for m in e.tier._m.values())
        finally:
            e.close()

    def test_tier_opt_in_default_off(self, models, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_KV_TIER", raising=False)
        jm, tm = models
        je = JaxEngine(jm, fused_kv=False, max_batch=1, page_size=8,
                       num_pages=8, prefix_cache=False, kv_tier_bytes=4096)
        e = LlamaServingEngine(tm, max_batch=1, page_size=8, num_pages=8,
                               prefix_cache=False, kv_tier_bytes=4096)
        assert e.tier is None and je.tier is None
        je.close()
        e.close()

    @pytest.mark.parametrize("value", ["1", "true", "ON", "0", "off"])
    def test_tier_env_knobs(self, models, monkeypatch, value):
        monkeypatch.setenv("PADDLE_TPU_KV_TIER", value)
        monkeypatch.setenv("PADDLE_TPU_KV_TIER_BYTES", "12345")
        jm, tm = models
        je = JaxEngine(jm, fused_kv=False, max_batch=1, page_size=8,
                       num_pages=8, prefix_cache=True)
        e = LlamaServingEngine(tm, max_batch=1, page_size=8, num_pages=8,
                               prefix_cache=True)
        try:
            assert (e.tier is None) == (je.tier is None)
            if e.tier is not None:
                assert e.tier.max_bytes == je.tier.max_bytes == 12345
                assert e.prefix.demote == e._demote_prefix_page
            else:
                assert e.prefix.demote is None
        finally:
            je.close()
            e.close()
