"""The port's speculative decoding (``inference/speculative.py`` and the
engine's ``spec_k``) against the reference (mirrors
``tests/test_speculative.py`` and the speculative cases of
``tests/test_sampling.py``).

The drafter cases run on both packages' ``NGramDrafter`` and must propose
alike, on the reference's cases and on seeded random histories (the
``max_history`` freeze and a rewinding history included). The engine
cases serve the same requests on the reference engine (its two-op path,
``fused_kv=False``: the fused reference engine is not a trusted oracle on
the CPU) and the port's over one tiny model fitted by ``fit_on_prompts``
(a random-init model's logits are near-ties), with the n-gram drafter,
an oracle that proposes the non-speculative run's own tokens (every
draft accepted) and a garbage drafter (every draft rejected, every verify
row rolled back): greedy tokens, ``spec_stats()`` and the allocator's
tables, lengths, refcounts and free list (in order) equal after every
step; the tokens equal to the port's ``spec_k=0`` run too. Then the
budget, stop tokens, prefill under speculation, spec state on retire and
evict, cancel / deadline / eviction mid-speculation (a cancel inside the
dispatch releases the pages once), int8 KV, the three attention paths
bitwise after rollbacks, ``decode_many``'s chunk sequence (short scans
first, full scans after two empty probes) and sampled speculation, whose
seeded draws equal the non-speculative engine's.
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jax_sampling
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.inference.speculative import NGramDrafter as JaxNGram
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference import NGramDrafter, SamplingParams
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)

GEOM = dict(max_batch=4, page_size=8, num_pages=64, chunk_block=8,
            chunk_budget=16)
DRAFTERS = {"reference": JaxNGram, "port": NGramDrafter}


# ---------------------------------------------------------------------
# the drafter, on both packages' classes
# ---------------------------------------------------------------------
@pytest.fixture(params=sorted(DRAFTERS))
def drafter_cls(request):
    return DRAFTERS[request.param]


class TestNGramDrafter:
    def test_proposes_continuation_of_repeating_history(self, drafter_cls):
        d = drafter_cls(n=3)
        d.sync([1, 2, 3, 1, 2, 3, 1, 2], [])
        assert d.propose(4) == [3, 1, 2, 3]

    def test_unseen_context_proposes_nothing(self, drafter_cls):
        d = drafter_cls(n=3)
        d.sync([1, 2, 3, 4, 5, 6, 7], [])
        assert d.propose(4) == []

    def test_longest_context_wins(self, drafter_cls):
        d = drafter_cls(n=2)
        d.sync([1, 7, 9, 1, 5, 1, 7, 2, 9, 1], [])
        assert d.propose(1) == [5]

    def test_sync_is_incremental_over_outputs(self, drafter_cls):
        d = drafter_cls(n=2)
        d.sync([4, 4], [])
        d.sync([4, 4], [4])
        d.sync([4, 4], [4, 4, 4])
        assert d.propose(3) == [4, 4, 4]

    def test_propose_caps_at_k(self, drafter_cls):
        d = drafter_cls(n=1)
        d.sync([2, 2, 2, 2, 2], [])
        assert d.propose(2) == [2, 2]

    def test_max_history_freezes_the_table(self, drafter_cls):
        d = drafter_cls(n=2, max_history=6)
        d.sync([1, 2, 3, 1, 2, 3], [])
        table = dict(d._table)
        d.sync([1, 2, 3, 1, 2, 3], [7, 8, 9, 7])
        assert d._table == table            # frozen past max_history
        assert d._hist == [9, 7]            # the rolling n-token tail
        assert d.propose(2) == []           # (9, 7), 7 never indexed

    def test_rewind_rebuilds(self, drafter_cls):
        d = drafter_cls(n=2)
        d.sync([5, 6], [5, 6, 5])
        assert d.propose(1) == [6]
        d.sync([5, 6], [1])                 # shorter history: rebuilt
        assert d._hist == [5, 6, 1] and d.propose(1) == []


@pytest.mark.parametrize("seed", range(8))
def test_random_histories_propose_as_reference(seed):
    """Seeded histories over a small alphabet (so contexts repeat), grown
    in random increments with rewinds, at several n and max_history: both
    classes hold the same table and history and propose the same drafts
    after every sync."""
    rng = np.random.RandomState(seed)
    n = 1 + seed % 4
    max_history = (10, 25, 65536)[seed % 3]
    prompt = rng.randint(0, 5, rng.randint(1, 20)).tolist()
    out = rng.randint(0, 5, 60).tolist()
    ref, port = JaxNGram(n, max_history), NGramDrafter(n, max_history)
    k = 0
    for _ in range(40):
        k = max(0, k - rng.randint(1, 6)) if rng.rand() < 0.15 \
            else min(len(out), k + rng.randint(0, 4))
        for d in (ref, port):
            d.sync(prompt, out[:k])
        assert port._table == ref._table and port._hist == ref._hist
        for kk in range(7):
            assert port.propose(kk) == ref.propose(kk)


# ---------------------------------------------------------------------
# the engines over one fitted model
# ---------------------------------------------------------------------
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


class Oracle:
    """Proposes the non-speculative run's own tokens for the prompt being
    drafted (``wants``: prompt tuple -> tokens): every draft accepted."""

    def __init__(self, wants):
        self.wants = wants
        self.want, self.n = (), 0

    def sync(self, prompt_ids, output_ids):
        self.want = self.wants[tuple(int(t) for t in prompt_ids)]
        self.n = len(output_ids)

    def propose(self, k):
        return list(self.want[self.n:self.n + int(k)])


class Garbage:
    """Proposes a token the run never emits: every draft rejected."""

    def __init__(self, bad):
        self.bad = bad

    def sync(self, prompt_ids, output_ids):
        pass

    def propose(self, k):
        return [self.bad] * int(k)


class Null:
    """Proposes nothing."""

    def sync(self, prompt_ids, output_ids):
        pass

    def propose(self, k):
        return []


def _prompts(seed):
    """Four prompts: two that repeat a block (the n-gram drafter's
    traffic), two random; lengths past one chunk budget among them."""
    rng = np.random.RandomState(seed)
    block = rng.randint(0, 128, (5,)).tolist()
    return [block * 4, rng.randint(0, 128, (9,)).tolist(),
            rng.randint(0, 128, (7,)).tolist() * 3,
            rng.randint(0, 128, (30,)).tolist()]


BUDGETS = (20, 6, 14, 11)


def _serve(engine, req_cls, prompts, budgets, sp=None):
    """Three requests by ``add_request``, the fourth admitted only (its
    chunks share dispatches with verify rows), then single steps until
    every request is done."""
    reqs = [req_cls(p, m, sampling=sp and sp[i])
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    for r in reqs[:3]:
        engine.add_request(r)
    engine._admit(reqs[3])
    while not all(r.done for r in reqs):
        engine.step()
    return reqs


def _plain(tm, prompts, budgets=BUDGETS, **kw):
    """The port's non-speculative run: outputs and dispatch count."""
    e = serving.LlamaServingEngine(tm, **{**GEOM, **kw})
    reqs = _serve(e, serving.Request, prompts, budgets)
    e.close()
    return [list(r.output_ids) for r in reqs], e._dispatch_count


def _factory(kind, outs, prompts):
    if kind == "oracle":
        wants = {tuple(p): o for p, o in zip(prompts, outs)}
        return lambda: Oracle(wants)
    if kind == "garbage":
        bad = min(set(range(128)) - {t for o in outs for t in o})
        return lambda: Garbage(bad)
    if kind == "null":
        return Null
    return None                         # the engine's n-gram drafter


def _state(engine, reqs):
    """The host state both engines must agree on."""
    a, cache = engine.alloc, engine.prefix
    return (list(a._free), {k: list(v) for k, v in a._tables.items()},
            dict(a._lens), dict(a._refs), a.cow_count, a.double_free_count,
            None if cache is None else (
                cache.stats(), sorted((k, e.page, e.parent, e.children)
                                      for k, e in cache._entries.items())),
            [(r.status, list(r.output_ids), r._prefilled, r.seq_id)
             for r in reqs],
            engine.spec_stats(), sorted(engine._spec_state))


def _lockstep(fitted, prompts, spec_k, factory, sp=None, budgets=BUDGETS,
              **kw):
    """Serve ``prompts`` on both engines, one call at a time, holding
    :func:`_state` equal after every call. Returns (reference engine,
    port engine, reference requests, port requests)."""
    jm, tm = _models(fitted)
    ref = jax_serving.LlamaServingEngine(
        jm, fused_kv=False, spec_k=spec_k, drafter_factory=factory,
        sampling=sp is not None, **{**GEOM, **kw})
    port = serving.LlamaServingEngine(
        tm, spec_k=spec_k, drafter_factory=factory,
        sampling=sp is not None, **{**GEOM, **kw})
    pairs = []

    def make(engine, req_cls, params_cls):
        sps = sp and [s and params_cls(**s) for s in sp]
        reqs = [req_cls(p, m, sampling=sps and sps[i])
                for i, (p, m) in enumerate(zip(prompts, budgets))]
        pairs.append(reqs)
        return reqs

    rr = make(ref, jax_serving.Request, jax_sampling.SamplingParams)
    pr = make(port, serving.Request, SamplingParams)

    def both(fn):
        fn(ref, rr)
        fn(port, pr)
        assert _state(port, pr) == _state(ref, rr)

    for i in range(3):
        both(lambda e, rs: e.add_request(rs[i]))
    both(lambda e, rs: e._admit(rs[3]))
    while not all(r.done for r in pr):
        both(lambda e, rs: e.step())
    assert all(r.done for r in rr)
    return ref, port, rr, pr


def _consistent(engine):
    a = engine.alloc
    cached = engine.prefix.pages if engine.prefix is not None else 0
    assert a.free_pages + cached == a.num_pages
    assert not a._tables and a.double_free_count == 0


@pytest.mark.parametrize("kind", ["ngram", "oracle", "garbage"])
def test_greedy_lockstep_with_reference(fitted, kind):
    prompts = _prompts(1)
    _, tm = _models(fitted)
    outs, plain_dispatches = _plain(tm, prompts)
    ref, port, rr, pr = _lockstep(fitted, prompts, 4,
                                  _factory(kind, outs, prompts))
    got = [r.output_ids for r in pr]
    assert got == [r.output_ids for r in rr] == outs
    s = port.spec_stats()
    assert s == ref.spec_stats() and s["proposed"] > 0
    if kind == "oracle":
        assert s["accepted"] == s["proposed"]
        assert port._dispatch_count < plain_dispatches
    if kind == "garbage":
        assert s["accepted"] == 0
    assert port._spec_state == {}
    _consistent(port)
    for e in (ref, port):
        e.close()


@pytest.mark.parametrize("kind", ["ngram", "garbage"])
def test_int8_kv_lockstep_with_reference(fitted, kind):
    prompts = _prompts(2)
    _, tm = _models(fitted)
    outs, _ = _plain(tm, prompts, kv_dtype="int8")
    ref, port, rr, pr = _lockstep(fitted, prompts, 3,
                                  _factory(kind, outs, prompts),
                                  kv_dtype="int8")
    assert [r.output_ids for r in pr] == [r.output_ids for r in rr] == outs
    assert port.spec_stats()["proposed"] > 0
    _consistent(port)
    for e in (ref, port):
        e.close()


SAMPLED = ({"temperature": 0.8, "top_p": 0.9, "seed": 3},
           {"temperature": 1.0, "top_k": 5, "seed": 4}, None,
           {"logit_bias": {7: 2.5, 40: -1.0}})


@pytest.mark.parametrize("kind", ["ngram", "oracle"])
def test_sampled_lockstep_with_reference(fitted, kind):
    """Sampled, greedy and bias rows at fixed seeds under speculation:
    the port's tokens are the reference engine's (each draw keyed by
    seed and position), and the non-speculative port's."""
    prompts = _prompts(3)
    _, tm = _models(fitted)
    e0 = serving.LlamaServingEngine(tm, **GEOM)
    plain = _serve(e0, serving.Request, prompts, BUDGETS,
                   sp=[s and SamplingParams(**s) for s in SAMPLED])
    outs = [list(r.output_ids) for r in plain]
    ref, port, rr, pr = _lockstep(fitted, prompts, 3,
                                  _factory(kind, outs, prompts), sp=SAMPLED)
    assert [r.output_ids for r in pr] == [r.output_ids for r in rr] == outs
    s = port.spec_stats()
    assert s["proposed"] > 0
    if kind == "oracle":
        assert s["accepted"] == s["proposed"]
    for e in (ref, port):
        e.close()


def test_sampled_spec_equals_plain_at_fixed_seeds(fitted):
    """The reference's distribution-exactness gate (its
    ``test_distribution_exactness_spec_vs_nonspec``, the greedy case and
    the stop token inside an accepted window) on the port: a
    self-repeating prompt, so the drafter proposes."""
    _, tm = _models(fitted)
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, 128, (4,)).tolist() * 3
    e0 = serving.LlamaServingEngine(tm, **GEOM)
    e3 = serving.LlamaServingEngine(tm, spec_k=3, **GEOM)

    def run(e, sp=None, stop=(), n=12):
        r = serving.Request(prompt, max_new_tokens=n, sampling=sp, stop=stop)
        e.add_request(r)
        while not r.done:
            e.step()
        return r

    for i, (temp, top_p) in enumerate([(0.0, 1.0), (0.7, 1.0), (1.0, 0.9),
                                       (1.3, 0.8)]):
        sp = SamplingParams(temperature=temp, top_p=top_p, seed=1000 + i)
        a, b = run(e0, sp), run(e3, sp)
        assert a.output_ids == b.output_ids
        assert a.status == b.status == "completed"
    g0 = serving.LlamaServingEngine(tm, sampling=False, **GEOM)
    assert run(g0).output_ids == run(e3).output_ids
    ref = run(e0, n=10).output_ids
    r = run(e3, stop=[ref[5]], n=10)
    assert r.status == "completed"
    assert r.output_ids == ref[:ref.index(ref[5])]
    assert e3.spec_stats()["accepted"] > 0
    _consistent(e3)


# ---------------------------------------------------------------------
# cases run on both packages' engines
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(fitted):
    jm, tm = _models(fitted)
    return {"reference": (jm, jax_serving), "port": (tm, serving)}


@pytest.fixture(params=["reference", "port"])
def pkg(request, engines):
    """(model, serving module, extra engine knobs) of one package; the
    reference runs its two-op path."""
    model, mod = engines[request.param]
    kw = {"fused_kv": False} if mod is jax_serving else {}
    return model, mod, kw


def _engine(pkg, **kw):
    model, mod, extra = pkg
    return mod.LlamaServingEngine(model, **{**GEOM, **extra, **kw})


def _plain_tokens(pkg, prompt, n):
    e = _engine(pkg)
    out = e.generate([prompt], max_new_tokens=n)[0]
    e.close()
    return out


def test_max_new_tokens_and_stop_respected(pkg):
    _, mod, _ = pkg
    p = [3, 9, 27, 81]
    want = _plain_tokens(pkg, p, 5)
    e = _engine(pkg, spec_k=4,
                drafter_factory=lambda: Oracle({tuple(p): want + want}))
    r = mod.Request(p, max_new_tokens=5)
    e.add_request(r)
    while not r.done:
        e.step()
    assert r.output_ids == want and r.status == "completed"
    stop = mod.Request(p, max_new_tokens=5, stop=(want[3],))
    e.add_request(stop)
    while not stop.done:
        e.step()
    assert stop.output_ids == want[:want.index(want[3])]
    assert e.spec_stats()["accepted"] == e.spec_stats()["proposed"] > 0
    assert e._spec_state == {}
    e.close()


def test_speculation_never_starves_prefill(pkg):
    """Under full acceptance a prompt admitted mid-stream still advances
    every step: a chunk_block of budget stays reserved for it."""
    _, mod, _ = pkg
    rng = np.random.RandomState(9)
    p = rng.randint(0, 128, (4,)).tolist()
    want = _plain_tokens(pkg, p, 200)
    e = _engine(pkg, max_batch=2, max_pages_per_seq=16, prefix_cache=False,
                spec_k=7, drafter_factory=lambda: Oracle({tuple(p): want}))
    d = mod.Request(p, max_new_tokens=200)
    e.add_request(d)
    e.step()
    assert e.spec_stats()["accepted"] > 0
    long = mod.Request(rng.randint(0, 128, (40,)).tolist(), max_new_tokens=2)
    e._admit(long)
    steps = 0
    while long._prefilled < len(long.prompt_ids):
        before = long._prefilled
        e.step()
        steps += 1
        assert long._prefilled > before
        assert steps < 50
    e.close()


def test_spec_state_dropped_on_retire_and_evict(pkg):
    _, mod, _ = pkg
    e = _engine(pkg, spec_k=2)
    r = mod.Request([1, 2, 3, 1, 2, 3], max_new_tokens=4)
    e.add_request(r)
    e.step()
    assert r.seq_id in e._spec_state
    while not r.done:
        e.step()
    assert e._spec_state == {}
    v = mod.Request([4, 5, 4, 5, 4], max_new_tokens=50, retry_budget=1)
    e.add_request(v)
    e.step()
    sid = v.seq_id
    assert sid in e._spec_state
    e._evict(v)
    assert v.status == "requeued" and sid not in e._spec_state
    e.close()


def test_constrained_never_drafts_and_out_of_vocab_stops(pkg):
    _, mod, _ = pkg
    model = pkg[0]
    v = model.config.vocab_size

    class Odd:
        def sync(self, prompt_ids, output_ids):
            pass

        def propose(self, k):
            return [5, 6, v + 3, 7][:k]

    e = _engine(pkg, spec_k=4, drafter_factory=Odd)
    r = mod.Request([1, 2, 3], max_new_tokens=8)
    e.add_request(r)
    assert e._draft(r, 4) == (5, 6)
    params = jax_sampling.SamplingParams if mod is jax_serving \
        else SamplingParams
    c = mod.Request([1, 2, 3], max_new_tokens=8, sampling=params(
        constraint=lambda p, o: [3, 17]))
    e.add_request(c)
    assert e._draft(c, 4) == ()
    e.close()


class TestSpecLifecycle:
    def test_cancel_mid_speculation_releases_pages(self, pkg):
        _, mod, _ = pkg
        e = _engine(pkg, spec_k=3, prefix_cache=False,
                    drafter_factory=lambda: Garbage(1))
        free0 = e.alloc.free_pages
        r = mod.Request([1, 2, 3, 4] * 3, max_new_tokens=10000)
        e.add_request(r)
        for _ in range(3):
            e.step()
        assert e.spec_stats()["proposed"] > 0
        assert e.cancel(r) is True
        assert r.status == "cancelled"
        assert e.alloc.free_pages == free0
        p = [5, 6, 7]
        assert e.generate([p], max_new_tokens=4)[0] \
            == _plain_tokens(pkg, p, 4)
        e.close()

    def test_deadline_mid_speculation_typed_and_released(self, pkg):
        _, mod, _ = pkg
        e = _engine(pkg, spec_k=3, prefix_cache=False)
        free0 = e.alloc.free_pages
        r = mod.Request([1, 2, 3] * 3, max_new_tokens=10000, deadline=0.03)
        e.add_request(r)
        t0 = time.perf_counter()
        while not r.done and time.perf_counter() - t0 < 10.0:
            e.step()
            time.sleep(0.005)
        assert r.done and r.status == "deadline_exceeded"
        assert isinstance(r.error, mod.DeadlineExceeded)
        assert e.alloc.free_pages == free0
        e.close()

    def test_pressure_evict_during_speculation_recovers(self, pkg):
        _, mod, _ = pkg
        e = _engine(pkg, max_batch=2, num_pages=8, chunk_block=4,
                    chunk_budget=8, spec_k=3, prefix_cache=False)
        free0 = e.alloc.free_pages
        r1 = mod.Request([1, 2, 3], max_new_tokens=10000)
        r2 = mod.Request([4, 5], max_new_tokens=10000)
        e.add_request(r1)
        e.add_request(r2)
        for _ in range(400):
            if r1.done and r2.done:
                break
            e.step()
        assert r1.done and r2.done
        for r in (r1, r2):
            assert r.status in ("completed", "evicted"), r.status
        assert e.alloc.free_pages == free0
        assert e.alloc.double_free_count == 0
        e.close()


@pytest.mark.parametrize("how", ["cancel", "evict"])
def test_retired_inside_the_dispatch_is_released_once(fitted, how):
    """A cancel or an eviction that lands while a verify dispatch is in
    flight (here from inside the forward, as another thread's would) is
    released after the read-back, once; its rejected drafts are never
    rolled back over the released table."""
    _, tm = _models(fitted)
    e = serving.LlamaServingEngine(tm, spec_k=3, prefix_cache=False,
                                   drafter_factory=lambda: Garbage(1),
                                   **GEOM)
    r = serving.Request([9, 8, 7], max_new_tokens=50, retry_budget=1)
    e.add_request(r)
    forward = e._mixed_forward
    hits = []

    def mid(*a, **k):
        if a[-2] > 1 and not hits:          # a verify dispatch (qb > 1)
            hits.append(r.seq_id)
            e.cancel(r) if how == "cancel" else e._evict(r)
            assert e.alloc._tables.get(hits[0])  # deferred, still owned
        return forward(*a, **k)

    e._mixed_forward = mid
    while not hits:
        e.step()
    assert r.status == ("cancelled" if how == "cancel" else "requeued")
    assert hits[0] not in e.alloc._tables
    assert e.alloc.free_pages == e.alloc.num_pages
    assert e.alloc.double_free_count == 0
    if how == "evict":
        while not r.done:
            e.step()
        assert r.status == "completed" and len(r.output_ids) == 50
    e.close()


PATHS = {"rope-fused": {}, "fused-kv": {"fused_rope": False},
         "two-op": {"fused_kv": False}}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_three_paths_bitwise_after_rollback(fitted, kv_dtype):
    """Every verify row rolled back (garbage drafts): tokens, pools,
    sidecars and spec_stats bit for bit equal across the port's three
    attention paths."""
    prompts = _prompts(4)
    _, tm = _models(fitted)
    outs, _ = _plain(tm, prompts, kv_dtype=kv_dtype)
    got = {}
    for name, kw in PATHS.items():
        e = serving.LlamaServingEngine(
            tm, spec_k=3, kv_dtype=kv_dtype,
            drafter_factory=_factory("garbage", outs, prompts),
            **kw, **GEOM)
        reqs = _serve(e, serving.Request, prompts, BUDGETS)
        got[name] = ([r.output_ids for r in reqs], e.spec_stats(),
                     [p.clone() for p in e.k_pools + e.v_pools
                      + e.k_scales + e.v_scales])
        assert got[name][1]["proposed"] > 0
        assert got[name][1]["accepted"] == 0
        e.close()
    base = got["rope-fused"]
    assert base[0] == outs
    for name in ("fused-kv", "two-op"):
        assert got[name][:2] == base[:2]
        assert all(torch.equal(a, b) for a, b in zip(got[name][2], base[2]))


def _record(engine):
    """Each scan's size and each single mixed step (1) of ``engine`` from
    now on."""
    calls = []
    scan, step = engine._decode_scan, engine._mixed_step

    def rec_scan(n):
        calls.append(n)
        return scan(n)

    def rec_step():
        calls.append(1)
        return step()
    engine._decode_scan, engine._mixed_step = rec_scan, rec_step
    return calls


@pytest.mark.parametrize("kind", ["ngram", "null"])
@pytest.mark.parametrize("n,exact", [(16, True), (37, False)])
def test_decode_many_chunks_match_reference(fitted, kind, n, exact):
    """``decode_many(n, exact)`` on a speculative engine: the sequence of
    scans and single steps, the tokens and spec_stats equal the
    reference's; with nothing proposed, a short scan comes first and full
    scans follow after two empty probes."""
    prompts = _prompts(5)
    budgets = (40, 7, 25, 12)
    jm, tm = _models(fitted)
    factory = Null if kind == "null" else None
    got = []
    for mod, model, kw in ((jax_serving, jm, {"fused_kv": False}),
                           (serving, tm, {})):
        e = mod.LlamaServingEngine(model, spec_k=3, drafter_factory=factory,
                                   prefix_cache=False, **kw, **GEOM)
        reqs = [mod.Request(p, m) for p, m in zip(prompts, budgets)]
        for r in reqs[:3]:
            e.add_request(r)
        e._admit(reqs[3])
        calls = _record(e)
        e.decode_many(n, exact=exact)
        got.append((calls, [list(r.output_ids) for r in reqs],
                    e.spec_stats(), e._spec_idle))
        e.close()
    assert got[1] == got[0]
    calls = got[1][0]
    if kind == "null" and n == 37:
        assert [c for c in calls if c > 1][:2] == [4, 16]
    if kind == "ngram":
        assert got[1][2]["proposed"] > 0


def test_spec_k_capped_and_env_read_as_reference(fitted, monkeypatch):
    jm, tm = _models(fitted)
    for kw in ({"spec_k": 99}, {"spec_k": 3}, {"spec_k": 0}):
        je = jax_serving.LlamaServingEngine(jm, sampling=False, **kw, **GEOM)
        te = serving.LlamaServingEngine(tm, **kw, **GEOM)
        assert te.spec_k == je.spec_k
        je.close()
    assert te.spec_stats() == {"k": 0, "proposed": 0, "accepted": 0,
                               "accept_rate": 0.0}
    monkeypatch.setenv("PADDLE_TPU_SPEC_K", "5")
    assert serving.LlamaServingEngine(tm, **GEOM).spec_k == 5
    assert serving.LlamaServingEngine(tm, spec_k=2, **GEOM).spec_k == 2
