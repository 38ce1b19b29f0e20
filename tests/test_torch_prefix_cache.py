"""The port's shared-prefix KV cache (``inference/prefix_cache.py``), the
allocator's refcounts and copy-on-write, and the engine's prefix reuse,
against the reference (mirrors ``tests/test_prefix_cache.py``).

The allocator and cache cases run on both packages' classes, and the
chain keys must be the reference's byte for byte. The engine cases run
the reference engine (its two-op path, ``fused_kv=False``: the fused
reference engine is not a trusted oracle on the CPU) and the port's engine
over the same fitted tiny model (``fit_on_prompts``: a random-init
model's logits are near-ties) and hold the host state equal after every
driving call: page tables, lengths, refcounts, the free list in order,
the copy-on-write and double-free counts, the cache's stats and entries,
every request's status, output and prefill cursor. They run in float and
int8 KV, on the port's three attention paths, driven by single steps and
by ``decode_many`` scans. Phase 14a of ``chip_smoke.py`` (the ladder under
decode pressure with the cache giving its pages back first) and phase 14c
(the same with the host KV tier on) run here at tiny width on both engines
and must give the values the card is held to.
"""

import fcntl
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jax_sampling
from paddle_tpu.inference.paged_cache import PageAllocator as JaxAllocator
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.prefix_cache import cacheable_pages as jax_cacheable
from paddle_tpu.inference.prefix_cache import chain_keys as jax_chain_keys
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.inference.paged_cache import PageAllocator
from paddle_tpu_torch.inference.prefix_cache import (PrefixCache,
                                                     cacheable_pages,
                                                     chain_keys)
from paddle_tpu_torch.inference.serving import (AdmissionError,
                                                LlamaServingEngine, Request)
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = {"reference": (JaxAllocator, JaxPrefixCache),
        "port": (PageAllocator, PrefixCache)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """(PageAllocator, PrefixCache) of each package."""
    return PKGS[request.param]


# ---------------------------------------------------------------------
# allocator refcounts + copy-on-write
# ---------------------------------------------------------------------
class TestRefcounts:
    def test_shared_admit_increfs(self, pkg):
        alloc = pkg[0](8, 4)
        t1 = alloc.admit(1, 8)
        assert all(alloc.page_ref(p) == 1 for p in t1)
        alloc.incref(t1[0])                 # a cache pin
        assert alloc.page_ref(t1[0]) == 2
        t2 = alloc.admit(2, 8, shared_pages=[t1[0]])
        assert t2[0] == t1[0] and alloc.page_ref(t1[0]) == 3
        assert t2[1] != t1[1]               # private tail page

    def test_shared_admit_rejects_free_page(self, pkg):
        alloc = pkg[0](4, 4)
        t = alloc.admit(1, 4)
        alloc.release(1)
        with pytest.raises(ValueError):
            alloc.admit(2, 4, shared_pages=[t[0]])

    def test_release_ordering_shared_page_survives(self, pkg):
        alloc = pkg[0](8, 4)
        t1 = alloc.admit(1, 4)
        alloc.incref(t1[0])
        t2 = alloc.admit(2, 4, shared_pages=[t1[0]])
        assert t2 == [t1[0]]
        alloc.release(1)
        assert alloc.page_ref(t1[0]) == 2   # seq 2 + cache
        assert t1[0] not in alloc._free_set
        alloc.release(2)
        assert alloc.page_ref(t1[0]) == 1   # cache only
        assert alloc.free_pages == 7
        assert alloc.decref(t1[0]) is True  # last ref frees
        assert alloc.free_pages == 8
        assert alloc.double_free_count == 0

    def test_double_admit_against_shared_page(self, pkg):
        alloc = pkg[0](8, 4)
        t = alloc.admit(1, 4)
        alloc.incref(t[0])
        alloc.admit(2, 4, shared_pages=[t[0]])
        alloc.admit(3, 4, shared_pages=[t[0]])
        assert alloc.page_ref(t[0]) == 4
        for s in (3, 1, 2):
            alloc.release(s)
        assert alloc.page_ref(t[0]) == 1
        assert alloc.free_pages == 7
        assert alloc.double_free_count == 0

    def test_cow_on_write_into_shared_page(self, pkg):
        alloc = pkg[0](8, 4)
        t1 = alloc.admit(1, 4)
        alloc.incref(t1[0])                 # ref 2: shared
        alloc.admit(2, 2, shared_pages=[t1[0]])
        alloc.extend(2, 1)                  # pos 2, inside the shared page
        old, new = alloc.ensure_writable(2, 2)
        assert old == t1[0] and new != old
        assert alloc._tables[2][0] == new
        assert alloc.page_ref(old) == 2     # seq 1 + cache
        assert alloc.page_ref(new) == 1
        assert alloc.cow_count == 1
        assert alloc.ensure_writable(2, 2) is None   # private now
        assert alloc.cow_count == 1

    def test_cow_exhausted_pool_raises(self, pkg):
        alloc = pkg[0](2, 4)
        t1 = alloc.admit(1, 4)
        alloc.incref(t1[0])
        alloc.admit(2, 2, shared_pages=[t1[0]])
        alloc.admit(3, 4)                   # drains the free list
        with pytest.raises(MemoryError):
            alloc.ensure_writable(2, 1)

    def test_idempotent_release_contract_with_refcounts(self, pkg):
        alloc = pkg[0](8, 4)
        t = alloc.admit(1, 4)
        alloc.incref(t[0])
        alloc.admit(2, 4, shared_pages=[t[0]])
        alloc.release(2)
        with pytest.warns(RuntimeWarning):
            alloc.release(2)                # unknown now: counted no-op
        assert alloc.double_free_count == 1
        assert alloc.page_ref(t[0]) == 2
        alloc.release(1)
        assert alloc.decref(t[0]) is True
        with pytest.warns(RuntimeWarning):
            assert alloc.decref(t[0]) is False
        assert alloc.double_free_count == 2
        assert alloc.free_pages == 8


# ---------------------------------------------------------------------
# PrefixCache bookkeeping (no model)
# ---------------------------------------------------------------------
class TestPrefixCache:
    def test_match_insert_full_pages_only(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        prompt = list(range(10))            # 2 full pages + 2 tokens
        table = alloc.admit(1, 10)
        assert cache.insert(prompt, table) == 2
        pages, n = cache.match(prompt)
        assert n == 8 and pages == table[:2]
        pages, n = cache.match(prompt[:4] + [99, 98, 97, 96, 1, 2])
        assert n == 4 and pages == [table[0]]
        assert cache.match([7] * 10) == ([], 0)

    def test_exact_multiple_prompt_never_fully_covered(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        prompt = list(range(8))             # exactly 2 pages
        table = alloc.admit(1, 8)
        assert cache.insert(prompt, table) == 1   # page 0 only
        pages, n = cache.match(prompt)
        assert n == 4 and pages == [table[0]]

    def test_insert_pins_pages_past_release(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        prompt = list(range(13))            # 3 full pages cacheable
        table = alloc.admit(1, 13)
        cache.insert(prompt, table)
        alloc.release(1)
        assert alloc.free_pages == 32 - 3   # pinned by the cache
        pages, n = cache.match(prompt)
        assert n == 12 and pages == table[:3]

    def test_eviction_removes_chain_tails_first(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        prompt = list(range(13))
        table = alloc.admit(1, 13)
        cache.insert(prompt, table)
        alloc.release(1)
        assert cache.evict_pages(1) == 1    # the tail page frees
        pages, n = cache.match(prompt)
        assert n == 8 and pages == table[:2]
        assert cache.clear() == 2
        assert alloc.free_pages == 32
        assert cache.match(prompt) == ([], 0)

    def test_eviction_of_page_shared_with_live_seq_does_not_free(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        prompt = list(range(9))             # 2 full pages cacheable
        table = alloc.admit(1, 9)
        cache.insert(prompt, table)
        alloc.admit(2, 9, shared_pages=table[:2])
        alloc.release(1)
        free0 = alloc.free_pages
        assert cache.clear() == 0           # unpinned, but seq 2 holds
        assert alloc.free_pages == free0
        alloc.release(2)
        assert alloc.free_pages == 32

    def test_max_pages_cap_evicts_lru(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4, max_pages=2)
        t1 = alloc.admit(1, 9)
        cache.insert(list(range(9)), t1)            # 2 pages
        t2 = alloc.admit(2, 9)
        cache.insert([50 + i for i in range(9)], t2)
        assert cache.pages == 2             # capped, LRU chain evicted

    def test_stats(self, pkg):
        alloc = pkg[0](32, 4)
        cache = pkg[1](alloc, 4)
        table = alloc.admit(1, 9)
        cache.insert(list(range(9)), table)
        cache.match(list(range(9)))
        cache.match([99] * 9)
        s = cache.stats()
        assert s["hits"] == 1 and s["lookups"] == 2
        assert s["hit_rate"] == 0.5 and s["saved_tokens"] == 8


@pytest.mark.parametrize("n,page", [(1, 4), (8, 4), (13, 4), (100, 16),
                                    (513, 16)])
def test_chain_keys_are_the_reference_s(n, page):
    """Byte for byte the reference's keys (a router hashing prompts for
    either package scores the same prefixes), and the same cacheable page
    counts, limits and explicit page counts."""
    ids = np.random.RandomState(n).randint(0, 128256, n).tolist()
    assert chain_keys(ids, page) == jax_chain_keys(ids, page)
    assert cacheable_pages(n, page) == jax_cacheable(n, page)
    assert chain_keys(ids, page, limit=2) == jax_chain_keys(ids, page,
                                                            limit=2)
    assert chain_keys(ids, page, n_pages=n // page) \
        == jax_chain_keys(ids, page, n_pages=n // page)


def test_cache_state_is_the_reference_s_through_a_workload():
    """The same inserts, matches, pins and evictions on both packages'
    allocator + cache: the same entries, LRU order (hot keys), stats,
    refcounts and free list after each operation."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 50, n).tolist() for n in (9, 17, 25, 13)]
    prompts += [prompts[1][:8] + [1, 2, 3, 4, 5], prompts[2][:16] + [7] * 9]
    states = []
    for alloc_cls, cache_cls in (PKGS["reference"], PKGS["port"]):
        alloc = alloc_cls(40, 4)
        cache = cache_cls(alloc, 4, max_pages=9)
        seen = []
        for sid, p in enumerate(prompts):
            shared, _ = cache.match(p)
            alloc.admit(sid, len(p), shared_pages=shared)
            cache.insert(p, alloc._tables[sid])
            if sid % 2:
                alloc.release(sid - 1)
            seen.append((cache.stats(), cache.hot_keys(5), dict(alloc._refs),
                         list(alloc._free)))
        cache.evict_pages(3)
        seen.append((cache.stats(), cache.hot_keys(20), list(alloc._free)))
        states.append(seen)
    assert states[0] == states[1]


# ---------------------------------------------------------------------
# engine-level shared-prefix reuse, both engines in lockstep
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


# KV dtype, the port's attention path, how both engines are driven
CONFIGS = {
    "float rope-fused step": (None, {}, "step"),
    "float rope-fused scan": (None, {}, "scan"),
    "float fused-kv scan": (None, {"fused_rope": False}, "scan"),
    "float two-op scan": (None, {"fused_kv": False}, "scan"),
    "int8 rope-fused step": ("int8", {}, "step"),
    "int8 rope-fused scan": ("int8", {}, "scan"),
    "int8 fused-kv scan": ("int8", {"fused_rope": False}, "scan"),
    "int8 two-op scan": ("int8", {"fused_kv": False}, "scan"),
}


def _state(engine, reqs):
    """The host state both engines must agree on."""
    a, cache = engine.alloc, engine.prefix
    return (list(a._free), {k: list(v) for k, v in a._tables.items()},
            dict(a._lens), dict(a._refs), a.cow_count, a.double_free_count,
            None if cache is None else (
                cache.stats(), sorted((k, e.page, e.parent, e.children)
                                      for k, e in cache._entries.items())),
            [(r.status, list(r.output_ids), r._cached_tokens, r._prefilled,
              r.trimmed, r.seq_id) for r in reqs],
            len(engine._live), len(engine._requeue))


class Pair:
    """The reference engine and the port's, the same geometry and
    weights, driven in lockstep; every request a (reference, port)
    pair."""

    def __init__(self, fitted, config, sampling=False, **geom):
        kv_dtype, path, self.drive = CONFIGS[config]
        jm, tm = _models(fitted)
        self.ref = JaxEngine(jm, fused_kv=False, sampling=sampling,
                             kv_dtype=kv_dtype, **geom)
        self.port = LlamaServingEngine(tm, kv_dtype=kv_dtype,
                                       sampling=sampling, **path, **geom)
        self.reqs = []

    def request(self, prompt, sp=None, **kw):
        """A request on each engine; ``sp``: SamplingParams fields."""
        pair = (JaxRequest(prompt, sampling=sp and jax_sampling
                           .SamplingParams(**sp), **kw),
                Request(prompt, sampling=sp and SamplingParams(**sp), **kw))
        self.reqs.append(pair)
        return pair

    def check(self):
        assert _state(self.port, [p for _, p in self.reqs]) \
            == _state(self.ref, [r for r, _ in self.reqs])

    def both(self, fn):
        """``fn(engine, request_of_that_engine_by_index)`` on both."""
        for k, e in enumerate((self.ref, self.port)):
            fn(e, lambda i: self.reqs[i][k])
        self.check()

    def add(self, pair):
        self.both(lambda e, _: e.add_request(pair[e is self.port]))

    def advance(self):
        if self.drive == "step":
            self.both(lambda e, _: e.step())
        else:
            self.both(lambda e, _: e.decode_many(4))

    def run(self, *pairs):
        while not all(p[1].done for p in pairs):
            self.advance()
        assert all(r.done for r, _ in pairs)

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture(params=sorted(CONFIGS))
def config(request):
    return request.param


class TestEngineSharedPrefix:
    def test_cached_prefix_is_token_exact(self, fitted, config):
        """Two prompts sharing a page-aligned 16-token prefix: the second
        admits against the first's cached pages (hit counted, prefill
        skipped) and its tokens are the reference's."""
        rng = np.random.RandomState(11)
        prefix = rng.randint(0, 128, (16,)).tolist()   # 2 full pages @ 8
        pair = Pair(fitted, config, max_batch=4, page_size=8, num_pages=32)
        r1 = pair.request(prefix + rng.randint(0, 128, (3,)).tolist(),
                          max_new_tokens=5)
        pair.add(r1)
        pair.run(r1)
        assert r1[1]._cached_tokens == 0 and pair.port.prefix.pages == 2
        r2 = pair.request(prefix + rng.randint(0, 128, (4,)).tolist(),
                          max_new_tokens=5)
        pair.add(r2)
        assert r2[1]._cached_tokens == 16
        pair.run(r2)
        s = pair.port.prefix.stats()
        assert s["hits"] >= 1 and s["saved_tokens"] >= 16
        # invalidation returns every cached page; nothing leaks
        pair.both(lambda e, _: e.prefix.clear())
        for e in (pair.ref, pair.port):
            assert e.alloc.free_pages == e.alloc.num_pages
            assert e.alloc.cow_count == 0   # page-aligned: no COW
        pair.close()

    def test_sampled_warm_tokens_are_the_reference_s(self, fitted, config):
        """Seeded sampled requests, cold and then warm on the cached
        prefix (one of them greedy): each engine's tokens equal the
        other's (draws keyed by seed and position, not by what else a
        dispatch holds)."""
        rng = np.random.RandomState(15)
        prefix = rng.randint(0, 128, (16,)).tolist()
        pair = Pair(fitted, config, sampling=True, max_batch=4, page_size=8,
                    num_pages=48)
        sps = ({"temperature": 0.8, "top_p": 0.9, "seed": 3},
               {"temperature": 1.0, "top_k": 5, "seed": 4}, None)
        cold = pair.request(prefix + rng.randint(0, 128, (3,)).tolist(),
                            sp=sps[0], max_new_tokens=6)
        pair.add(cold)
        pair.run(cold)
        warm = [pair.request(prefix + rng.randint(0, 128, (2 + i,)).tolist(),
                             sp=sp, max_new_tokens=6)
                for i, sp in enumerate(sps)]
        for r in warm:
            pair.add(r)
        assert [p._cached_tokens for _, p in warm] == [16, 16, 16]
        pair.run(*warm)
        assert len({tuple(p.output_ids) for _, p in warm + [cold]}) == 4
        pair.close()

    def test_three_way_share_and_release_ordering(self, fitted, config):
        rng = np.random.RandomState(12)
        prefix = rng.randint(0, 128, (16,)).tolist()
        pair = Pair(fitted, config, max_batch=4, page_size=8, num_pages=48)
        reqs = [pair.request(prefix + rng.randint(0, 128, (2 + i,)).tolist(),
                             max_new_tokens=8 + i) for i in range(3)]
        for r in reqs:
            pair.add(r)
        assert [p._cached_tokens for _, p in reqs] == [0, 16, 16]
        port = pair.port
        shared = port.alloc._tables[reqs[1][1].seq_id][:2]
        assert port.alloc._tables[reqs[2][1].seq_id][:2] == shared
        assert all(port.alloc.page_ref(p) == 4 for p in shared)
        pair.run(*reqs)
        assert all(port.alloc.page_ref(p) == 1 for p in shared)
        pair.both(lambda e, _: e.prefix.clear())
        assert port.alloc.free_pages == port.alloc.num_pages
        pair.close()

    def test_pool_pressure_evicts_cache_before_shedding(self, fitted, config):
        """An admission that would exhaust the pool reclaims cold cache
        pages and succeeds instead of raising AdmissionError."""
        rng = np.random.RandomState(13)
        pair = Pair(fitted, config, max_batch=2, page_size=8,
                    num_pages=16)   # 15 usable pages
        r1 = pair.request(rng.randint(0, 128, (17,)).tolist(),
                          max_new_tokens=2)
        pair.add(r1)
        pair.run(r1)
        assert pair.port.prefix.pages == 2
        assert pair.port.alloc.free_pages == 13
        # 105 tokens need 14 pages; 13 are free: a pinned page goes back
        big = pair.request(rng.randint(0, 128, (105,)).tolist(),
                           max_new_tokens=2)
        pair.add(big)                       # must NOT raise
        pair.run(big)
        assert big[1].status == "completed"
        port = pair.port
        assert port.alloc.free_pages + port.prefix.pages \
            == port.alloc.num_pages
        pair.close()

    def test_decode_pressure_reclaims_cache_before_evicting_live(
            self, fitted, config):
        """A live sequence needs a page from a dry pool: cold cache pages
        are reclaimed before any live request is evicted or trimmed."""
        rng = np.random.RandomState(14)
        pair = Pair(fitted, config, max_batch=2, page_size=8, num_pages=16)
        r1 = pair.request(rng.randint(0, 128, (17,)).tolist(),
                          max_new_tokens=2)
        pair.add(r1)
        pair.run(r1)
        assert pair.port.prefix.pages == 2
        assert pair.port.alloc.free_pages == 13
        # 104 tokens = exactly 13 pages: the first decode extend needs a
        # 14th page from a dry pool
        big = pair.request(rng.randint(0, 128, (104,)).tolist(),
                           max_new_tokens=3)
        pair.add(big)
        pair.run(big)
        assert big[1].status == "completed" and not big[1].trimmed
        assert len(big[1].output_ids) == 3  # never evicted or restarted
        assert pair.port.prefix.evictions >= 1
        pair.close()

    def test_requeued_request_rematches_prefix(self, fitted, config):
        """An evicted and requeued request re-matches at re-admission (its
        _cached_tokens reset with its cleared output)."""
        pair = Pair(fitted, config, max_batch=2, page_size=8, num_pages=32)
        r = pair.request([1] * 20, max_new_tokens=4)

        def evict(e, req):
            rq = req(0)
            rq._cached_tokens = 16
            rq.seq_id = 7
            e.alloc.admit(7, 20)
            e._live[7] = rq
            rq.status = "live"
            e._evict(rq)
        pair.both(evict)
        assert r[1].status == "requeued" and r[1]._cached_tokens == 0
        assert r[1] in pair.port._requeue
        pair.close()


# ---------------------------------------------------------------------
# copy-on-write through the engine
# ---------------------------------------------------------------------
@pytest.mark.parametrize("where", ["prefill", "step", "scan"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_copy_on_write_matches_reference(fitted, kv_dtype, where):
    """A write into a shared page copies it first: a prompt chunk that
    starts inside a cached page (``prefill``), a decode row (``step``)
    and a scan's first write (``scan``) into a page the test pins with a
    second reference. Both engines copy the same page at the same point
    (host state equal after every call) and serve the same tokens."""
    config = f"{'int8' if kv_dtype else 'float'} rope-fused " \
        f"{'scan' if where == 'scan' else 'step'}"
    rng = np.random.RandomState(21)
    prefix = rng.randint(0, 128, (16,)).tolist()
    pair = Pair(fitted, config, max_batch=4, page_size=8, num_pages=32)
    r1 = pair.request(prefix + rng.randint(0, 128, (3,)).tolist(),
                      max_new_tokens=4)
    pair.add(r1)
    pair.run(r1)
    r2 = pair.request(prefix + rng.randint(0, 128, (5,)).tolist(),
                      max_new_tokens=6)
    pinned = []
    if where == "prefill":
        def admit_mid_page(e, req):
            e._admit(req(1))
            req(1)._prefilled = 12          # the chunk starts in page 1
        pair.both(admit_mid_page)
    else:
        pair.add(r2)

        def pin_last_page(e, req):
            page = e.alloc._tables[req(1).seq_id][-1]
            e.alloc.incref(page)
            pinned.append((e, page))
        pair.both(pin_last_page)
    pair.advance()
    assert pair.port.alloc.cow_count == pair.ref.alloc.cow_count == 1
    for e, page in pinned:
        e.alloc.decref(page)
    pair.check()
    pair.run(r2)
    pair.both(lambda e, _: e.prefix.clear())
    assert pair.port.alloc.free_pages == pair.port.alloc.num_pages
    pair.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_copy_page_writes_the_pools_in_place(fitted, kv_dtype):
    """``_copy_page`` copies a page's K/V in every layer (and its scale
    sidecars) bit for bit into the new page, in place: every pool and
    sidecar keeps its address, which the tick graphs baked; the old page
    is untouched, also after a tick writes the new one."""
    _, tm = _models(fitted)
    te = LlamaServingEngine(tm, kv_dtype=kv_dtype, max_batch=4, page_size=8,
                            num_pages=32)
    rng = np.random.RandomState(22)
    prefix = rng.randint(0, 128, (16,)).tolist()
    r1 = Request(prefix + [5, 6, 7], max_new_tokens=3)
    te.add_request(r1)
    while not r1.done:
        te.step()
    r2 = Request(prefix + [(prefix[12] + 1) % 128], max_new_tokens=3)
    te._admit(r2)
    assert r2._cached_tokens == 16
    pools = te.k_pools + te.v_pools + te.k_scales + te.v_scales
    assert len(pools) == (8 if kv_dtype else 4)
    ptrs = [t.data_ptr() for t in pools]
    old, new = te.alloc.ensure_writable(r2.seq_id, 12)
    before = [t[old].clone() for t in pools]
    te._copy_page(old, new)
    now = te.k_pools + te.v_pools + te.k_scales + te.v_scales
    assert [t.data_ptr() for t in now] == ptrs
    assert all(torch.equal(t[new], t[old]) for t in pools)
    te._load_scan([r2], [12], "greedy", *te._scan_rows([r2]))
    te._run_tick("greedy")
    assert all(torch.equal(t[old], b) for t, b in zip(pools, before))
    assert not torch.equal(te.k_pools[0][new], te.k_pools[0][old])
    assert [t.data_ptr() for t in pools] == ptrs
    te.cancel(r2)
    te.prefix.clear()
    assert te.alloc.free_pages == te.alloc.num_pages


# ---------------------------------------------------------------------
# chip_smoke phase 14a's schedule at tiny width
# ---------------------------------------------------------------------
def _pair_result(tmp_path_factory, key, side, result):
    """Record one engine's result of the cross-engine pair ``key`` in the
    session's shared temporary directory (every xdist worker's base
    directory sits under it) and return the other engine's, or None when
    it has not run yet: the case that runs second compares, so the two
    engines' cases may run on different workers at once."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"pair-{key}.json"
    with open(root / f"pair-{key}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        doc = json.loads(path.read_text()) if path.exists() else {}
        doc[side] = result
        path.write_text(json.dumps(doc))
    return doc.get("port" if side == "reference" else "reference")


def _schedule_engine(side, kv_tier=False):
    """Phase 14a's engine of one package over a random-init f32 tiny model
    with 512 positions (the same weights on both sides), and its request
    class."""
    import chip_smoke as cs
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(max_position_embeddings=512))
    jm.eval()
    if side == "reference":
        return JaxEngine(jm, fused_kv=False, sampling=False, max_batch=8,
                         page_size=16, num_pages=cs.PRESSURE_POOL,
                         kv_tier=kv_tier), JaxRequest
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = load_numpy_state(LlamaForCausalLM(
        tiny_llama_config(max_position_embeddings=512), device="cpu"),
        arrays).eval()
    return LlamaServingEngine(tm, max_batch=8, page_size=16,
                              num_pages=cs.PRESSURE_POOL,
                              kv_tier=kv_tier), Request


@pytest.mark.parametrize("side", ["reference", "port"])
def test_pressure_schedule_gives_the_card_s_values(side, tmp_path_factory):
    """Phase 14a (151 usable pages, a completed 256-token request cached,
    8 prompts of 256 tokens, 128 new each, priorities 0-3, one retry
    budget of 0) on each engine at tiny width: the cache gives its 15
    pages back before any live eviction, and the evictions,
    re-admissions, statuses and output lengths are the values
    ``chip_smoke.py`` holds the card to (page arithmetic: width does not
    enter). One case an engine, so the two run on two workers; the tokens
    and cache stats of the two are equal (a random-init f32 model),
    compared by the case that runs second."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    other, prompts = cs.pressure_prompts(128)
    e, req_cls = _schedule_engine(side)
    e.generate([prompts[0][:16]], max_new_tokens=2)    # the warm-up's
    reqs, events, cached, cache_ev = cs.pressure_schedule(
        e, req_cls, other, prompts)
    end = tuple((r.status, len(r.output_ids)) for r in reqs)
    assert cached == 15 and cache_ev >= cached
    assert events == cs.PRESSURE_EVENTS and end == cs.PRESSURE_END
    assert all((r.status == "evicted") == isinstance(r.error, MemoryError)
               for r in reqs)
    assert e.alloc.free_pages + e.prefix.pages == e.alloc.num_pages
    assert not e.alloc._tables and not e._live
    if side == "port":
        assert isinstance(reqs[1].error, AdmissionError)
    mine = [[r.output_ids for r in reqs], e.prefix.stats()]
    e.close()
    theirs = _pair_result(tmp_path_factory, "pressure", side, mine)
    assert theirs is None or theirs == json.loads(json.dumps(mine))


@pytest.mark.parametrize("side", ["reference", "port"])
def test_pause_schedule_gives_the_card_s_values(side, tmp_path_factory):
    """Phase 14c: phase 14a's schedule with the host tier on, its cap
    ``PAUSE_TIER_PAGES`` pages of each engine's KV bytes, on each engine
    at tiny width: the pauses, the pause the tier could not hold, the
    resume and the re-admission in order, and every request's status and
    output length are the values ``chip_smoke.py`` holds the card to (a
    cap in pages: width does not enter); no paused copy left, the
    allocator consistent. One case an engine, as the pressure schedule's:
    the tokens, cache stats and tier stats of the two are equal, compared
    by the case that runs second."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    other, prompts = cs.pressure_prompts(128)
    e, req_cls = _schedule_engine(side, kv_tier=True)
    e.tier.max_bytes = cs.PAUSE_TIER_PAGES * e.page_size \
        * e.kv_bytes_per_token
    e.generate([prompts[0][:16]], max_new_tokens=2)    # the warm-up's
    reqs, events, cached, cache_ev = cs.pressure_schedule(
        e, req_cls, other, prompts)
    end = tuple((r.status, len(r.output_ids)) for r in reqs)
    assert cached == 15 and cache_ev >= cached
    assert events == cs.PAUSE_EVENTS and end == cs.PAUSE_END
    st = e.tier.stats()
    assert st["seqs"] == 0 and st["capacity_rejections"] >= 1
    assert e.alloc.free_pages + e.prefix.pages == e.alloc.num_pages
    assert not e.alloc._tables and not e._live
    assert e.alloc.double_free_count == 0
    mine = [[r.output_ids for r in reqs], e.prefix.stats(), st]
    e.close()
    theirs = _pair_result(tmp_path_factory, "pause", side, mine)
    assert theirs is None or theirs == json.loads(json.dumps(mine))
