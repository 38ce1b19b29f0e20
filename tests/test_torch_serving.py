"""The port's serving engine against the reference engine.

A tiny model is fitted first (``quant.quality.fit_on_prompts``): a
random-init model's logits are near-ties, and greedy matching on it
would measure tie-breaking noise. Its weights are carried into the port
with ``load_numpy_state``. The reference engine is the two-op path
(``fused_kv=False``) with the prefix cache and sampling off, and so is
the port's where the two are compared (``GEOM``; the cache's own parity
tests are ``tests/test_torch_prefix_cache.py``): the greedy tokens of
both engines must be identical for ragged prompts longer than one
``chunk_budget``. With ``kv_dtype="int8"`` the oracle is the
reference engine's int8 two-op path. Across the port's own three paths
(rope-fused, ``fused_rope=False``, ``fused_kv=False``) the tokens and
the pools (and scale sidecars) must be bitwise equal.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.inference.sampling import SamplingParams
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference.sampling import \
    SamplingParams as TSamplingParams
from paddle_tpu_torch.inference.serving import (AdmissionError,
                                                LlamaServingEngine, Request)
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

GEOM = dict(max_batch=4, page_size=8, num_pages=64, chunk_block=8,
            chunk_budget=16,
            prefix_cache=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    quality.fit_on_prompts(jm, steps=20)
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return jm, load_numpy_state(tm, arrays)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lens]


@pytest.mark.parametrize("lens,new", [
    ((37, 5, 20, 12, 29), 8),       # 5 prompts > max_batch: one waits
    ((17, 40), 12)])
def test_generate_matches_reference_engine(models, lens, new):
    jm, tm = models
    prompts = _prompts(len(lens), lens)
    je = JaxEngine(jm, fused_kv=False, sampling=False,
                   **GEOM)
    want = je.generate(prompts, max_new_tokens=new)
    je.close()
    te = LlamaServingEngine(tm, **GEOM)
    assert (te.chunk_block, te.chunk_budget, te.rows_cap,
            te.trash_page) == (je.chunk_block, je.chunk_budget,
                               je.rows_cap, je.trash_page)
    got = te.generate(prompts, max_new_tokens=new)
    assert got == want
    assert not te._live
    assert te.alloc.free_pages == te.alloc.num_pages


def test_schedule_matches_reference(models):
    """Both schedulers pack the same rows for the same live set."""
    jm, tm = models
    prompts = _prompts(3, (30, 3, 19))
    je = JaxEngine(jm, fused_kv=False, sampling=False, **GEOM)
    te = LlamaServingEngine(tm, **GEOM)
    for p in prompts:
        je._admit(JaxRequest(p, 4))
        te._admit(Request(p, 4))
    for _ in range(3):
        with je._lock:
            jrows, jcow = je._schedule_rows()
        with te._lock:
            trows, tcow = te._schedule_rows()
        strip = [[row[1:] for row in rows] for rows in (jrows, trows)]
        assert strip[0] == strip[1] and tcow == jcow == []
        je._dispatch_rows(jrows, jcow)
        te._dispatch_rows(trows, tcow)
    je.close()


def test_decode_many_equals_repeated_step(models):
    _, tm = models
    prompts = _prompts(5, (23, 9, 14))
    outs = []
    for use_many in (True, False):
        te = LlamaServingEngine(tm, **GEOM)
        reqs = [Request(p, max_new_tokens=10) for p in prompts]
        for r in reqs:
            te.add_request(r)
        if use_many:
            served = te.decode_many(6)
            assert served > 0
        else:
            for _ in range(6):
                te.step()
        outs.append([list(r.output_ids) for r in reqs])
    assert outs[0] == outs[1]


def test_add_request_prefills_to_first_token(models):
    _, tm = models
    te = LlamaServingEngine(tm, **GEOM)
    r = Request(_prompts(6, (41,))[0], max_new_tokens=3)
    te.add_request(r)
    assert r._prefilled == 41 and len(r.output_ids) == 1
    assert r.status == "live" and r.ttft is not None
    while not r.done:
        te.step()
    assert r.status == "completed" and len(r.output_ids) == 3


def test_admission_and_unported_options(models):
    """Admission reserves prompt pages only, as the reference's: what
    fits, what is shed (and the error's fields), what can never fit."""
    jm, tm = models
    geom = dict(max_batch=2, page_size=8, num_pages=9)
    errors = []
    for e, req_cls, sp_cls in (
            (JaxEngine(jm, fused_kv=False, **geom), JaxRequest,
             SamplingParams),
            (LlamaServingEngine(tm, **geom), Request, TSamplingParams)):
        e._admit(req_cls([1] * 30, max_new_tokens=10))     # 4 pages
        # each package's own AdmissionError, a MemoryError
        with pytest.raises(MemoryError, match="KV page pool exhausted") \
                as ei:
            e._admit(req_cls([2] * 40, max_new_tokens=10))  # 5 more: > 8
        err = ei.value
        errors.append((err.reason, err.live, err.max_batch, err.free_pages,
                       err.num_pages, err.retries, err.retry_after))
        with pytest.raises(ValueError, match="KV capacity"):
            e._admit(req_cls([1] * 100, max_new_tokens=10))
        # sampled requests are served since A1
        r = req_cls([1, 2], sampling=sp_cls(temperature=0.7))
        assert e._admit(r) is not None and r._seed is not None
        assert e.alloc.free_pages == 3
        e.close()
    assert errors[0] == errors[1]
    assert isinstance(ei.value, AdmissionError)
    # spec_k is served since A6 (capped at chunk_block - 1, as the
    # reference stores it), the KV tier since A7 (its pool bounded as the
    # reference bounds it)
    je = JaxEngine(jm, fused_kv=False, spec_k=2, **geom)
    assert LlamaServingEngine(tm, spec_k=2, **geom).spec_k == je.spec_k
    je.close()
    je = JaxEngine(jm, fused_kv=False, kv_tier=True, **geom)
    te = LlamaServingEngine(tm, kv_tier=True, **geom)
    assert te.tier is not None and te.tier.max_bytes == je.tier.max_bytes
    je.close()
    te.close()


def test_eos_and_stop_tokens(models):
    _, tm = models
    te = LlamaServingEngine(tm, **GEOM)
    p = _prompts(9, (12,))[0]
    free = te.generate([p], max_new_tokens=6)[0]
    eos = te.generate([p], max_new_tokens=6, eos_token_id=free[2])[0]
    assert eos == free[:free.index(free[2]) + 1]
    r = Request(p, max_new_tokens=6, stop=(free[2],))
    te.add_request(r)
    while not r.done:
        te.step()
    assert r.output_ids == free[:free.index(free[2])]
    assert torch.is_tensor(te.k_pools[0])


@pytest.mark.parametrize("lens,new", [
    ((37, 5, 20, 12, 29), 8),
    ((17, 40), 12)])
def test_int8_kv_matches_reference_engine(models, lens, new):
    jm, tm = models
    prompts = _prompts(len(lens) + 100, lens)
    je = JaxEngine(jm, kv_dtype="int8", fused_kv=False, sampling=False,
                   **GEOM)
    want = je.generate(prompts, max_new_tokens=new)
    je.close()
    te = LlamaServingEngine(tm, kv_dtype="int8", **GEOM)
    assert te.kv_quant and te.fused_rope
    assert te.k_pools[0].dtype == torch.int8
    assert te.k_scales[0].shape == te.k_pools[0].shape[:3] + (1,)
    assert te.kv_bytes_per_token == je.kv_bytes_per_token
    got = te.generate(prompts, max_new_tokens=new)
    assert got == want
    assert te.alloc.free_pages == te.alloc.num_pages


PATHS = {"rope_fused": dict(), "fused_kv": dict(fused_rope=False),
         "two_op": dict(fused_kv=False)}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_paths_agree_bitwise(models, kv_dtype):
    """The three attention paths: identical tokens, bitwise equal pools
    and sidecars after the same requests."""
    _, tm = models
    prompts = _prompts(21, (26, 9, 33))
    runs = {}
    for name, kw in PATHS.items():
        te = LlamaServingEngine(tm, kv_dtype=kv_dtype, **kw, **GEOM)
        assert (te.fused_kv, te.fused_rope) == (
            kw.get("fused_kv", True), name == "rope_fused")
        out = te.generate(prompts, max_new_tokens=10)
        runs[name] = (out, te.k_pools + te.v_pools + te.k_scales
                      + te.v_scales)
    out0, pools0 = runs["rope_fused"]
    assert len(pools0) == (8 if kv_dtype else 4)
    for name in ("fused_kv", "two_op"):
        out, pools = runs[name]
        assert out == out0, name
        assert all(torch.equal(a, b) for a, b in zip(pools, pools0)), name


@pytest.mark.parametrize("env,kw", [
    ({"PADDLE_TPU_KV_DTYPE": "int8"}, {}),
    ({"PADDLE_TPU_KV_DTYPE": "int8"}, {"kv_dtype": None}),
    ({"PADDLE_TPU_FUSED_KV": "0"}, {}),
    ({"PADDLE_TPU_FUSED_KV": "OFF", "PADDLE_TPU_FUSED_ROPE": "1"}, {}),
    ({"PADDLE_TPU_FUSED_ROPE": "false"}, {}),
    ({"PADDLE_TPU_FUSED_ROPE": "no"}, {}),
    ({"PADDLE_TPU_FUSED_KV": "0"}, {"fused_kv": True}),
    ({}, {"fused_kv": False, "fused_rope": True}),
])
def test_env_knobs_parse_as_reference(models, monkeypatch, env, kw):
    jm, tm = models
    for name in ("PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_FUSED_KV",
                 "PADDLE_TPU_FUSED_ROPE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    je = JaxEngine(jm, sampling=False, **kw, **GEOM)
    te = LlamaServingEngine(tm, **kw, **GEOM)
    assert (te.kv_quant, te.fused_kv, te.fused_rope) == (
        je.kv_quant, je.fused_kv, je.fused_rope)
    je.close()
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        LlamaServingEngine(tm, **GEOM)


def test_request_takes_the_reference_signature():
    want = inspect.signature(JaxRequest.__init__).parameters
    got = inspect.signature(Request.__init__).parameters
    assert [(n, p.default) for n, p in got.items()] \
        == [(n, p.default) for n, p in want.items()]
    p = [5, 6, 7]
    # positional as the reference takes them: the fourth is the deadline
    for cls in (Request, JaxRequest):
        r = cls(p, 4, 9, None, None, 0, 1, None, (3,), None)
        assert (r.max_new_tokens, r.eos_token_id, r.stop_set) == (
            4, 9, frozenset({3}))
    # a sampling spec is taken, its stop ids merged
    r = Request(p, sampling=TSamplingParams(stop=(11,)), stop=(3,))
    assert r.stop_set == JaxRequest(p, sampling=SamplingParams(stop=(11,)),
                                    stop=(3,)).stop_set == {3, 11}


def test_engine_takes_the_reference_signature(models):
    want = inspect.signature(JaxEngine.__init__).parameters
    got = inspect.signature(LlamaServingEngine.__init__).parameters
    assert list(got) == list(want)
    assert [(n, p.default) for n, p in got.items()] \
        == [(n, p.default) for n, p in want.items()]
    assert got["prefix_cache"].default is True
    _, tm = models
    # positional as the reference takes them: the ninth is burst, the
    # alias of decode_ticks
    te = LlamaServingEngine(tm, 4, 8, 64, None, 16, 8, None, 5)
    assert te.decode_ticks == 5
    assert LlamaServingEngine(tm, decode_ticks=3, burst=5,
                              **GEOM).decode_ticks == 3
    assert (te.sample_enabled, te.sample_slots) == (True, 8)
    te = LlamaServingEngine(tm, sampling=False, sample_slots=0, **GEOM)
    assert (te.sample_enabled, te.sample_slots) == (False, 1)


def test_engine_sampling_switch_reads_the_env_as_reference(models,
                                                           monkeypatch):
    jm, tm = models
    for value, on in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv("PADDLE_TPU_SAMPLING", value)
        je = JaxEngine(jm, **GEOM)
        assert je.sample_enabled == on
        je.close()
        assert LlamaServingEngine(tm, **GEOM).sample_enabled == on


@pytest.mark.parametrize("kw,item", [
    ({"spec_ngram": 4}, "A6"), ({"drafter_factory": object}, "A6"),
    ({"kv_tier_bytes": 1 << 20}, "A7")])
def test_engine_unported_knobs_raise(models, kw, item):
    """Knobs of items once unported, now taken as the reference takes
    them: A7's ``kv_tier_bytes`` with the tier off builds no tier and
    raises nothing; A6's are stored as the reference stores them: the
    drafter factory, or one making the n-gram drafter of
    ``spec_ngram``."""
    jm, tm = models
    if item == "A7":
        je = JaxEngine(jm, fused_kv=False, **kw, **GEOM)
        te = LlamaServingEngine(tm, **kw, **GEOM)
        assert te.tier is None and je.tier is None
        je.close()
        te.close()
        return
    je = JaxEngine(jm, fused_kv=False, spec_k=3, **kw, **GEOM)
    te = LlamaServingEngine(tm, spec_k=3, **kw, **GEOM)
    assert te.spec_k == je.spec_k == 3
    if "drafter_factory" in kw:
        assert te._drafter_factory is je._drafter_factory is object
    else:
        assert te._drafter_factory().n == je._drafter_factory().n == 4
    assert (te._spec_state, te._spec_proposed, te._spec_accepted,
            te._spec_idle) == ({}, 0, 0, 0)
    je.close()


@pytest.mark.parametrize("kw", [
    {"prefix_cache": True}, {"prefix_cache_pages": 4},
    {"admit_retries": 2}, {"admit_backoff": 0.01}, {"stuck_factor": 4.0},
    {"stuck_min_timeout": 5.0}])
def test_engine_lifecycle_knobs_work(models, kw):
    """The prefix cache's and the lifecycle's knobs are taken and stored
    as the reference stores them."""
    jm, tm = models
    geom = {**GEOM, "prefix_cache": True, **kw}
    je = JaxEngine(jm, fused_kv=False, sampling=False, **geom)
    te = LlamaServingEngine(tm, **geom)
    for e in (je, te):
        assert e.prefix is not None and e.prefix.alloc is e.alloc
    assert te.prefix.max_pages == je.prefix.max_pages \
        == kw.get("prefix_cache_pages")
    names = ("admit_retries", "admit_backoff", "stuck_factor",
             "stuck_min_timeout")
    assert [getattr(te, n) for n in names] == [getattr(je, n) for n in names]
    je.close()
    te.close()


@pytest.mark.parametrize("kw", [
    {"deadline": 5.0}, {"token_budget": 0.1}, {"priority": 2},
    {"retry_budget": 0}])
def test_request_lifecycle_knobs_work(models, kw):
    """Deadlines, priorities and retry budgets are taken as the
    reference takes them; admission stamps the same expiry."""
    jm, tm = models
    names = ("deadline", "token_budget", "priority", "retry_budget",
             "error", "trimmed", "_cancel_requested", "_cached_tokens")
    got = []
    for e, req_cls in ((JaxEngine(jm, fused_kv=False, sampling=False,
                                  **GEOM), JaxRequest),
                       (LlamaServingEngine(tm, **GEOM), Request)):
        r = req_cls([1, 2, 3], max_new_tokens=4, **kw)
        assert r._expires_at is None
        e._admit(r)
        ttl = None if r._expires_at is None else round(
            r._expires_at - r._t_admit, 9)
        got.append([getattr(r, n) for n in names] + [ttl, r.status])
        e.close()
    assert got[0] == got[1]


@pytest.mark.parametrize("kw,item", [
    ({"sampling": SamplingParams(temperature=0.5)}, "A1"),
    ({"sampling": SamplingParams(logit_bias={1: 2.0})}, "A1"),
    ({"sampling": SamplingParams(constraint=lambda p, o: None)}, "A1")])
def test_request_unported_knobs_raise(kw, item):
    JaxRequest([1, 2], **kw)          # the reference takes each of them
    # sampling is ported (A1): the port takes its own SamplingParams of
    # the same fields and, as the reference refuses anything but its own
    # class, refuses the reference's
    sp = kw["sampling"]
    mine = TSamplingParams(sp.temperature, sp.top_p, sp.top_k, sp.seed,
                           sp.stop, sp.logit_bias, sp.constraint)
    assert Request([1, 2], sampling=mine).sampling is mine
    with pytest.raises(ValueError, match="SamplingParams"):
        Request([1, 2], **kw)


@pytest.mark.parametrize("kw", [{"deadline": 0}, {"token_budget": -1.0},
                                {"retry_budget": -1}])
def test_request_bad_values_raise_as_reference(kw):
    with pytest.raises(ValueError):
        JaxRequest([1, 2], **kw)
    with pytest.raises(ValueError):
        Request([1, 2], **kw)


def test_on_token_sees_every_token_in_order(models):
    _, tm = models
    te = LlamaServingEngine(tm, **GEOM)
    prompts = _prompts(13, (21, 9, 30))
    want = te.generate(prompts, max_new_tokens=7)
    seen = {}
    reqs = [Request(p, max_new_tokens=7, on_token=lambda r, t: seen.setdefault(
        id(r), []).append(t)) for p in prompts]
    # a hook that raises does not stop the dispatch
    reqs.append(Request(prompts[0], max_new_tokens=7,
                        on_token=lambda r, t: 1 / 0))
    for r in reqs:
        te.add_request(r)
    while not all(r.done for r in reqs):
        te.step()
    assert [r.output_ids for r in reqs] == want + want[:1]
    assert [seen[id(r)] for r in reqs[:3]] == want


@pytest.mark.parametrize("env,value", [
    ("PADDLE_TPU_SPEC_K", "2"), ("PADDLE_TPU_KV_TIER", "1"),
    ("PADDLE_TPU_KV_TIER", "true"), ("PADDLE_TPU_KV_TIER", "ON")])
def test_fleet_env_knobs_raise(models, monkeypatch, env, value):
    """PADDLE_TPU_SPEC_K (served since A6) and PADDLE_TPU_KV_TIER (since
    A7) are read as the reference reads them."""
    jm, tm = models
    monkeypatch.setenv(env, value)
    je = JaxEngine(jm, sampling=False, **GEOM)
    assert je.spec_k > 0 or je.tier is not None   # the reference reads it
    je.close()
    te = LlamaServingEngine(tm, **GEOM)
    if env == "PADDLE_TPU_SPEC_K":
        assert te.spec_k == je.spec_k
    else:
        assert te.tier is not None and te.tier.max_bytes == je.tier.max_bytes
    te.close()
    # off values, as the reference parses them, serve as before
    monkeypatch.setenv(env, "0")
    LlamaServingEngine(tm, **GEOM)
