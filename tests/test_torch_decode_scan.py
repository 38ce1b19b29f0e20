"""The port's decode scan (``decode_many(n, exact)``, ``_decode_scan``,
``_scan_fits``) and ``prewarm`` against the reference engine's.

The reference runs ``n`` all-decode ticks as one ``lax.scan`` program and
splits a decode run into scans of ``decode_ticks``, then of
``max(decode_ticks // 4, 2)``, then single mixed steps; the port runs the
same tick function ``n`` times (on the card, one captured CUDA graph
replayed). Host logic must match exactly: the sequence of scan sizes and
single steps of both engines is recorded and compared, and so are the
tokens, on tiny models fitted with ``fit_on_prompts`` (a random-init
model's logits are near-ties). The reference engine is its two-op path
(``fused_kv=False``) with the prefix cache off, the port's every path.
Both admit against prompt pages only and relieve pressure with the same
ladder, so a tight pool scans alike too
(``test_scan_tight_pool_matches_reference``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.inference.serving import LlamaServingEngine, Request
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

GEOM = dict(max_batch=4, page_size=8, num_pages=64, chunk_block=8,
            chunk_budget=16,
            prefix_cache=False)
CONFIGS = {"dense": {}, "moe": dict(moe_num_experts=4, moe_top_k=2)}
# four requests: three prefilled by add_request, the last admitted only
# (its chunks pin the engine to single steps first); budgets that retire
# rows mid-scan
LENS, BUDGETS = (9, 20, 5, 30), (40, 7, 25, 12)


@pytest.fixture(scope="module")
def fitted():
    """Fitted float weights of each config, as numpy arrays."""
    out = {}
    for name, cfg in CONFIGS.items():
        paddle.seed(0)
        jm = JaxLlama(jax_tiny(**cfg))
        quality.fit_on_prompts(jm, steps=20)
        out[name] = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    return out


def _models(fitted, name="dense"):
    """Fresh reference and port models with the fitted weights (an int8
    engine quantizes its model in place)."""
    cfg = CONFIGS[name]
    jm = JaxLlama(jax_tiny(**cfg))
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in fitted[name].items()})
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu")
    return jm, load_numpy_state(tm, fitted[name]).eval()


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lens]


def _record(engine):
    """From now on, append each scan's size and each single mixed step
    (1) of ``engine`` to the returned list."""
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


def _sampling(kind, i, params_cls):
    """Row ``i``'s sampling spec for a row mix ``kind``."""
    if kind == "sampled" and i in (1, 2):
        return params_cls(temperature=(0.8, 1.0)[i - 1],
                          top_p=(0.9, 1.0)[i - 1], top_k=(0, 5)[i - 1],
                          seed=(11, 2 ** 31 - 1)[i - 1])
    if kind == "bias" and i == 1:
        return params_cls(logit_bias={7: 2.5, 40: -1.0})
    if kind == "constrained" and i == 2:
        return params_cls(constraint=lambda p, o: [3, 17, 40, 99])
    return None


def _drive(engine, req_cls, params_cls, n, exact, kind="greedy"):
    """The scenario on one engine: returns (calls of decode_many(n,
    exact), outputs, statuses)."""
    prompts = _prompts(5, LENS)
    reqs = [req_cls(p, m, sampling=_sampling(kind, i, params_cls))
            for i, (p, m) in enumerate(zip(prompts, BUDGETS))]
    for r in reqs[:3]:
        engine.add_request(r)
    engine._admit(reqs[3])
    calls = _record(engine)
    engine.decode_many(n, exact=exact)
    return calls, [list(r.output_ids) for r in reqs], \
        [r.status for r in reqs]


def _both(fitted, n, exact, kind="greedy", name="dense", port_kw=None,
          ref_kw=None):
    jm, tm = _models(fitted, name)
    je = JaxEngine(jm, fused_kv=False,
                   sampling=kind != "greedy", **(ref_kw or {}), **GEOM)
    want = _drive(je, JaxRequest, jsampling.SamplingParams, n, exact, kind)
    je.close()
    te = LlamaServingEngine(tm, **(port_kw or ref_kw or {}), **GEOM)
    got = _drive(te, Request, SamplingParams, n, exact, kind)
    return want, got


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n", [1, 3, 4, 6, 16, 37])
def test_decode_many_matches_reference(fitted, n, exact):
    want, got = _both(fitted, n, exact)
    assert got[0] == want[0]                  # the chunk sequence
    assert got[1:] == want[1:]                # tokens and statuses


@pytest.mark.parametrize("n,exact", [(16, True), (37, False)])
@pytest.mark.parametrize("kind", ["sampled", "bias", "constrained"])
def test_scan_rows_match_reference(fitted, kind, n, exact):
    """Sampled rows with seeds, bias-only rows (each its own tick graph
    mode) and a constrained row (which pins the engine to single
    steps)."""
    want, got = _both(fitted, n, exact, kind)
    assert got == want
    if kind == "constrained":            # single steps while it is live
        assert set(got[0][:6]) == {1}
    else:
        assert max(got[0]) > 1


VARIANTS = {"int8 kv": ("dense", dict(kv_dtype="int8"), None),
            "fused_rope off": ("dense", None, dict(fused_rope=False)),
            "fused_kv off": ("dense", None, dict(fused_kv=False)),
            "int8 weights": ("dense", dict(weight_dtype="int8"), None),
            "moe": ("moe", None, None),
            "moe int8": ("moe", dict(weight_dtype="int8"), None)}


@pytest.mark.parametrize("n,exact", [(16, True), (37, False)])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_scan_variants_match_reference(fitted, variant, n, exact):
    """Int8 KV pages, the two fallback attention paths, int8 weights and
    the MoE FFN, float and int8."""
    name, ref_kw, port_kw = VARIANTS[variant]
    want, got = _both(fitted, n, exact, name=name, ref_kw=ref_kw,
                      port_kw=port_kw)
    assert got == want
    assert max(got[0]) > 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_scan_tokens_equal_single_steps(fitted, kv_dtype):
    """On a fitted model the scan's tokens are the port's own single
    steps' (``decode_ticks=1``, which never scans), greedy and sampled
    rows alike."""
    _, tm = _models(fitted)
    prompts = _prompts(8, (11, 4, 26, 17, 8, 30))
    outs = []
    for ticks in (None, 1):
        te = LlamaServingEngine(tm, kv_dtype=kv_dtype, decode_ticks=ticks,
                                **GEOM)
        calls = _record(te)
        reqs = [Request(p, 14 + 3 * i, sampling=_sampling("sampled", i % 4,
                                                          SamplingParams))
                for i, p in enumerate(prompts)]
        outs.append(te.generate(reqs))
        assert (max(calls) > 1) == (ticks is None)
        assert not te._live and te.alloc.free_pages == te.alloc.num_pages
    assert outs[0] == outs[1]


def _scan_fits_state(fitted, page, usable, cap, lens, grow):
    """Both engines with the same allocator state: requests of prompt
    ``lens`` admitted (budget 1), each then grown by ``grow`` tokens;
    None if either refuses."""
    jm, tm = _models(fitted)
    geom = dict(max_batch=4, page_size=page, num_pages=usable + 1,
                max_pages_per_seq=cap, chunk_block=8, chunk_budget=16)
    je = JaxEngine(jm, fused_kv=False, sampling=False, **geom)
    te = LlamaServingEngine(tm, **geom)
    prompts = _prompts(len(lens) + page, lens)
    live = ([], [])
    try:
        for p, g in zip(prompts, grow):
            for e, req_cls, out in ((je, JaxRequest, live[0]),
                                    (te, Request, live[1])):
                r = req_cls(p, 1)
                e._admit(r)
                e.alloc.extend(r.seq_id, g)
                out.append(r)
    except (MemoryError, ValueError):
        je.close()
        return None
    return je, te, live


@pytest.mark.parametrize("page,usable,cap", [(4, 12, None), (4, 9, 4),
                                             (8, 7, None), (8, 16, 3)])
def test_scan_fits_matches_reference(fitted, page, usable, cap):
    """``_scan_fits`` gives the reference's n over a grid of allocator
    states: free pages from none to plenty, per-seq caps hit or not."""
    seen = set()
    for lens, grow in (((3,), (0,)), ((5, 9), (2, 7)), ((4, 4, 4), (0, 1, 3)),
                       ((7, 2), (10, 0)), ((12,), (3,))):
        state = _scan_fits_state(fitted, page, usable, cap, lens, grow)
        if state is None:
            continue
        je, te, (jlive, tlive) = state
        assert je.alloc.free_pages == te.alloc.free_pages
        for n in (1, 2, 3, 4, 5, 8, 16, 37):
            want = je._scan_fits(jlive, n)
            assert te._scan_fits(tlive, n) == want, (lens, grow, n)
            seen.add(want < n)
        je.close()
    assert seen == {True, False}


def test_scan_tight_pool_matches_reference(fitted):
    """A tight pool: request A retires next step (budget 2) one slot
    before a page boundary, B needs 4 more pages and none is spare. Both
    engines admit against prompt pages only, so both scan 4 ticks, A's
    overshoot taking a page B will need, and the ladder makes room when
    B runs short: the chunk sequence, the tokens, the statuses and the
    allocator (free list, tables, refcounts) are the reference's after
    every ``decode_many`` call."""
    jm, tm = _models(fitted)
    geom = dict(max_batch=2, page_size=8, num_pages=7, chunk_block=8,
                chunk_budget=16, prefix_cache=False)
    prompts = _prompts(9, (7, 4))
    runs = []
    for e, req_cls in ((JaxEngine(jm, fused_kv=False, sampling=False,
                                  **geom), JaxRequest),
                       (LlamaServingEngine(tm, **geom), Request)):
        reqs = [req_cls(prompts[0], 2), req_cls(prompts[1], 33)]
        for r in reqs:
            e._admit(r)
        e.step()                    # both prefill: A 1 of 2, B 1 of 33
        assert e.alloc.free_pages == 4
        n = e._scan_fits(reqs, 4)
        calls = _record(e)
        states = []
        while not all(r.done for r in reqs):
            e.decode_many(1, exact=False)
            states.append((list(e.alloc._free),
                           {k: list(v) for k, v in e.alloc._tables.items()},
                           dict(e.alloc._refs),
                           [(r.status, len(r.output_ids)) for r in reqs]))
        runs.append((n, calls, states, [r.output_ids for r in reqs]))
        if isinstance(e, JaxEngine):
            e.close()
    assert runs[0][0] == runs[1][0] == 4
    assert runs[0][1][0] == 4
    assert runs[1] == runs[0]


PREWARM = [(None, None), ([16, 4], [16]), ([4, 7, 16, 4], [4, 16, 4]),
           ([99], []), ([], [3])]


@pytest.mark.parametrize("mixed,scans", PREWARM)
def test_prewarm_returns_what_the_reference_warms(fitted, mixed, scans):
    """The return value and ``prewarmed`` are the reference's: the
    engine's two dispatch shapes (``chunk_budget``, ``max_batch``) warmed,
    other token counts skipped, scans sorted and deduplicated; no
    arguments, no recipe (both engines without a compile-cache
    directory)."""
    jm, tm = _models(fitted)
    je = JaxEngine(jm, fused_kv=False, **GEOM)
    je._cache_dir = None
    want = je.prewarm(mixed, scans)
    je.close()
    te = LlamaServingEngine(tm, **GEOM)
    te._cache_dir = None
    assert te.prewarmed is None
    got = te.prewarm(mixed, scans)
    assert got == want and te.prewarmed == je.prewarmed == want


def test_prewarm_reads_the_knob_and_env_as_reference(fitted, monkeypatch):
    jm, tm = _models(fitted)
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "0")
    for env, kw in (("auto", {}), ("1", {}), ("0", {}), ("0",
                                                         {"prewarm": True})):
        monkeypatch.setenv("PADDLE_TPU_SERVING_PREWARM", env)
        je = JaxEngine(jm, fused_kv=False, **kw, **GEOM)
        te = LlamaServingEngine(tm, **kw, **GEOM)
        assert te.prewarmed == je.prewarmed
        je.close()
    assert te.prewarmed == {"mixed": [], "scan": []}


@pytest.mark.parametrize("path", [{}, {"fused_kv": False},
                                  {"kv_dtype": "int8"}])
def test_prewarm_touches_no_request_state(fitted, path):
    """A warm-up writes the trash page only, and serving after it gives
    an unwarmed engine's tokens."""
    _, tm = _models(fitted)
    prompts = _prompts(3, (13, 6, 21))
    te = LlamaServingEngine(tm, **path, **GEOM)
    pools = [p.clone() for p in te.k_pools + te.v_pools]
    assert te.prewarm([te.chunk_budget, te.max_batch], [16]) == {
        "mixed": sorted({te.chunk_budget, te.max_batch}), "scan": [16]}
    trash = te.trash_page
    for before, after in zip(pools, te.k_pools + te.v_pools):
        assert torch.equal(before[:trash], after[:trash])
    assert te.alloc.free_pages == te.alloc.num_pages and not te._live
    want = LlamaServingEngine(tm, **path, **GEOM).generate(prompts, 9)
    assert te.generate(prompts, 9) == want


def test_scan_inputs_are_one_buffer_loaded_in_one_copy(fitted):
    """The scan's inputs are views of one int32 buffer (f32 fields as
    bits), so a scan sends them in one host-to-device copy: a sampled
    load fills the carry and the sampler rows, padding rows inert; a
    greedy load rewrites the carry and leaves the sampler part alone."""
    _, tm = _models(fitted)
    te = LlamaServingEngine(tm, sampling=True, **GEOM)
    sps = [None, SamplingParams(temperature=0.7, top_p=0.8, top_k=3,
                                seed=9)]
    reqs = [Request(p, 8, sampling=sp)
            for p, sp in zip(_prompts(2, (6, 11)), sps)]
    for r in reqs:
        te.add_request(r)
    starts = [te.alloc.extend(r.seq_id, 1) for r in reqs]
    te._load_scan(reqs, starts, "sampled", *te._scan_rows(reqs))
    g = te._graphs.buffers
    base = g["scan_in"].untyped_storage().data_ptr()
    for name in LlamaServingEngine._SCAN_IN:
        assert g[name].untyped_storage().data_ptr() == base, name
    assert g["lens"].tolist() == [s + 1 for s in starts] + [1, 1]
    assert g["tokens"].tolist() == [r.output_ids[-1] for r in reqs] + [0, 0]
    assert g["tables"][2:].eq(te.trash_page).all()
    assert g["temps"].tolist() == pytest.approx([0.0, 0.7, 0.0, 0.0])
    assert g["top_ks"].tolist() == [0, 3, 0, 0]
    assert g["seeds"][1].item() == reqs[1]._seed
    temps = g["temps"].clone()
    te._load_scan(reqs[:1], starts[:1], "greedy",
                  *te._scan_rows(reqs[:1]))
    assert g["lens"].tolist() == [starts[0] + 1, 1, 1, 1]
    assert torch.equal(g["temps"], temps) and g["tick"].item() == 0


def test_every_launch_counter_is_registered():
    """Every kernel module's launch counters are registered in
    ``_build.COUNTERS``, so a CUDA-graph capture takes back what it
    counted and adds it at each replay; ``launches`` of the modules with
    one kernel is the sum of its instances."""
    from paddle_tpu_torch.ops import (_build, flash_attention,
                                      fused_linear_cross_entropy,
                                      grouped_gemm, paged_attention,
                                      ragged_paged_attention, sampling)
    from paddle_tpu_torch.quant import kernels
    mods = (flash_attention, fused_linear_cross_entropy, grouped_gemm,
            paged_attention, ragged_paged_attention, sampling, kernels)
    registered = {id(c) for c in _build.COUNTERS}
    for mod in mods:
        for attr in ("launches", "instance_launches"):
            c = getattr(mod, attr, None)
            if isinstance(c, dict):
                assert id(c) in registered, (mod.__name__, attr)
    for mod in (fused_linear_cross_entropy, kernels):
        assert mod.launches == sum(mod.instance_launches.values())


def test_capture_counts_move_to_replays():
    """What a capture counted is taken back (a counter made during it
    included) and added again at each replay."""
    from paddle_tpu_torch.ops import _build, _graphs
    from paddle_tpu_torch.ops import sampling as SM
    before = [dict(c) for c in _build.COUNTERS]
    n0 = SM.launches["gumbel_argmax"]
    SM.launches["gumbel_argmax"] += 2
    late = _build.counter(("k",))
    try:
        late["k"] += 1
        delta = _graphs._take_back(before)
        assert SM.launches["gumbel_argmax"] == n0 and late["k"] == 0
        for _ in range(3):
            _graphs._add(delta)
        assert SM.launches["gumbel_argmax"] == n0 + 6 and late["k"] == 3
    finally:
        SM.launches["gumbel_argmax"] = n0
        _build.COUNTERS.remove(late)
