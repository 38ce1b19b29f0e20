"""The port's decode-step paged attention (``ops/paged_attention.py``)
and ``PagedKVCache`` against the reference's.

The same seeded numpy inputs go to the port's plain version and to both
reference formulations: the Pallas kernel (interpret mode on the CPU)
and ``paged_attention_xla``. Bars: f32 outputs within 1e-5 (the
reference test's own), bf16 outputs within one bf16 ulp of the
reference's, pools after ``write`` bit for bit. The one stated
difference: a row with ``context_len == 0`` is zeros in the port, NaN
in the reference's Pallas kernel and the mean of the gathered V in its
XLA path; ``test_inactive_row_is_zeros_where_the_reference_differs``
records all three.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import PagedKVCache as CacheJ
from paddle_tpu.ops import paged_attention as PJ

from paddle_tpu_torch.inference import PagedKVCache as CacheT
from paddle_tpu_torch.ops import paged_attention as PT
from paddle_tpu_torch.ops import ragged_paged_attention as RT

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    """A reference or port output as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = getattr(x, "_data", x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(a, jdtype=jnp.float32, tdtype=torch.float32, ints=()):
    """``a`` (numpy) as a jax array and a torch tensor; the names in
    ``ints`` stay int32."""
    out_j, out_t = {}, {}
    for k, v in a.items():
        if k in ints:
            out_j[k] = jnp.asarray(v, jnp.int32)
            out_t[k] = torch.from_numpy(np.asarray(v, np.int32))
        else:
            out_j[k] = jnp.asarray(v, jdtype)
            out_t[k] = torch.from_numpy(np.asarray(v, np.float32)).to(tdtype)
    return out_j, out_t


ARGS = ("q", "k_pages", "v_pages", "block_tables", "context_lens")
INTS = ("block_tables", "context_lens")


def _inputs(rng, b, h, hk, d, p, page, tables, lens):
    return dict(q=rng.randn(b, h, d), k_pages=rng.randn(p, hk, page, d),
                v_pages=rng.randn(p, hk, page, d),
                block_tables=np.asarray(tables, np.int32),
                context_lens=np.asarray(lens, np.int32))


def _run(a, scale=None, dtype="f32"):
    """(port plain, port wrapper, reference Pallas, reference XLA)."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    j, t = _both(a, jd, td, INTS)
    argj, argt = [j[k] for k in ARGS], [t[k] for k in ARGS]
    assert PJ.supported(*argj) and PT.supported(*argt)
    return (PT.paged_attention_ref(*argt, scale=scale),
            PT.paged_attention(*argt, scale=scale),
            PJ.paged_attention(*argj, scale=scale),
            PJ.paged_attention_xla(*argj, scale=scale))


def _ulp_bf16(x):
    _, e = np.frexp(x)
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


# the reference test's cases (tests/test_paged_attention.py) and more:
# b, h, hk, d, P, page, tables, lens
CASES = {
    "ragged_lens": (3, 8, 2, 32, 16, 8,
                    [[3, 7, 1, 0], [10, 2, 0, 0], [5, 9, 12, 14]],
                    [25, 9, 32]),
    "single_token": (2, 8, 2, 32, 16, 8, [[4, 0], [11, 0]], [1, 1]),
    "mqa_6_on_1_d16": (2, 6, 1, 16, 8, 8, [[2, 5], [7, 1]], [13, 16]),
    "poisoned_tails": (3, 8, 2, 32, 16, 8,
                       [[3, 6, -5, 10 ** 6], [9, -1, 16, 99],
                        [1, 2, 4, 8]], [10, 3, 31]),
    "llama3_geometry": (3, 32, 8, 128, 24, 16,
                        [[5, 17, 2, 0], [11, -3, 40, 7], [0, 1, 2, 3]],
                        [37, 9, 64]),
    "group_1": (2, 4, 4, 64, 12, 16, [[1, 7, 3], [10, 0, 2]], [40, 17]),
    "ctx_past_table": (2, 8, 2, 32, 16, 8, [[3, 7], [10, 2]], [25, 16]),
    "page_32": (2, 12, 4, 48, 10, 32, [[9, 2], [4, 8]], [50, 33]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_both_reference_paths_f32(name):
    b, h, hk, d, p, page, tables, lens = CASES[name]
    a = _inputs(np.random.RandomState(len(name)), b, h, hk, d, p, page,
                tables, lens)
    ref, wrap, pallas, xla = map(_np, _run(a))
    np.testing.assert_array_equal(ref, wrap)    # the CPU wrapper is plain
    np.testing.assert_allclose(ref, pallas, **TOL)
    np.testing.assert_allclose(ref, xla, **TOL)


@pytest.mark.parametrize("name", ["ragged_lens", "llama3_geometry",
                                  "mqa_6_on_1_d16", "ctx_past_table"])
def test_plain_matches_reference_bf16_within_one_ulp(name):
    b, h, hk, d, p, page, tables, lens = CASES[name]
    a = _inputs(np.random.RandomState(7), b, h, hk, d, p, page, tables,
                lens)
    ref, _, pallas, xla = _run(a, dtype="bf16")
    assert ref.dtype == torch.bfloat16
    ref = _np(ref)
    for other in (_np(pallas), _np(xla)):
        assert (np.abs(ref - other) <= _ulp_bf16(other)).all()


def test_custom_scale():
    b, h, hk, d, p, page, tables, lens = CASES["ragged_lens"]
    a = _inputs(np.random.RandomState(3), b, h, hk, d, p, page, tables,
                lens)
    ref, _, pallas, xla = map(_np, _run(a, scale=0.3))
    np.testing.assert_allclose(ref, pallas, **TOL)
    np.testing.assert_allclose(ref, xla, **TOL)
    default = _np(_run(a)[0])
    assert np.abs(ref - default).max() > 1e-3


def _naive(q, k, v, length, scale):
    """[H,D] x [S,Hk,D] dense attention over the first ``length`` keys,
    f64 (the reference test's oracle)."""
    g = q.shape[0] // k.shape[1]
    k = np.repeat(k[:length], g, axis=1).astype(np.float64)
    v = np.repeat(v[:length], g, axis=1).astype(np.float64)
    logits = np.einsum("hd,shd->hs", q.astype(np.float64), k) * scale
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("hs,shd->hd", w, v)


def test_contiguous_pages_match_dense_attention():
    rng = np.random.RandomState(1)
    a = _inputs(rng, 1, 8, 2, 32, 8, 8, [[0, 1, 2, 3]], [27])
    out = _np(PT.paged_attention(*[_both(a, ints=INTS)[1][k]
                                   for k in ARGS]))[0]
    k_lin = a["k_pages"].swapaxes(1, 2).reshape(-1, 2, 32)
    v_lin = a["v_pages"].swapaxes(1, 2).reshape(-1, 2, 32)
    want = _naive(a["q"][0], k_lin, v_lin, 27, 1 / math.sqrt(32))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_single_token_context_is_that_value_row():
    b, h, hk, d, p, page, tables, lens = CASES["single_token"]
    a = _inputs(np.random.RandomState(2), b, h, hk, d, p, page, tables,
                lens)
    out = _np(_run(a)[0])
    for i, page_id in enumerate([4, 11]):
        want = np.repeat(a["v_pages"][page_id, :, 0], h // hk, axis=0)
        np.testing.assert_allclose(out[i], want, **TOL)


def test_table_tails_are_never_read():
    b, h, hk, d, p, page, tables, lens = CASES["poisoned_tails"]
    a = _inputs(np.random.RandomState(4), b, h, hk, d, p, page, tables,
                lens)
    clean = dict(a, block_tables=np.asarray(
        [[3, 6, 0, 0], [9, 0, 0, 0], [1, 2, 4, 8]], np.int32))
    got = _np(_run(a)[0])
    np.testing.assert_array_equal(got, _np(_run(clean)[0]))


def test_context_past_the_table_attends_the_whole_table():
    b, h, hk, d, p, page, tables, lens = CASES["ctx_past_table"]
    a = _inputs(np.random.RandomState(5), b, h, hk, d, p, page, tables,
                lens)
    capped = dict(a, context_lens=np.asarray([16, 16], np.int32))
    np.testing.assert_array_equal(_np(_run(a)[0]), _np(_run(capped)[0]))


def test_inactive_row_is_zeros_where_the_reference_differs():
    a = _inputs(np.random.RandomState(6), 2, 8, 2, 32, 16, 8,
                [[3, 7], [10, 2]], [11, 0])
    ref, wrap, pallas, xla = map(_np, _run(a))
    assert not ref[1].any() and not wrap[1].any()
    np.testing.assert_allclose(ref[0], pallas[0], **TOL)
    np.testing.assert_allclose(ref[0], xla[0], **TOL)
    # the reference: its Pallas kernel divides 0 / 0, its XLA path takes
    # a uniform softmax over the row's gathered window
    assert np.isnan(pallas[1]).all()
    window = a["v_pages"][[10, 2]].swapaxes(1, 2).reshape(-1, 2, 32)
    np.testing.assert_allclose(
        xla[1], np.repeat(window.mean(axis=0), 4, axis=0), **TOL)


BAD = {  # name -> changes to a good case that both rules refuse
    "group_7_on_2": dict(q=(2, 7, 32)),
    "head_dim_12": dict(q=(2, 8, 12), pages=(16, 2, 8, 12)),
    "head_dim_264": dict(q=(2, 8, 264), pages=(16, 2, 8, 264)),
    "page_12": dict(pages=(16, 2, 12, 32)),
    "v_shape": dict(v=(16, 2, 16, 32)),
    "q_head_dim": dict(q=(2, 8, 16)),
    "tables_rows": dict(tables=(3, 4)),
    "lens_rows": dict(lens=(3,)),
    "q_rank": dict(q=(2, 8, 32, 1)),
    "zero_kv_heads": dict(q=(2, 0, 32), pages=(16, 0, 8, 32)),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_preconditions_refused_by_both(name):
    shapes = dict(q=(2, 8, 32), pages=(16, 2, 8, 32), tables=(2, 4),
                  lens=(2,))
    shapes.update(BAD[name])
    v_shape = shapes.pop("v", shapes["pages"])
    rng = np.random.RandomState(0)
    a = dict(q=rng.randn(*shapes["q"]), k_pages=rng.randn(*shapes["pages"]),
             v_pages=rng.randn(*v_shape),
             block_tables=np.zeros(shapes["tables"], np.int32),
             context_lens=np.full(shapes["lens"], 4, np.int32))
    j, t = _both(a, ints=INTS)
    argj, argt = [j[k] for k in ARGS], [t[k] for k in ARGS]
    assert not PJ.supported(*argj)
    assert not PT.supported(*argt)
    with pytest.raises(ValueError) as ej:
        PJ.paged_attention(*argj)
    with pytest.raises(ValueError) as et:
        PT.paged_attention(*argt)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", ["ragged_lens", "llama3_geometry",
                                  "mqa_6_on_1_d16", "page_32"])
def test_decode_rows_match_ragged_family(name):
    """#4 and #10 compute the same function for decode rows: one query at
    position ctx - 1 of a context of ctx keys (an inactive row too)."""
    b, h, hk, d, p, page, tables, lens = CASES[name]
    lens = list(lens)
    lens[-1] = 0
    a = _inputs(np.random.RandomState(8), b, h, hk, d, p, page, tables,
                lens)
    t = _both(a, ints=INTS)[1]
    ctx = t["context_lens"]
    out = PT.paged_attention_ref(*[t[k] for k in ARGS])
    ragged = RT.ragged_paged_attention_ref(
        t["q"][:, None], t["k_pages"], t["v_pages"], t["block_tables"], ctx,
        (ctx - 1).clamp_min(0), (ctx > 0).int())[:, 0]
    np.testing.assert_allclose(_np(out), _np(ragged), **TOL)


# ----------------------------------------------------------------------
# the cache as a whole
# ----------------------------------------------------------------------

HK_C, D_C, PAGE_C, NP_C = 2, 32, 8, 16


def _step_kv(rng, n):
    return (rng.randn(n, HK_C, D_C).astype(np.float32),
            rng.randn(n, HK_C, D_C).astype(np.float32))


def _same_state(cj, ct):
    assert ct._tables == cj._tables
    assert ct._lens == cj._lens
    assert ct._free == cj._free and ct.free_pages == cj.free_pages
    for pj, pt in ((cj.k_pages, ct.k_pages), (cj.v_pages, ct.v_pages)):
        np.testing.assert_array_equal(_np(pt), _np(pj))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cache_matches_reference_step_by_step(dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    cj = CacheJ(NP_C, PAGE_C, HK_C, D_C, dtype=jd)
    ct = CacheT(NP_C, PAGE_C, HK_C, D_C, dtype=td, device="cpu")
    rng = np.random.RandomState(9)

    def both(method, *args):
        rj = getattr(cj, method)(*args)
        rt = getattr(ct, method)(*args)
        assert rt == rj, method
        _same_state(cj, ct)

    def attend(seq_ids):
        q = rng.randn(len(seq_ids), 8, D_C).astype(np.float32)
        qj, qt = jnp.asarray(q, jd), torch.from_numpy(q).to(td)
        outs = [_np(ct.attend(seq_ids, qt)),
                _np(ct.attend(seq_ids, qt, use_kernel=False))]
        np.testing.assert_array_equal(outs[0], outs[1])
        for ref in (cj.attend(seq_ids, qj),
                    cj.attend(seq_ids, qj, use_pallas=False)):
            ref = _np(ref)
            if dtype == "f32":
                np.testing.assert_allclose(outs[0], ref, **TOL)
            else:
                assert (np.abs(outs[0] - ref) <= _ulp_bf16(ref)).all()

    both("admit", 0, 11)
    both("write", 0, *_step_kv(rng, 11))
    both("admit", 1, 23)
    both("write", 1, *_step_kv(rng, 23))
    attend([0, 1])
    for _ in range(6):                   # decode steps, crossing a page
        for sid in (0, 1):
            both("extend", sid, 1)
            both("write", sid, *_step_kv(rng, 1))
        attend([0, 1])
    both("rollback", 1, 5)
    both("extend", 1, 2)
    both("write", 1, *_step_kv(rng, 2))
    attend([1, 0])
    both("release", 0)
    both("admit", 2, 17)                 # recycled pages, out of order
    both("write", 2, *_step_kv(rng, 17))
    kj, kv = _step_kv(rng, 3)            # an explicit start
    both("write", 2, kj, kv, 4)
    attend([2, 1])
    attend([2])


def test_cache_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert CacheT(4, 8, 2, 32).k_pages.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CacheT(4, 8, 2, 32)
    c = CacheT(4, 8, 2, 32, device="cpu")
    assert c.k_pages.device.type == "cpu"
    assert c.k_pages.dtype == torch.bfloat16
    assert tuple(c.v_pages.shape) == (4, 2, 8, 32) and not c.v_pages.any()


def test_attend_takes_the_reference_use_pallas():
    want = inspect.signature(CacheJ.attend).parameters
    got = inspect.signature(CacheT.attend).parameters
    assert list(want) == list(got)[:len(want)]     # use_kernel: an alias
    ct = CacheT(NP_C, PAGE_C, HK_C, D_C, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(4)
    ct.admit(0, 13)
    ct.write(0, *(torch.from_numpy(a) for a in _step_kv(rng, 13)))
    q = torch.from_numpy(rng.randn(1, 8, D_C).astype(np.float32))
    base = ct.attend([0], q)
    for kw in ({"use_pallas": False}, {"use_kernel": False},
               {"use_pallas": True, "use_kernel": True},
               {"use_pallas": False, "use_kernel": False}):
        assert torch.equal(ct.attend([0], q, **kw), base)
    for kw in ({"use_pallas": True, "use_kernel": False},
               {"use_pallas": False, "use_kernel": True}):
        with pytest.raises(ValueError, match="disagree"):
            ct.attend([0], q, **kw)
    # positional, as a reference caller passes it
    assert torch.equal(ct.attend([0], q, None, False), base)


# the reference's other operand forms (C9): the port's CPU path against
# the reference's Pallas kernel (interpret mode) on the same numpy values;
# q dtype, pool dtype
FORMS = {
    "int64 tables and lens": (jnp.float32, jnp.float32, torch.float32,
                              torch.float32, np.int64),
    "bf16 q over f32 pools": (jnp.bfloat16, jnp.float32, torch.bfloat16,
                              torch.float32, np.int32),
    "f32 q over bf16 pools": (jnp.float32, jnp.bfloat16, torch.float32,
                              torch.bfloat16, np.int32),
    "raw int8 pools": (jnp.float32, jnp.int8, torch.float32, torch.int8,
                       np.int32),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reference_operand_forms_match_reference(form):
    jq, jkv, tq, tkv, ints = FORMS[form]
    b, h, hk, d, p, page, tables, lens = CASES["llama3_geometry"]
    rng = np.random.RandomState(11)
    a = _inputs(rng, b, h, hk, d, p, page, tables, lens)
    if tkv == torch.int8:
        a["k_pages"] = rng.randint(-127, 128, a["k_pages"].shape)
        a["v_pages"] = rng.randint(-127, 128, a["v_pages"].shape)
        a["q"] = a["q"] / 16
    # the values each side holds: q and pools rounded to their dtypes once
    qv = _np(jnp.asarray(a["q"], jq))
    kv = {k: _np(jnp.asarray(a[k], jkv)) for k in ("k_pages", "v_pages")}
    argj = [jnp.asarray(qv, jq), *(jnp.asarray(kv[k], jkv)
                                   for k in ("k_pages", "v_pages")),
            *(jnp.asarray(a[k]) for k in INTS)]
    argt = [torch.from_numpy(qv.copy()).to(tq),
            *(torch.from_numpy(kv[k].copy()).to(tkv) for k in ("k_pages",
                                                             "v_pages")),
            *(torch.from_numpy(a[k].astype(ints)) for k in INTS)]
    assert PJ.supported(*argj) and PT.supported(*argt)
    got, want = PT.paged_attention(*argt), PJ.paged_attention(*argj)
    assert got.dtype == tq and tuple(got.shape) == (b, h, d)
    g, w = _np(got), _np(want)
    # f32: the file's 1e-5, taken relative to the pools' value scale (V up
    # to 127 in int8 pools: the outputs are sums of such values)
    vmax = 127.0 if tkv == torch.int8 else 1.0
    if tq == torch.bfloat16:
        assert (np.abs(g - w) <= _ulp_bf16(w)).all()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * vmax)
    # the XLA path rounds its bf16 out once too: within one bf16 ulp
    x = _np(PJ.paged_attention_xla(*argj))
    if tq == torch.bfloat16:
        assert (np.abs(g - x) <= _ulp_bf16(x)).all()
    else:
        np.testing.assert_allclose(g, x, rtol=1e-5, atol=1e-5 * vmax)


def test_group_512_matches_reference():
    """The widest group the reference's rule takes at head_dim 256 (H
    1024 over Hk 2), which the CUDA kernel tiles: the port against the
    reference's Pallas kernel and XLA path."""
    a = _inputs(np.random.RandomState(5), 2, 1024, 2, 256, 6, 8,
                [[0, 3, 1], [5, 2, 4]], [20, 9])
    ref, wrap, pallas, xla = map(_np, _run(a))
    np.testing.assert_array_equal(ref, wrap)
    np.testing.assert_allclose(ref, pallas, **TOL)
    np.testing.assert_allclose(ref, xla, **TOL)


# contexts: none, one token, page multiples, a ragged one, past the
# table, Llama-3-8B's full context; table widths (pages) and page sizes
PLAN_CTXS = [0, 1, 16, 255, 256, 257, 1024, 1025, 4096, 5000, 8192, 9000]


@pytest.mark.parametrize("width,page", [(512, 16), (64, 8), (3, 64),
                                        (600, 16), (1, 8)])
def test_split_plan_covers_each_key_once(width, page):
    """Every key a row attends (its context, at most the table's width x
    page slots) lies in exactly one split, splits of SPLIT_UNIT keys (of
    half that up to LONG_KEYS / 2, twice that past LONG_KEYS), and no row
    takes more splits than the
    grid holds."""
    for ctx in PLAN_CTXS:
        n = max(0, min(ctx, width * page))
        plan = PT.split_plan(ctx, width, page)
        keys = [k for lo, hi in plan for k in range(lo, hi)]
        assert keys == list(range(n)), (ctx, width, page)
        unit = 2 * PT.SPLIT_UNIT if n > PT.LONG_KEYS else (
            PT.SPLIT_UNIT if n > PT.LONG_KEYS // 2 else PT.SPLIT_UNIT // 2)
        assert all(hi - lo == unit for lo, hi in plan[:-1])
        assert len(plan) <= PT.grid_splits(width, page)
    assert PT.split_plan(-3, width, page) == []


def test_split_plan_depends_on_the_row_alone():
    """A row's plan is a function of its own context and the table's
    capacity: the same in any batch, and the same for any width that
    holds the row's keys."""
    for ctx in PLAN_CTXS:
        for width in (600, 1000):
            assert PT.split_plan(ctx, width, 16) \
                == PT.split_plan(min(ctx, 600 * 16), 600, 16)
    # the reference's rule picks the instance by the pools' dtype alone
    assert [PT.kernel_instance(t) for t in (
        torch.bfloat16, torch.float16, torch.float32, torch.int8)] \
        == ["tensor-core", "tensor-core", "general", "general"]
    with pytest.raises(ValueError, match="no CUDA instance"):
        PT.kernel_instance(torch.float64)
