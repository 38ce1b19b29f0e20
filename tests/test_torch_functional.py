"""The port's functionals, rope tables and page allocator against the
reference package, on the same numpy inputs.

Float results are compared at rtol 1e-6 (atol 1e-6 for values near
zero), not bitwise: XLA may contract a multiply-add chain into an FMA
under jit, while PyTorch on the CPU rounds every operation. Host logic
(the page allocator) must match exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as FJ
from paddle_tpu.inference.paged_cache import PageAllocator as JaxAllocator
from paddle_tpu.ops import ragged_paged_attention as RJ

from paddle_tpu_torch.incubate.nn import functional as FT
from paddle_tpu_torch.inference.paged_cache import PageAllocator
from paddle_tpu_torch.ops import ragged_paged_attention as RT

TOL = dict(rtol=1e-6, atol=1e-6)


def _jax(out):
    return np.asarray(out.numpy())


@pytest.mark.parametrize("split", [False, True])
def test_swiglu(split):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    y = rng.randn(3, 5, 16).astype(np.float32)
    if split:
        want = _jax(FJ.swiglu(paddle.to_tensor(x)))
        got = FT.swiglu(torch.from_numpy(x))
    else:
        want = _jax(FJ.swiglu(paddle.to_tensor(x), paddle.to_tensor(y)))
        got = FT.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("residual,bias,axis", [
    (False, False, -1), (True, False, -1), (True, True, -1),
    (False, False, 1)])
def test_fused_rms_norm(residual, bias, axis):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6, 32).astype(np.float32)
    shape = (32,) if axis == -1 else (6, 32)
    w = rng.randn(*shape).astype(np.float32)
    kw_j, kw_t = {}, {}
    if residual:
        res = rng.randn(4, 6, 32).astype(np.float32)
        kw_j["residual"], kw_t["residual"] = (paddle.to_tensor(res),
                                              torch.from_numpy(res))
    if bias:
        b = rng.randn(32).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = paddle.to_tensor(b), torch.from_numpy(b)
    want = FJ.fused_rms_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                             epsilon=1e-5, begin_norm_axis=axis, **kw_j)
    got = FT.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            epsilon=1e-5, begin_norm_axis=axis, **kw_t)
    if residual:
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _jax(j), **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), _jax(want), **TOL)


@pytest.mark.parametrize("mode", ["tables", "default", "positions",
                                  "gptj"])
def test_fused_rotary_position_embedding(mode):
    rng = np.random.RandomState(2)
    b, s, h, hk, d = 2, 7, 4, 2, 16
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hk, d).astype(np.float32)
    v = rng.randn(b, s, hk, d).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode == "tables":
        pos = rng.randint(0, 300, (s,)).astype(np.int32)
        sin, cos = RT.rope_tables(torch.from_numpy(pos), d, 10000.0)
        kw_t = dict(sin=sin, cos=cos)
        kw_j = dict(sin=paddle.to_tensor(sin.numpy()),
                    cos=paddle.to_tensor(cos.numpy()))
    elif mode == "positions":
        pid = rng.randint(0, 300, (b, s)).astype(np.int64)
        kw_j = dict(position_ids=paddle.to_tensor(pid))
        kw_t = dict(position_ids=torch.from_numpy(pid))
    elif mode == "gptj":
        kw_j = kw_t = dict(use_neox_rotary_style=False)
    qj, kj, vj = FJ.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        rotary_emb_base=500000.0, **kw_j)
    qt, kt, vt = FT.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        rotary_emb_base=500000.0, **kw_t)
    # the angles' sin/cos come from two math libraries (1 ulp apart)
    tol = dict(rtol=1e-6, atol=1e-6 if mode == "tables" else 2e-6)
    np.testing.assert_allclose(qt.numpy(), _jax(qj), **tol)
    np.testing.assert_allclose(kt.numpy(), _jax(kj), **tol)
    assert np.array_equal(vt.numpy(), v)


@pytest.mark.parametrize("d,base", [(16, 10000.0), (128, 500000.0)])
def test_rope_tables(d, base):
    """The inverse frequencies and angles are bitwise; sin/cos of the
    same f32 angle differ by at most one f32 ulp between the two math
    libraries (|value| <= 1, so 2**-23 bounds it)."""
    pos = np.arange(0, 9000, 7).astype(np.int32)
    sj, cj = (np.asarray(a) for a in RJ.rope_tables(
        paddle.to_tensor(pos)._data, d, base))
    st, ct = RT.rope_tables(torch.from_numpy(pos), d, base)
    assert st.dtype == torch.float32 and st.shape == (len(pos), d)
    assert np.abs(st.numpy() - sj).max() <= 2.0 ** -23
    assert np.abs(ct.numpy() - cj).max() <= 2.0 ** -23


def _drive(alloc):
    """One scripted allocator history; returns every observable."""
    seen = []
    seen.append(alloc.admit(0, 20))
    seen.append(alloc.admit(1, 5))
    seen.append(alloc.extend(0, 13))
    seen.append(alloc.extend(1, 1))
    alloc.incref(alloc._tables[0][0])
    seen.append(alloc.admit(2, 9, shared_pages=alloc._tables[0][:1]))
    seen.append(alloc.ensure_writable(2, 3))
    seen.append(alloc.ensure_writable(2, 12))
    seen.append(alloc.rollback(0, 10))
    seen.append(alloc.take_pages(2))
    seen.append(alloc.export_table(0))
    alloc.release(1)
    with pytest.warns(RuntimeWarning):
        alloc.release(1)
    seen.append(alloc.decref(alloc._tables[0][0]))
    for p in seen[-3]:
        alloc.decref(p)
    with pytest.raises(MemoryError):
        alloc.admit(3, 8 * (alloc.free_pages + 1))
    seen.append(alloc.page_positions(0, 3, 9))
    seen += [alloc.free_pages, alloc.live_sequences(), dict(alloc._refs),
             {k: list(v) for k, v in alloc._tables.items()},
             dict(alloc._lens), list(alloc._free), alloc.cow_count,
             alloc.double_free_count]
    return seen


def test_page_allocator_matches_reference():
    got = _drive(PageAllocator(12, 8))
    want = _drive(JaxAllocator(12, 8))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple) and g and isinstance(g[0], np.ndarray):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        else:
            assert g == w


def test_page_allocator_batch_views_device():
    alloc = PageAllocator(16, 4)
    alloc.admit(5, 9)
    alloc.admit(6, 2)
    tables, lens = alloc.batch_views([5, 6], fill_page=15, device="cpu")
    assert tables.dtype == torch.int32 and tables.shape == (2, 3)
    assert tables[1, 1:].tolist() == [15, 15]
    assert lens.tolist() == [9, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            alloc.batch_views([5, 6])
