"""Int8 KV pages: the port's quantizer and the engine's two-op scatters
against the reference's, bit for bit.

``quantize_kv_int8`` must give the reference's int8 values and f32
scales exactly (f32 absmax, ``max(amax, 1e-8) * f32(1/127)``, round half
to even, clip to +-127) for f32 and bf16 inputs, exact .5 ties and
all-zero vectors; the scatters (``_page_write``, ``_page_write_q8``,
``_last_writer_values``) must leave the reference's pool and sidecar
bytes, duplicate targets included. Inputs come from a seeded numpy
generator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import serving as SJ
from paddle_tpu.inference.paged_cache import quantize_kv_int8 as quant_ref

from paddle_tpu_torch.inference import serving as ST
from paddle_tpu_torch.inference.paged_cache import (INV_127,
                                                    quantize_kv_int8)


def _both(x):
    """(port q, port scale, reference q, reference scale) as numpy."""
    q, s = quantize_kv_int8(x)
    xj = jnp.asarray(x.float().numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    qr, sr = quant_ref(xj)
    return q.numpy(), s.numpy(), np.asarray(qr), np.asarray(sr)


def _inputs(kind, rng):
    x = rng.randn(12, 3, 32).astype(np.float32)
    if kind == "wide_range":
        x *= rng.choice([1e-6, 1e-2, 1.0, 300.0], size=(12, 3, 1))
    elif kind == "ties":
        # absmax 254 gives scale 2.0 exactly, so odd values sit on .5
        x = rng.choice([-7.0, -5.0, -3.0, -1.0, 1.0, 3.0, 5.0, 9.0],
                       size=(12, 3, 32)).astype(np.float32)
        x[..., 0] = 254.0
    elif kind == "zeros":
        x[0] = 0.0
        x[3, 1] = 0.0
        x[5, 2, :] = 1e-9            # below the 1e-8 floor
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "wide_range", "ties", "zeros"])
def test_quantize_matches_reference_bitwise(kind, dtype):
    x = _inputs(kind, np.random.RandomState(len(kind))).to(dtype)
    q, s, qr, sr = _both(x)
    assert q.dtype == qr.dtype == np.int8
    assert s.dtype == sr.dtype == np.float32
    assert s.shape == x.shape[:-1]
    assert np.array_equal(q, qr)
    assert np.array_equal(s.view(np.int32), sr.view(np.int32))
    if kind == "ties":
        assert (s == 2.0).all()
        # half to even: 1/2 -> 0, 3/2 -> 2, 5/2 -> 2, -1/2 -> 0, 9/2 -> 4
        xf = x.float().numpy()
        for v, want in ((1.0, 0), (3.0, 2), (5.0, 2), (-1.0, 0), (9.0, 4)):
            assert (q[xf == v] == want).all()
    if kind == "zeros":
        floor = np.float32(1e-8) * np.float32(INV_127)   # f32 product
        assert not q[0].any() and (s[0] == floor).all()


def test_inverse_constant_is_the_rounded_reciprocal():
    assert INV_127 == float(np.float32(1.0 / 127.0))
    assert INV_127 != 1.0 / 127.0


def _scatter_case(rng, dup):
    pages, hk, page, d, t = 6, 2, 8, 16, 10
    pool = rng.randn(pages, hk, page, d).astype(np.float32)
    new = rng.randn(t, hk, d).astype(np.float32)
    ids = rng.choice(pages * page, t, replace=False)
    if dup:
        ids[7:] = ids[:3]             # three slots written twice
    return pool, new, (ids // page).astype(np.int32), \
        (ids % page).astype(np.int32)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
def test_last_writer_values_match_reference(dup):
    _, new, pid, off = _scatter_case(np.random.RandomState(3), dup)
    got = ST._last_writer_values(torch.from_numpy(new),
                                 torch.from_numpy(pid),
                                 torch.from_numpy(off), 8)
    want = SJ._last_writer_values(jnp.asarray(new), jnp.asarray(pid),
                                  jnp.asarray(off), 8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if dup:
        assert np.array_equal(got[:3].numpy(), new[7:])


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
def test_page_write_matches_reference(dup):
    pool, new, pid, off = _scatter_case(np.random.RandomState(4), dup)
    pages = torch.from_numpy(pool.copy())
    out = ST._page_write(pages, torch.from_numpy(new), torch.from_numpy(pid),
                         torch.from_numpy(off))
    assert out is pages                  # in place
    want = SJ._page_write(jnp.asarray(pool), jnp.asarray(new),
                          jnp.asarray(pid), jnp.asarray(off))
    assert np.array_equal(pages.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
def test_page_write_q8_matches_reference(dup, dtype):
    rng = np.random.RandomState(5)
    pool, new, pid, off = _scatter_case(rng, dup)
    q0 = rng.randint(-127, 128, pool.shape).astype(np.int8)
    s0 = rng.rand(*pool.shape[:3], 1).astype(np.float32)
    pages, scales = torch.from_numpy(q0.copy()), torch.from_numpy(s0.copy())
    nt = torch.from_numpy(new).to(dtype)
    ST._page_write_q8(pages, scales, nt, torch.from_numpy(pid),
                      torch.from_numpy(off))
    nj = jnp.asarray(nt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    wp, ws = SJ._page_write_q8(jnp.asarray(q0), jnp.asarray(s0), nj,
                               jnp.asarray(pid), jnp.asarray(off))
    assert np.array_equal(pages.numpy(), np.asarray(wp._data))
    assert np.array_equal(scales.numpy(), np.asarray(ws._data))
    # untouched slots keep their bytes and scales
    touched = np.zeros((pool.shape[0], pool.shape[2]), bool)
    touched[pid, off] = True
    keep = np.broadcast_to(~touched[:, None, :], pool.shape[:3])
    assert np.array_equal(pages.numpy()[keep], q0[keep])
    assert np.array_equal(scales.numpy()[keep], s0[keep])


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
def test_page_writes_take_the_dispatch_last_writers(dup):
    """The engine finds the last writers once per dispatch and hands them
    to every layer's K and V scatter: the pools come out as when each
    scatter finds them itself."""
    rng = np.random.RandomState(6)
    pool, new, pid, off = _scatter_case(rng, dup)
    pid_t, off_t = torch.from_numpy(pid), torch.from_numpy(off)
    last = ST._last_writer_index(pid_t, off_t, 8)
    nt = torch.from_numpy(new)
    assert torch.equal(nt[last], ST._last_writer_values(nt, pid_t, off_t, 8))
    a, b = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    ST._page_write(a, nt, pid_t, off_t)
    ST._page_write(b, nt, pid_t, off_t, last)
    assert torch.equal(a, b)
    q0 = torch.from_numpy(rng.randint(-127, 128, pool.shape).astype(np.int8))
    s0 = torch.from_numpy(rng.rand(*pool.shape[:3], 1).astype(np.float32))
    qa, sa, qb, sb = q0.clone(), s0.clone(), q0.clone(), s0.clone()
    ST._page_write_q8(qa, sa, nt, pid_t, off_t)
    ST._page_write_q8(qb, sb, nt, pid_t, off_t, last)
    assert torch.equal(qa, qb) and torch.equal(sa, sb)
