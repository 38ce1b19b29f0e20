"""The port's grouped GEMM (float and int8 weights) against the reference
package: the plain versions against ``grouped_gemm_xla`` /
``grouped_gemm_q8_xla`` and against the Pallas kernels in interpret mode
(``_grouped(..., use_kernel=True)``, ``_grouped_q8(..., use_kernel=
True)``), on empty experts, ragged tails and group sizes past the
stride; the gradients against ``jax.vjp`` of the reference.

Inputs are seeded numpy arrays handed to both. Tolerance: f32 outputs
within 1e-5 (absolute, values of order 1; the frameworks sum in other
orders), rows past each expert's size exactly zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.grouped_gemm import (_grouped, _grouped_q8,
                                         grouped_gemm_q8_xla,
                                         grouped_gemm_xla)
from paddle_tpu.quant.format import quantize_weight as jax_quantize

from paddle_tpu_torch.ops import grouped_gemm as GG

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [  # e, c, k, n, group sizes
    (4, 10, 16, 24, [3, 0, 10, 7]),        # empty + full + ragged tails
    (4, 10, 16, 24, [0, 0, 0, 0]),          # every expert empty
    (4, 10, 16, 24, [10, 0, 0, 0]),         # all rows on one expert
    (4, 5, 8, 8, [5, 2, 0, 3]),             # C below the row tile
    (3, 6, 32, 16, [9, 100, 4]),            # group sizes past the stride
]


def _inputs(e, c, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(e * c, k).astype(np.float32)
    w = (rng.randn(e, k, n) * 0.1).astype(np.float32)
    return x, w


def _zeros_past(y, e, c, gs):
    y3 = np.asarray(y).reshape(e, c, -1)
    return all(not y3[i, min(int(m), c):].any() for i, m in enumerate(gs))


@pytest.mark.parametrize("case", CASES)
def test_grouped_gemm_matches_reference(case):
    e, c, k, n, gs = case
    x, w = _inputs(e, c, k, n)
    gs_np = np.asarray(gs, np.int32)
    got = GG.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(gs_np)).numpy()
    xla = np.asarray(grouped_gemm_xla(x, w, gs_np).numpy())
    pallas = np.asarray(_grouped(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(gs_np), use_kernel=True))
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert _zeros_past(got, e, c, gs)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]])
def test_grouped_gemm_grads_match_reference(case):
    e, c, k, n, gs = case
    x, w = _inputs(e, c, k, n, seed=1)
    g = np.random.RandomState(2).randn(e * c, n).astype(np.float32)
    gs_np = np.asarray(gs, np.int32)
    _, vjp = jax.vjp(lambda a, b: _grouped(a, b, jnp.asarray(gs_np),
                                           use_kernel=True),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    GG.grouped_gemm(xt, wt, torch.from_numpy(gs_np)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), **TOL)
    assert _zeros_past(xt.grad.numpy(), e, c, gs)


@pytest.mark.parametrize("case,block", [
    ((4, 10, 32, 24, [3, 0, 10, 7]), 16),
    ((4, 10, 32, 24, [0, 0, 0, 0]), 32),
    ((4, 5, 64, 16, [5, 2, 0, 3]), 16),
    ((3, 6, 32, 16, [9, 100, 4]), 8)])
def test_grouped_gemm_q8_matches_reference(case, block):
    e, c, k, n, gs = case
    x, w = _inputs(e, c, k, n, seed=3)
    q, s = (np.array(a) for a in jax_quantize(jnp.asarray(w), block))
    gs_np = np.asarray(gs, np.int32)
    got = GG.grouped_gemm_q8(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(s), torch.from_numpy(gs_np),
                             block).numpy()
    xla = np.asarray(grouped_gemm_q8_xla(x, q, s, gs_np, block).numpy())
    pallas = np.asarray(_grouped_q8(jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(s), jnp.asarray(gs_np),
                                    block, use_kernel=True))
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert _zeros_past(got, e, c, gs)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the wrappers call the plain versions (looked up at
    call time) and launch nothing."""
    x, w = _inputs(2, 4, 8, 8)
    q, s = (torch.from_numpy(np.array(a))
            for a in jax_quantize(jnp.asarray(w), 8))
    calls = []
    for name in ("grouped_gemm_ref", "grouped_gemm_q8_ref"):
        fn = getattr(GG, name)
        monkeypatch.setattr(GG, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    before = dict(GG.launches)
    gs = torch.tensor([4, 1])
    GG.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w), gs)
    GG.grouped_gemm_q8(torch.from_numpy(x), q, s, gs, 8)
    assert calls == ["grouped_gemm_ref", "grouped_gemm_q8_ref"]
    assert GG.launches == before
    with pytest.raises(ValueError, match="E \\* C"):
        GG.grouped_gemm(torch.zeros(5, 8), torch.from_numpy(w), gs)
