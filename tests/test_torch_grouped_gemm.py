"""The port's grouped GEMM (float and int8 weights) against the reference
package: the plain versions against ``grouped_gemm_xla`` /
``grouped_gemm_q8_xla`` and against the Pallas kernels in interpret mode
(``_grouped(..., use_kernel=True)``, ``_grouped_q8(..., use_kernel=
True)``), on empty experts, ragged tails and group sizes past the
stride, in f32 and at f16 and bf16 x and w; the gradients against
``jax.vjp`` of the reference; the CUDA instance rule and K split.

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


# the general instance's points: e, c, k, n, group sizes, x dtype, block
WIDE = [
    (3, 6, 40, 24, [6, 0, 9], "float16", 8),
    (3, 6, 96, 64, [2, 6, 0], "float16", 24),
    (2, 5, 37, 29, [5, 3], "float32", 16),
    (2, 7, 120, 40, [7, 1], "bfloat16", 40),
    (3, 4, 44, 20, [0, 4, 2], "float32", 12),
]
_J = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
      "float32": jnp.float32}


def _close_in(got, want, dtype):
    """Both sum in f32 in other orders and round to x's dtype: within 1
    ulp of it (1e-5 in f32)."""
    ulp = {"float16": 2 ** -10, "bfloat16": 2 ** -7, "float32": 1e-5}[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=ulp,
                               atol=ulp)


@pytest.mark.parametrize("case", WIDE)
def test_grouped_gemms_widened_domain_match_reference(case):
    """f16 x, blocks of 8, 24 and 40, N 24 and K, N off multiples of 8:
    the plain versions (what the general instance computes) against
    ``grouped_gemm_xla`` / ``grouped_gemm_q8_xla`` fed the same x."""
    e, c, k, n, gs, dtype, block = case
    x, w = _inputs(e, c, k, n, seed=k)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(_J[dtype])
    gs_np = np.asarray(gs, np.int32)
    got = GG.grouped_gemm(xt, torch.from_numpy(w), torch.from_numpy(gs_np))
    assert got.dtype == xt.dtype
    want = grouped_gemm_xla(xj, w, gs_np).numpy()
    _close_in(got.float().numpy(), want, dtype)
    assert _zeros_past(got.float().numpy(), e, c, gs)
    k_pad = -(-k // block) * block
    if k_pad == k:   # the reference's int8 formulation needs whole blocks
        q, s = (np.array(a) for a in jax_quantize(jnp.asarray(w), block))
        got = GG.grouped_gemm_q8(xt, torch.from_numpy(q), torch.from_numpy(s),
                                 torch.from_numpy(gs_np), block)
        want = grouped_gemm_q8_xla(xj, q, s, gs_np, block).numpy()
        _close_in(got.float().numpy(), want, dtype)
        assert _zeros_past(got.float().numpy(), e, c, gs)


# 16-bit x and w of one dtype, the CUDA cluster instance's domain: e, c, k,
# n, group sizes (empty experts, gs > C, 1-9 live rows)
SIXTEEN = [
    CASES[0],
    CASES[4],
    (8, 9, 64, 48, [9, 0, 3, 1, 0, 2, 1, 12]),
]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("case", SIXTEEN)
def test_grouped_gemm_16bit_matches_reference(case, dtype):
    """The plain version at f16 and bf16 x and w (what the cluster
    instance computes: exact 16-bit products summed in f32, out in x's
    dtype) against the reference's ``grouped_gemm_xla`` and its Pallas
    kernel in interpret mode, fed the same 16-bit values: within 1 ulp
    of the dtype (both sum in f32, in other orders); rows past each
    expert's size exactly zero."""
    e, c, k, n, gs = case
    x, w = _inputs(e, c, k, n, seed=11)
    dt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt)
    xj = jnp.asarray(xt.float().numpy()).astype(_J[dtype])
    wj = jnp.asarray(wt.float().numpy()).astype(_J[dtype])
    gs_np = np.asarray(gs, np.int32)
    got = GG.grouped_gemm(xt, wt, torch.from_numpy(gs_np))
    assert got.dtype == dt
    got = got.float().numpy()
    xla = np.asarray(grouped_gemm_xla(xj, wj, gs_np).numpy(), np.float32)
    pallas = np.asarray(_grouped(xj, wj, jnp.asarray(gs_np),
                                 use_kernel=True), np.float32)
    _close_in(got, xla, dtype)
    _close_in(got, pallas, dtype)
    assert _zeros_past(got, e, c, gs)


@pytest.mark.parametrize("dtype,k,n,want", [
    (torch.bfloat16, 4096, 14336, "cluster"),    # Mixtral gate/up
    (torch.bfloat16, 14336, 4096, "cluster"),    # down, and dx of gate/up
    (torch.float16, 4096, 14336, "cluster"),
    (torch.float16, 64, 48, "cluster"),
    (torch.float16, 60, 48, "general"),
    (torch.bfloat16, 64, 20, "general"),
    (torch.float32, 4096, 14336, "tile"),
    (torch.float32, 37, 64, "general")])
def test_float_gemm_instance_rule(dtype, k, n, want):
    """The float grouped GEMM's instance: 16-bit x (bf16 and f16 alike)
    at K % 8 and N % 8 takes the cluster instance, f32 x the tile one,
    the rest the general one."""
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    assert gemm_instance("grouped_gemm", dtype, k, n) == want


@pytest.mark.parametrize("sms", [132, 114])
def test_split_count_is_a_function_of_shape_and_card(monkeypatch, sms):
    """The cluster instances' K split: whole units, at most 8 and at most
    the units K holds, more where the column tiles leave the card's SMs
    idle; its arguments are the weight's shape, the unit and the card,
    never the rows (so every out row stays one fixed-order sum)."""
    import inspect
    from paddle_tpu_torch.ops import _tile_gemm as TG
    monkeypatch.setattr(TG, "sm_count", lambda device: sms)
    assert list(inspect.signature(TG.split_count).parameters) == [
        "device", "e", "k", "n", "unit"]
    dev = torch.device("cpu")
    # Mixtral-8x7B: gate/up has 896 column tiles, down 256
    assert TG.split_count(dev, 8, 4096, 14336, TG.CLUSTER_DEPTH) == 1
    assert TG.split_count(dev, 8, 14336, 4096, TG.CLUSTER_DEPTH) == \
        4 * sms // 256
    for e, k, n in [(1, 4096, 1024), (3, 64, 48), (2, 200, 256),
                    (8, 14336, 4096)]:
        s = TG.split_count(dev, e, k, n, TG.CLUSTER_DEPTH)
        units = -(-k // TG.CLUSTER_DEPTH)
        assert 1 <= s <= min(TG.MAX_SPLITS, units)
        want = max(1, min(TG.MAX_SPLITS, units,
                          4 * sms // (e * -(-n // TG.TILE_N))))
        assert s == want


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("k,n", [(64, 64), (40, 24), (37, 64), (64, 20)])
@pytest.mark.parametrize("block", [8, 24, 32])
def test_supported_matches_the_reference_rule(monkeypatch, dtype, k, n,
                                              block):
    """``supported`` / ``supported_q8`` are the reference's kernel rules
    without the TPU and VMEM clauses (its backend test forced to a TPU
    here; the VMEM budget holds at these shapes), the int8 one taking a
    ragged last block too."""
    import paddle_tpu.ops.grouped_gemm as RG
    monkeypatch.setattr(RG, "_interpret", lambda: False)
    monkeypatch.setattr(RG, "_HAS_PLTPU", True)
    e, c = 2, 4
    x, w = _inputs(e, c, k, n)
    gs = np.asarray([3, 4], np.int32)
    q, s = (np.array(a) for a in jax_quantize(jnp.asarray(w), block)) \
        if k % block == 0 else (None, None)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(_J[dtype])
    assert GG.supported(xt, torch.from_numpy(w), torch.from_numpy(gs)) \
        is RG.supported(xj, jnp.asarray(w), jnp.asarray(gs))
    from paddle_tpu_torch.quant.format import quantize_weight
    qt, st = quantize_weight(torch.from_numpy(w), block)
    got = GG.supported_q8(xt, qt, st, torch.from_numpy(gs), block)
    if k % block == 0:
        assert got is RG.supported_q8(xj, jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(gs), block)
    else:
        assert got is (k % 8 == 0 and n % 8 == 0)


def test_grouped_launch_raises_only_for_what_no_instance_takes():
    """The CUDA wrappers refuse x dtypes, weights and scales no instance
    takes, and strides or alignment the tile instance cannot read,
    before any launch (so the checks run on the CPU too)."""
    x, w = _inputs(2, 4, 64, 32)
    gs = torch.tensor([4, 1])
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        GG._launch_float(xt.to(torch.int32), wt.to(torch.int32), gs)
    strided = torch.zeros(2, 64, 64)[..., ::2]
    with pytest.raises(ValueError, match="tile instance reads w with a "
                                         "unit stride"):
        GG._launch_float(xt, strided, gs)
    # 16-bit x: the cluster instance's tensor maps need the same
    for dt in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="cluster instance reads w "
                                             "with a unit stride"):
            GG._launch_float(xt.to(dt),
                             torch.zeros(2, 64, 64, dtype=dt)[..., ::2], gs)
        odd = torch.zeros(1 + 8 * 64, dtype=dt)[1:].view(8, 64)
        with pytest.raises(ValueError, match="cluster instance takes "
                                             "16-byte"):
            GG._launch_float(odd, wt.to(dt), gs)
    q, s = (torch.from_numpy(np.array(a))
            for a in jax_quantize(jnp.asarray(w), 32))
    with pytest.raises(ValueError, match="int8 w \\[E, K, N\\] and f32"):
        GG._launch_q8(xt, q, s[:, :1], gs, 32)
    odd = torch.zeros(1 + 8 * 64)[1:].view(8, 64)
    with pytest.raises(ValueError, match="tile instance takes 16-byte"):
        GG._launch_q8(odd, q, s, gs, 32)
    # bf16 and f16 x: the cluster instance (int8 converted in registers)
    for dt in (torch.bfloat16, torch.float16):
        odd = torch.zeros(1 + 8 * 64, dtype=dt)[1:].view(8, 64)
        with pytest.raises(ValueError, match="cluster instance takes 16-byte"):
            GG._launch_q8(odd, q, s, gs, 32)
    assert not any(GG.launches.values())
    assert not any(GG.instance_launches.values())


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
