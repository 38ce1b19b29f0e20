"""The port's flash attention (plain forward and backward, through its
autograd Function on the CPU) against the reference's Pallas kernels in
interpret mode.

The same numpy q/k/v/dO go to both. Out and lse must agree at f32 atol
1e-5 and the gradients at atol 1e-4: both sides compute in f32, in
different orders (the reference online over 128-key blocks, the plain
version in one softmax).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as FJ

from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as FT

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)


def _inputs(b, sq, sk, h, hk, d, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), f(b, sq, h, d)


def _reference(q, k, v, do, causal):
    """(out, lse [B,H,Sq], dq, dk, dv) from the Pallas kernels."""
    h, hk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    fn = FJ._make_flash(scale, causal, h // hk)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    out, vjp = jax.vjp(fn, qj, kj, vj)
    dq, dk, dv = vjp(jnp.asarray(do))
    hm = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    _, lse = FJ._fwd(hm(qj), hm(kj), hm(vj), scale, causal, h // hk)
    return [np.asarray(a) for a in (out, lse[..., 0], dq, dk, dv)]


def _port(q, k, v, do, causal):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FT.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(do))
    _, lse = FT.flash_attention_fwd_ref(*(t.detach() for t in ts),
                                        causal=causal)
    return [a.detach().numpy() for a in (out, lse, *(t.grad for t in ts))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("hk", [1, 2, 4])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_matches_pallas(s, hk, d, causal):
    q, k, v, do = _inputs(2, s, s, 4, hk, d, seed=s + hk + d)
    before = dict(FT.launches)
    got = _port(q, k, v, do, causal)
    want = _reference(q, k, v, do, causal)
    for name, g, w, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                               (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    assert FT.launches == before      # CPU tensors launch no kernel


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_shorter_queries(causal):
    # Sq < Sk: causal alignment is bottom-right (offset Sk - Sq)
    q, k, v, do = _inputs(2, 128, 256, 4, 2, 16, seed=11)
    got = _port(q, k, v, do, causal)
    want = _reference(q, k, v, do, causal)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


# (q shape, k shape, mask, causal): both sides' verdicts must agree. The
# reference's two VMEM-budget clauses (a TPU limit) are not ported; no row
# here comes near them.
SUPPORTED_CASES = [
    ((1, 128, 4, 32), (1, 128, 2, 32), False, True),
    ((2, 256, 4, 64), (2, 256, 4, 64), False, False),
    ((1, 128, 4, 32), (1, 256, 1, 32), False, True),     # Sq < Sk
    ((1, 256, 4, 32), (1, 128, 2, 32), False, True),     # Sq > Sk causal
    ((1, 256, 4, 32), (1, 128, 2, 32), False, False),    # Sq > Sk plain
    ((1, 64, 4, 32), (1, 64, 2, 32), False, False),      # below a block
    ((1, 200, 4, 32), (1, 200, 2, 32), False, False),    # ragged length
    ((1, 128, 4, 32), (1, 128, 3, 32), False, False),    # H % Hk
    ((1, 128, 4, 12), (1, 128, 2, 12), False, False),    # D % 8
    ((1, 128, 4, 264), (1, 128, 4, 264), False, False),  # D > 256
    ((1, 128, 4, 32), (1, 128, 2, 32), True, False),     # a mask
    ((1, 128, 4, 32), (2, 128, 2, 32), False, False),    # batch mismatch
    ((1, 128, 4, 32), (1, 128, 2, 16), False, False),    # D mismatch
]


@pytest.mark.parametrize("qs,ks,mask,causal", SUPPORTED_CASES)
def test_supported_agrees_with_reference(qs, ks, mask, causal):
    qn, kn = np.zeros(qs, np.float32), np.zeros(ks, np.float32)
    qt, kt = torch.zeros(qs), torch.zeros(ks)
    m_n = np.zeros((1, 1, qs[1], ks[1]), bool) if mask else None
    m_t = torch.zeros(1, 1, qs[1], ks[1], dtype=torch.bool) if mask else None
    assert FT.supported(qt, kt, kt, m_t, causal) \
        == FJ.supported(qn, kn, kn, m_n, causal)


def test_flash_attention_raises_where_unsupported():
    q = torch.zeros(1, 200, 2, 32)
    with pytest.raises(ValueError, match="preconditions"):
        FT.flash_attention(q, q, q)


@pytest.mark.parametrize("s", [128, 100])
def test_sdpa_matches_reference(s):
    """The port's dispatch: flash at S=128, the plain composition at
    S=100; both against the reference's ``scaled_dot_product_attention``
    (its Pallas flash path at 128, its own composition at 100)."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as PF
    q, k, v, _ = _inputs(1, s, s, 4, 2, 16, seed=s)
    want = PF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=True).numpy()
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_sdpa_dropout_and_flash_api():
    """Dropout on: the plain composition, no flash call (as the reference
    takes its composition); the reference's ``flash_attention`` API."""
    q = torch.zeros(1, 128, 2, 16)
    calls = []
    orig = FT.flash_attention_fwd_ref
    FT.flash_attention_fwd_ref = lambda *a, **k: calls.append(1) or orig(
        *a, **k)
    try:
        out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    finally:
        FT.flash_attention_fwd_ref = orig
    assert not calls and out.shape == q.shape
    out, soft = F.flash_attention(q, q, q, causal=True)
    assert soft is None and out.shape == q.shape
    # not training: dropout is inert, as in the reference
    F.scaled_dot_product_attention(q, q, q, dropout_p=0.1, training=False)


def test_sdpa_under_auto_cast_runs_flash_in_bf16():
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 16, seed=3)
    seen = []
    orig = FT.flash_attention_fwd_ref

    def spy(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return orig(q, k, v, *a, **kw)
    FT.flash_attention_fwd_ref = spy
    try:
        with amp.auto_cast(dtype="bfloat16"):
            out = F.scaled_dot_product_attention(
                *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    finally:
        FT.flash_attention_fwd_ref = orig
    assert seen == [(torch.bfloat16,) * 3] and out.dtype == torch.bfloat16


def test_kernel_operand_checks():
    # f32, f16 and bf16 at any head_dim of the domain route to an instance
    q = torch.zeros(1, 128, 2, 64)
    assert FT._check_kernel_operands(q, q, q)[0] == "general"
    qb = torch.zeros(1, 128, 2, 32, dtype=torch.bfloat16)
    assert FT._check_kernel_operands(qb, qb, qb)[0] == "general"
    qh = torch.zeros(1, 128, 2, 256, dtype=torch.float16)
    assert FT._check_kernel_operands(qh, qh, qh)[0] == "general"
    qt = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16).transpose(1, 2)
    # strided [B, S, H, D] is fine
    assert FT._check_kernel_operands(qt, qt, qt)[0] == "tensor-core"
    with pytest.raises(ValueError, match="unit stride"):
        FT._check_kernel_operands(qt.new_zeros(1, 128, 2, 128)[..., ::2],
                                  qt, qt)
    # mixed dtypes run the general instance on f32 copies
    inst, ts = FT._check_kernel_operands(qt, q, q)
    assert inst == "general" and all(t.dtype == torch.float32 for t in ts)
    # the tensor-core instance's TMA boxes need 16-byte strides
    odd = torch.zeros(1, 128, 2, 132, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16-byte"):
        FT._check_kernel_operands(odd, odd, odd)
    assert FT._check_kernel_operands(odd.float(), odd.float(),
                                     odd.float())[0] == "general"
    with pytest.raises(ValueError, match="multiples of 128"):
        FT._check_kernel_operands(q[:, :64], q, q)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        FT._check_kernel_operands(q.double(), q.double(), q.double())


@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 128),
                                     ("float32", 128), ("float16", 64),
                                     ("bfloat16", 16), ("bfloat16", 80),
                                     ("bfloat16", 96), ("bfloat16", 256),
                                     ("float32", 8), ("float16", 200)])
def test_kernel_instance_rule(dtype, d):
    """One rule on (dtype, head_dim): bf16 at 64/128 is the tensor-core
    instance, every other point of the domain the general one."""
    want = "tensor-core" if dtype == "bfloat16" and d in (64, 128) \
        else "general"
    assert FT.kernel_instance(getattr(torch, dtype), d) == want


def _ulp(x, dtype):
    """One unit in the last place of ``dtype`` at each |x| (f32 numpy)."""
    mant = {"bfloat16": 7, "float16": 10, "float32": 23}[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - mant)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,d", [("float32", 128), ("float16", 64),
                                     ("bfloat16", 16), ("bfloat16", 80),
                                     ("bfloat16", 96), ("bfloat16", 256)])
def test_plain_matches_pallas_widened_domain(dtype, d, causal):
    """The plain versions at the general instance's (dtype, head_dim)
    points against the Pallas kernels on the same values in the same
    dtype: out and the gradients within one ulp of the dtype plus the f32
    tolerances above (both sides round f32 results once), lse 1e-5."""
    q, k, v, do = _inputs(1, 128, 128, 4, 2, d, seed=d)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    # both sides see the values rounded to the dtype
    q, k, v, do = (torch.from_numpy(a).to(td).float().numpy()
                   for a in (q, k, v, do))
    ts = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = FT.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(do).to(td))
    _, lse = FT.flash_attention_fwd_ref(*(t.detach() for t in ts),
                                        causal=causal)
    got = [out] + [t.grad for t in ts]
    assert all(g.dtype == td for g in got) and lse.dtype == torch.float32
    scale = 1.0 / math.sqrt(d)
    fn = FJ._make_flash(scale, causal, 2)
    qj, kj, vj = (jnp.asarray(a, dtype=jd) for a in (q, k, v))
    out_j, vjp = jax.vjp(fn, qj, kj, vj)
    want = [out_j, *vjp(jnp.asarray(do, dtype=jd))]
    hm = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    _, lse_j = FJ._fwd(hm(qj), hm(kj), hm(vj), scale, causal, 2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               rtol=0, atol=1e-5)
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (1e-5, 1e-4, 1e-4, 1e-4)):
        g = g.detach().float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, name
        bad = np.abs(g - w) > _ulp(w, dtype) + tol
        assert not bad.any(), (name, float(np.abs(g - w).max()))
