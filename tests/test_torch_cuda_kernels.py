"""The training and MoE/int8 kernels against their plain versions on
the card, at small shapes and edge cases that ``chip_smoke.py`` does not
reach: head dim 64, GQA groups 1 and 4, non-causal and shorter-query
batches, the autograd path end to end, and the flash kernels' general
instance (f32, f16 and bf16 at head dims 8 to 256); the loss kernel on ragged row
tiles, a ragged vocab tail and labels outside ``[0, V)`` (in the padded
tail too); the grouped GEMMs (float and int8) on empty experts, ragged
row, K and N tails, group sizes past the stride, f32 and bf16, and the
backward's dx on the transposed weight; the dequant matmul at decode
and prefill row counts; a ragged last scale block in both int8 kernels;
every instance of the ragged paged attention family (rope-fused,
post-rope fused and read-only, over float and int8 pools) at head dims
8 to 256, pages of 8 to 64 slots and bf16, f16 and f32 models, with
multi-chunk rows, an inactive row and poisoned table tails, and the
engine's geometry check at construction; the decode paged attention
kernel over bf16, f16 and f32 pools (q in the pools' dtype or f32) at
GQA groups 1, 4, 6 and 32, head dims 16 to 256 and pages of 8, 16 and
32 slots, with inactive and one-token rows, poisoned table tails and
contexts past the table, rows bitwise the same alone and in a batch,
and ``PagedKVCache`` on the card.

Every test needs an NVIDIA card and ``nvcc`` and skips without one; on
the card this file runs on its own, without the jax-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances are ``chip_smoke.py``'s: bf16 outputs within 1 bf16 ulp plus
2^-10 of the head vector's largest value (f16 within 1 f16 ulp plus the
same, f32 within 1 f32 ulp plus 2^-16 of it) (for gradients, that largest
value taken at least 2^-6 of the tensor's), f32 lse within 1e-3; the
loss kernel's lse and pick within 1e-5 of max(|x|, 1). The f32
grouped/dequant products: within 1e-5 of the out row's largest value.
Attention: written int8 slots, their scales and V slots bit for bit the
plain version's, roped bf16 K slots within 1 bf16 ulp, untouched slots
unchanged. Decode paged attention: outputs in f16 within 1 f16 ulp plus
2^-10 of the head vector's largest value, bf16 as above, f32 as the f32
products.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as FT
from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
from paddle_tpu_torch.ops import grouped_gemm as GG
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RP
from paddle_tpu_torch.quant import kernels as QK
from paddle_tpu_torch.quant.format import quantize_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernels build with nvcc there)")
    return torch.device("cuda")


def _ulp(x):
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def _close(got, ref, floor=0.0):
    ref, got = ref.float(), got.float()
    vec = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        floor * float(ref.abs().max()))
    bad = (got - ref).abs() > _ulp(ref) + 2 ** -10 * vec
    assert torch.isfinite(got).all() and not bool(bad.any())


def _close_any(got, ref):
    """bf16 outs by :func:`_close`; f32 outs within 1e-5 of the row's
    largest value."""
    if ref.dtype == torch.bfloat16:
        return _close(got, ref)
    vec = ref.abs().amax(dim=-1, keepdim=True)
    assert torch.isfinite(got).all()
    assert not bool(((got - ref).abs() > 1e-5 * vec).any())


FLASH = [  # b, sq, sk, h, hk, d, causal
    (1, 128, 128, 4, 1, 64, True),
    (2, 256, 256, 8, 2, 128, False),
    (1, 128, 384, 4, 4, 128, True),
    (1, 384, 384, 2, 1, 64, True),
    (2, 128, 256, 8, 8, 64, False),
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_kernels_match_plain(dev, case):
    b, sq, sk, h, hk, d, causal = case
    g = torch.Generator(dev).manual_seed(sum(case))
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q, do = torch.randn(b, sq, h, d, **bf), torch.randn(b, sq, h, d, **bf)
    k, v = torch.randn(b, sk, hk, d, **bf), torch.randn(b, sk, hk, d, **bf)
    scale = 1.0 / math.sqrt(d)
    before = dict(FT.launches)
    out, lse = FT._launch_forward(q, k, v, causal, scale)
    out_r, lse_r = FT.flash_attention_fwd_ref(q, k, v, causal, scale)
    _close(out, out_r)
    assert float((lse - lse_r).abs().max()) <= 1e-3
    delta = FT.attention_delta(out_r, do)
    grads = FT._launch_backward(q, k, v, do, lse_r, delta, causal, scale)
    refs = FT.flash_attention_bwd_ref(q, k, v, do, lse_r, delta, causal,
                                      scale)
    for got, ref in zip(grads, refs):
        _close(got, ref, 2 ** -6)
    assert FT.launches == {k_: n + 1 for k_, n in before.items()}
    inst = FT.instance_launches
    assert inst["forward.wgmma"] and inst["dq.wmma"] and inst["dkv.wgmma"]


def test_flash_dkv_is_bitwise_across_calls(dev):
    """dK/dV sums the group in registers in one fixed order (no
    atomics): two launches on the same inputs agree bit for bit."""
    g = torch.Generator(dev).manual_seed(11)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q, do = torch.randn(2, 256, 8, 128, **bf), torch.randn(2, 256, 8, 128, **bf)
    k, v = torch.randn(2, 256, 2, 128, **bf), torch.randn(2, 256, 2, 128, **bf)
    out, lse = FT.flash_attention_fwd_ref(q, k, v, True)
    args = (q, k, v, do, lse, FT.attention_delta(out, do), True, 128 ** -0.5)
    before = FT.instance_launches["dkv.wgmma"]
    dk1, dv1 = FT._launch_dkv(*args)
    dk2, dv2 = FT._launch_dkv(*args)
    assert FT.instance_launches["dkv.wgmma"] == before + 2
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


def test_flash_autograd_on_the_card(dev):
    g = torch.Generator(dev).manual_seed(5)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q = torch.randn(2, 128, 8, 128, **bf).requires_grad_()
    k = torch.randn(2, 128, 2, 128, **bf).requires_grad_()
    v = torch.randn(2, 128, 2, 128, **bf).requires_grad_()
    do = torch.randn(2, 128, 8, 128, **bf)
    FT.flash_attention(q, k, v, causal=True).backward(do)
    out_r, lse_r = FT.flash_attention_fwd_ref(q.detach(), k.detach(),
                                              v.detach(), True)
    refs = FT.flash_attention_bwd_ref(
        q.detach(), k.detach(), v.detach(), do, lse_r,
        FT.attention_delta(out_r, do), True)
    for t, ref in zip((q, k, v), refs):
        _close(t.grad, ref, 2 ** -6)
    # f32 q/k/v (a model outside auto_cast) run the general instance
    before = dict(FT.instance_launches)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    out = FT.flash_attention(qf, kf, vf, causal=True)
    _close_dtype(out, FT.flash_attention_fwd_ref(qf, kf, vf, True)[0])
    assert FT.instance_launches["forward.general"] \
        == before["forward.general"] + 1


# the general instance: (b, sq, sk, h, hk, d, causal, dtype)
FLASH_GENERAL = [
    (2, 256, 256, 8, 2, 128, True, torch.float32),
    (1, 128, 256, 4, 4, 64, True, torch.float16),
    (1, 256, 256, 4, 1, 16, True, torch.bfloat16),
    (2, 128, 128, 4, 2, 80, False, torch.bfloat16),
    (1, 256, 384, 8, 2, 96, True, torch.bfloat16),
    (1, 128, 128, 2, 1, 256, True, torch.bfloat16),
    (1, 128, 128, 2, 2, 8, False, torch.float32),
    (1, 128, 128, 4, 2, 200, True, torch.float16),
]


def _close_dtype(got, ref, floor=0.0):
    """Within 1 ulp of the dtype plus 2^-10 (2^-16 for f32) of the head
    vector's largest value (that value floored at ``floor`` x the
    tensor's)."""
    mant = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
    frac = 2 ** -16 if ref.dtype == torch.float32 else 2 ** -10
    e = mant[ref.dtype]
    ref, got = ref.float(), got.float()
    vec = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        floor * float(ref.abs().max()))
    _, ex = torch.frexp(ref)
    ulp = torch.where(ref == 0, torch.zeros_like(ref),
                      torch.ldexp(torch.ones_like(ref), ex - e))
    bad = (got - ref).abs() > ulp + frac * vec
    assert torch.isfinite(got).all() and not bool(bad.any()), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("case", FLASH_GENERAL)
def test_flash_general_instance_matches_plain(dev, case):
    b, sq, sk, h, hk, d, causal, dtype = case
    g = torch.Generator(dev).manual_seed(d + sq)
    kw = dict(device=dev, dtype=dtype, generator=g)
    q, do = torch.randn(b, sq, h, d, **kw), torch.randn(b, sq, h, d, **kw)
    k, v = torch.randn(b, sk, hk, d, **kw), torch.randn(b, sk, hk, d, **kw)
    scale = 1.0 / math.sqrt(d)
    before = dict(FT.instance_launches)
    out, lse = FT._launch_forward(q, k, v, causal, scale)
    out_r, lse_r = FT.flash_attention_fwd_ref(q, k, v, causal, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close_dtype(out, out_r)
    assert float((lse - lse_r).abs().max()) <= 1e-3
    delta = FT.attention_delta(out_r, do)
    grads = FT._launch_backward(q, k, v, do, lse_r, delta, causal, scale)
    refs = FT.flash_attention_bwd_ref(q, k, v, do, lse_r, delta, causal,
                                      scale)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        _close_dtype(got, ref, 2 ** -6)
    want = {k_: n + (k_.endswith("general")) for k_, n in before.items()}
    assert FT.instance_launches == want


@pytest.mark.parametrize("n,d,v", [(1, 64, 7), (45, 136, 1000),
                                   (128, 64, 513), (70, 32, 2048)])
def test_loss_kernel_matches_plain(dev, n, d, v):
    g = torch.Generator(dev).manual_seed(n + d + v)
    h = torch.randn(n, d, device=dev, generator=g)
    w = torch.randn(v, d, device=dev, generator=g) * 0.2
    lab = torch.randint(0, v, (n,), device=dev, generator=g)
    if n > 4:
        # ignored, past V, and past V inside the last tile's padding
        lab[:4] = torch.tensor([-100, v, v + 3, 1 << 20], device=dev)
    before = FC.launches
    lse, pick = FC._launch(h, w, lab)
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab, 64)
    assert FC.launches == before + 1
    for got, ref in ((lse, lse_r), (pick, pick_r)):
        assert float(((got - ref).abs() / ref.abs().clamp_min(1)).max()) \
            <= 1e-5
    if n > 4:
        assert not pick[:4].any()


def test_loss_autograd_on_the_card(dev):
    g = torch.Generator(dev).manual_seed(9)
    h = torch.randn(96, 64, device=dev, generator=g, requires_grad=True)
    w = (torch.randn(300, 64, device=dev, generator=g) * 0.2) \
        .requires_grad_()
    lab = torch.randint(0, 300, (96,), device=dev, generator=g)
    lab[::7] = -100
    loss = FC.fused_linear_cross_entropy(h, w, lab, vocab_chunk=128)
    loss.backward()
    lse, _ = FC.fused_linear_cross_entropy_ref(h.detach(), w.detach(), lab,
                                               128)
    gn = torch.ones(96, device=dev) / (lab != -100).float().sum()
    dh, dw = FC.linear_cross_entropy_backward(h.detach(), w.detach(), lab,
                                              lse, gn, 128, -100)
    torch.testing.assert_close(h.grad, dh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w.grad, dw, rtol=1e-5, atol=1e-6)


GROUPED = [  # e, c, k, n, group sizes
    (4, 40, 64, 128, [3, 0, 40, 17]),
    (4, 10, 72, 136, [12, 0, 1, 10]),      # gs > C, ragged K and N tiles
    (3, 5, 256, 64, [0, 0, 0]),             # every expert empty
    (2, 70, 32, 256, [70, 33]),             # three row tiles
]


def _grouped_inputs(dev, dtype, e, c, k, n, gs, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(e * c, k, device=dev, generator=g).to(dtype)
    w = (torch.randn(e, k, n, device=dev, generator=g) * 0.1).to(dtype)
    return x, w, torch.tensor(gs, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", GROUPED)
def test_grouped_gemm_kernel_matches_plain(dev, dtype, case):
    x, w, gs = _grouped_inputs(dev, dtype, *case)
    before = GG.launches["grouped_gemm"]
    y = GG.grouped_gemm(x, w, gs)
    assert GG.launches["grouped_gemm"] == before + 1
    ref = GG.grouped_gemm_ref(x, w, gs)
    _close_any(y, ref)
    e, c = case[0], case[1]
    y3 = y.reshape(e, c, -1)
    for ei, m in enumerate(case[4]):
        assert not y3[ei, min(m, c):].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_grouped_gemm_backward_on_the_card(dev, dtype):
    """y and dx launch the kernel (f16 x the general instance, whose dx
    reads the transposed weight through its strides); dw is the plain
    masked product."""
    e, c, k, n, gs = GROUPED[1]
    x, w, gs_t = _grouped_inputs(dev, dtype, e, c, k, n, gs, seed=1)
    x.requires_grad_()
    w.requires_grad_()
    g = torch.randn(e * c, n, device=dev, dtype=dtype)
    before = GG.launches["grouped_gemm"]
    GG.grouped_gemm(x, w, gs_t).backward(g)
    assert GG.launches["grouped_gemm"] == before + 2     # y, then dx
    _close_gemm(x.grad, GG.grouped_gemm_ref(g, w.detach().transpose(1, 2),
                                            gs_t))
    assert torch.equal(w.grad, GG.grouped_gemm_dw(x.detach(), g, gs_t,
                                                  w.dtype))


def test_grouped_gemm_rows_are_independent(dev):
    """A row's out is bit for bit the same whatever the other rows: rows
    0, 5 and 37 alone, then among 8 and among 64 rows of their expert."""
    g = torch.Generator(dev).manual_seed(4)
    w = torch.randn(2, 256, 128, device=dev, generator=g).bfloat16()
    rows = torch.randn(64, 256, device=dev, generator=g).bfloat16()
    x = torch.zeros(128, 256, device=dev, dtype=torch.bfloat16)
    x[:64] = rows
    for t in (8, 64):
        packed = GG.grouped_gemm(x, w, torch.tensor([t, 0], device=dev))
        for i in (0, 5, 37):
            if i >= t:
                continue
            one = torch.zeros_like(x)
            one[0] = rows[i]
            alone = GG.grouped_gemm(one, w, torch.tensor([1, 0], device=dev))
            assert torch.equal(alone[0], packed[i]), (i, t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,c,k,n,block,gs", [
    (4, 40, 128, 144, 32, [3, 0, 40, 17]),
    (4, 8, 256, 128, 128, [9, 0, 2, 8]),
    (2, 70, 64, 256, 64, [70, 1]),
    (3, 16, 200, 128, 64, [16, 5, 0])])     # K % B != 0: a ragged block
def test_grouped_gemm_q8_kernel_matches_plain(dev, dtype, e, c, k, n, block,
                                              gs):
    x, w, gs_t = _grouped_inputs(dev, dtype, e, c, k, n, gs, seed=2)
    q, s = quantize_weight(w, block)
    before = GG.launches["grouped_gemm_q8"]
    y = GG.grouped_gemm_q8(x, q, s, gs_t, block)
    assert GG.launches["grouped_gemm_q8"] == before + 1
    _close_any(y, GG.grouped_gemm_q8_ref(x, q, s, gs_t, block))


def _close_gemm(got, ref):
    """bf16 and f32 outs by :func:`_close_any`, f16 by
    :func:`_close_dtype`."""
    if ref.dtype == torch.float16:
        return _close_dtype(got, ref)
    return _close_any(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n,block", [(1, 256, 1024, 128),
                                         (8, 512, 48, 64),
                                         (45, 128, 256, 32),
                                         (64, 4096, 1024, 128),
                                         (100, 512, 256, 64)])
def test_dequant_matmul_kernel_matches_plain(dev, dtype, m, k, n, block):
    g = torch.Generator(dev).manual_seed(m + k + n)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    q, s = quantize_weight(torch.randn(k, n, device=dev, generator=g), block)
    inst = "dequant_matmul." + ("tile" if dtype == torch.float32
                                else "cluster")
    before, before_i = QK.launches, QK.instance_launches[inst]
    y = QK.dequant_matmul(x, q, s, block)
    assert QK.launches == before + 1
    _close_gemm(y, QK.dequant_matmul_ref(x, q, s, block))
    # a ragged last scale block (K % B != 0) launches the kernel too
    q2, s2 = quantize_weight(torch.randn(k - 8, n, device=dev, generator=g),
                             block)
    y2 = QK.dequant_matmul(x[:, :k - 8], q2, s2, block)
    assert QK.launches == before + 2
    assert QK.instance_launches[inst] == before_i + 2
    _close_gemm(y2, QK.dequant_matmul_ref(x[:, :k - 8], q2, s2, block))


@pytest.mark.parametrize("dtype,n,block", [
    (torch.bfloat16, 4096, 128), (torch.bfloat16, 1024, 128),
    (torch.float16, 4096, 128), (torch.float16, 1024, 128),
    (torch.bfloat16, 1024, 24)])        # the general instance
def test_dequant_matmul_rows_are_independent(dev, dtype, n, block):
    """Rows 0, 5 and 37 alone, then among 8 and among 64 rows: bitwise
    equal (the K split is a rule of K, N and the block, never of M; the
    general instance sums each out element in one K order)."""
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    g = torch.Generator(dev).manual_seed(n)
    x = (torch.randn(64, 4096, device=dev, generator=g) * 0.5).to(dtype)
    q, s = quantize_weight(torch.randn(4096, n, device=dev, generator=g)
                           * 0.02, block)
    inst = "dequant_matmul." + gemm_instance("dequant_matmul", dtype, 4096,
                                             n, block)
    before = QK.instance_launches[inst]
    alone = {i: QK.dequant_matmul(x[i:i + 1], q, s, block)[0]
             for i in (0, 5, 37)}
    assert QK.instance_launches[inst] == before + 3
    for t in (8, 64):
        packed = QK.dequant_matmul(x[:t], q, s, block)
        for i, y in alone.items():
            if i < t:
                assert torch.equal(y, packed[i]), (i, t)


# the general instance (C6): kernel, x dtype, (e, c,) m / k / n / block
GEMM_GENERAL = [
    ("dq", torch.float16, 5, 96, 64, 24),
    ("dq", torch.bfloat16, 9, 96, 64, 8),
    ("dq", torch.bfloat16, 70, 40, 24, 40),
    ("dq", torch.float32, 3, 37, 29, 16),
    ("dq", torch.bfloat16, 4, 120, 20, 24),
    ("gg", torch.float16, 3, 64, 48, None),
    ("gg", torch.bfloat16, 3, 40, 20, None),
    ("gg", torch.float32, 3, 37, 29, None),
    ("gg_q8", torch.float16, 3, 96, 64, 32),
    ("gg_q8", torch.bfloat16, 3, 96, 64, 24),
    ("gg_q8", torch.bfloat16, 3, 40, 24, 8),
    ("gg_q8", torch.float32, 3, 37, 29, 16),
    ("gg_q8", torch.bfloat16, 3, 128, 48, 40),
]


@pytest.mark.parametrize("case", GEMM_GENERAL)
def test_gemm_general_instance_matches_plain(dev, case):
    """The points of the reference's domain past the fast instances: f16
    x, blocks that are not multiples of 32 (or 16), N % 16 != 0, and K
    and N off multiples of 8; each launches its kernel's general
    instance (the dequant matmul's cluster instance where it takes the
    point) and stays within the plain version's tolerance."""
    kind, dtype, m, k, n, block = case
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    g = torch.Generator(dev).manual_seed(m + k + n)
    if kind == "dq":
        x = torch.randn(m, k, device=dev, generator=g).to(dtype)
        q, s = quantize_weight(torch.randn(k, n, device=dev, generator=g),
                               block)
        inst = "dequant_matmul." + gemm_instance("dequant_matmul", dtype, k,
                                                 n, block)
        before = QK.instance_launches[inst]
        y = QK.dequant_matmul(x, q, s, block)
        assert QK.instance_launches[inst] == before + 1
        return _close_gemm(y, QK.dequant_matmul_ref(x, q, s, block))
    gs = [m, 0, m + 3]
    c = m + 2
    x, w, gs_t = _grouped_inputs(dev, dtype, 3, c, k, n, gs, seed=m)
    if kind == "gg":
        assert gemm_instance("grouped_gemm", dtype, k, n) == "general"
        before = GG.instance_launches["grouped_gemm.general"]
        y = GG.grouped_gemm(x, w, gs_t)
        assert GG.instance_launches["grouped_gemm.general"] == before + 1
        ref = GG.grouped_gemm_ref(x, w, gs_t)
    else:
        q, s = quantize_weight(w, block)
        assert gemm_instance("grouped_gemm_q8", dtype, k, n,
                             block) == "general"
        before = GG.instance_launches["grouped_gemm_q8.general"]
        y = GG.grouped_gemm_q8(x, q, s, gs_t, block)
        assert GG.instance_launches["grouped_gemm_q8.general"] == before + 1
        ref = GG.grouped_gemm_q8_ref(x, q, s, gs_t, block)
    _close_gemm(y, ref)
    assert not y.reshape(3, c, n)[1].any()


def test_grouped_gemm_widens_mixed_dtypes(dev):
    """x and w of two dtypes run in f32 (exact), out in x's dtype, as
    the reference computes them; dx through the backward too."""
    x, w, gs = _grouped_inputs(dev, torch.bfloat16, 2, 8, 64, 32, [5, 8])
    w = w.float().requires_grad_()
    x.requires_grad_()
    y = GG.grouped_gemm(x, w, gs)
    assert y.dtype == torch.bfloat16
    _close_any(y, GG.grouped_gemm_ref(x.detach(), w.detach(), gs))
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


RPA = [  # hk, group, d, page, qblock, (prior context, [chunks]) per seq
    (2, 4, 128, 16, 16, [(5, [16, 7]), (40, [1]), (0, [3])]),
    (2, 4, 128, 16, 1, [(9, [1]), (63, [1]), (0, [1]), (200, [1])]),
    (1, 8, 64, 32, 8, [(30, [8, 8, 2]), (17, [1])]),
    (4, 2, 64, 16, 8, [(0, [8]), (100, [1]), (3, [5])]),
]


def _rpa_case(dev, hk, group, d, page, qb, seqs, seed,
              dtype=torch.bfloat16):
    """One dispatch on the card: each sequence's chunks as consecutive
    rows and packed tokens, an inactive row last, table tails poisoned,
    pools in ``dtype`` (and their int8 twins with scales). Returns (kw,
    written [P, page] bool, num_pages)."""
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    rng = np.random.RandomState(seed)
    n_pages = [-(-(p + sum(c)) // page) for p, c in seqs]
    num_pages = sum(n_pages) + 5
    perm = rng.permutation(num_pages - 1)
    rows, used, t = [], 0, 0
    for (prior, chunks), npg in zip(seqs, n_pages):
        pages = perm[used:used + npg]
        used += npg
        start = prior
        for c in chunks:
            rows.append((pages, start + c, start, c, prior, t,
                         prior + sum(chunks)))
            start += c
        t += sum(chunks)
    rows.append(((), 0, 0, 0, 0, 0, 0))
    width = max(n_pages) + 2
    tables = np.empty((len(rows), width), np.int32)
    written = np.zeros((num_pages, page), bool)
    for i, row in enumerate(rows):
        tables[i] = rng.choice([-3, 10 ** 6, num_pages + 2], width)
        tables[i, :len(row[0])] = row[0]
        for p in range(row[2], row[2] + row[3]):
            written[row[0][p // page], p % page] = True
    meta = np.asarray([r[1:] for r in rows], np.int32).T
    pos = np.concatenate([np.arange(s, s + n) for _, _, s, n, *_ in rows
                          if n > 0])
    g = torch.Generator(dev).manual_seed(seed)
    bf = dict(device=dev, dtype=dtype, generator=g)
    i32 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (tables, *meta)]
    sin, cos = RP.rope_tables(torch.from_numpy(pos).to(dev), d, 10000.0)
    k_pages = torch.randn(num_pages, hk, page, d, **bf)
    v_pages = torch.randn(num_pages, hk, page, d, **bf)
    kq, ks = quantize_kv_int8(k_pages)
    vq, vs = quantize_kv_int8(v_pages)
    kw = dict(q=torch.randn(t, hk * group, d, **bf),
              new_k=torch.randn(t, hk, d, **bf),
              new_v=torch.randn(t, hk, d, **bf), k_pages=k_pages,
              v_pages=v_pages, block_tables=i32[0], kv_lens=i32[1],
              q_starts=i32[2], q_lens=i32[3], w_starts=i32[4],
              w_flats=i32[5], w_ends=i32[6], dump_page=num_pages - 1,
              rope_sin=sin, rope_cos=cos, qblock=qb,
              q8=(kq, vq, ks[..., None], vs[..., None]))
    return kw, torch.from_numpy(written).to(dev), num_pages


def _variant_args(kw, variant):
    """The case's keyword arguments for one call of the family, with
    fresh copies of the pools (and sidecars)."""
    a = {k: v for k, v in kw.items() if k != "q8"}
    if variant.endswith("q8"):
        kq, vq, ks, vs = (x.clone() for x in kw["q8"])
        a.update(k_pages=kq, v_pages=vq, k_scale=ks, v_scale=vs)
    else:
        a.update(k_pages=a["k_pages"].clone(), v_pages=a["v_pages"].clone())
    if not variant.startswith("fused_rope"):
        # post-rope q in row blocks, as the fallback paths hand it over
        q = torch.zeros((a["block_tables"].shape[0], a["qblock"])
                        + tuple(a["q"].shape[1:]), dtype=a["q"].dtype,
                        device=a["q"].device)
        meta = [a[k].tolist() for k in ("q_starts", "q_lens", "w_starts",
                                        "w_flats")]
        for i, (qs, ql, ws, wf) in enumerate(zip(*meta)):
            q[i, :ql] = a["q"][wf + qs - ws:wf + qs - ws + ql]
        a["q"] = q
        for k in ("rope_sin", "rope_cos", "qblock"):
            del a[k]
    if variant.startswith("ragged"):
        for k in ("new_k", "new_v", "w_starts", "w_flats", "w_ends",
                  "dump_page"):
            del a[k]
    return a


VARIANTS = ["fused_rope", "fused_rope_q8", "fused", "fused_q8", "ragged",
            "ragged_q8"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", RPA)
def test_ragged_attention_family_matches_plain(dev, case, variant):
    _check_family(dev, case, variant, torch.bfloat16)


# the reference's domain past pages of 32 and head_dim 128, in every model
# dtype: hk, group, d, page, qblock, seqs, dtype
RPA_WIDE = [
    (2, 4, 128, 64, 16, [(5, [16, 7]), (100, [1]), (0, [3])],
     torch.bfloat16),
    (2, 4, 128, 16, 8, [(30, [8, 3]), (17, [1])], torch.float32),
    (1, 4, 256, 16, 8, [(9, [8, 2]), (63, [1])], torch.bfloat16),
    (2, 2, 72, 16, 8, [(40, [8, 1]), (3, [1])], torch.bfloat16),
    (2, 2, 64, 24, 8, [(50, [8]), (0, [5])], torch.float16),
    (1, 2, 256, 48, 4, [(97, [4, 4]), (10, [1])], torch.float32),
    (4, 2, 8, 8, 8, [(20, [8]), (5, [1])], torch.float16),
]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", RPA_WIDE)
def test_ragged_attention_widened_domain(dev, case, variant):
    _check_family(dev, case[:-1], variant, case[-1])


def _check_family(dev, case, variant, dtype):
    kw, written, num_pages = _rpa_case(dev, *case, seed=len(case[-1]),
                                       dtype=dtype)
    read_only = variant.startswith("ragged")
    fn, ref = (RP.ragged_paged_attention, RP.ragged_paged_attention_ref) \
        if read_only else (RP.fused_ragged_paged_attention,
                           RP.fused_ragged_paged_attention_ref)
    a_k, a_r = _variant_args(kw, variant), _variant_args(kw, variant)
    before = RP.launches[variant]
    out = fn(**a_k)
    assert RP.launches[variant] == before + (1 if read_only else 2)
    out_r = ref(**a_r)
    torch.cuda.synchronize()
    _close_dtype(out, out_r)
    # padded query rows and the inactive row are exact zeros
    assert not out[-1].any()
    for i, n in enumerate(kw["q_lens"].tolist()):
        assert not out[i, n:].any()
    hk, page = kw["k_pages"].shape[1:3]
    # [P, Hk, page] masks; the dump page is never written
    wr = written[:, None, :].expand(num_pages, hk, page)
    keep = ~wr
    names = ("k_pages", "v_pages") + (("k_scale", "v_scale")
                                      if variant.endswith("q8") else ())
    for name in names:
        got, want, orig = a_k[name], a_r[name], _variant_args(kw, variant)[
            name]
        assert torch.equal(got[keep], orig[keep]), name
        if read_only:
            assert torch.equal(got, orig), name
        elif name == "k_pages" and variant == "fused_rope":
            g, w = got[wr].float(), want[wr].float()
            e = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
            _, ex = torch.frexp(w)
            ulp = torch.ldexp(torch.ones_like(w), ex - e[dtype])
            assert bool(((g - w).abs() <= ulp).all())
        else:
            assert torch.equal(got[wr], want[wr]), name


def test_ragged_attention_rejects_what_it_cannot_take(dev):
    kw, _, _ = _rpa_case(dev, *RPA[0], seed=1)
    a = _variant_args(kw, "fused_q8")
    with pytest.raises(ValueError, match="int8 pools with scales"):
        RP.fused_ragged_paged_attention(**dict(a, k_scale=None,
                                               v_scale=None))
    # q of another dtype than the fresh K/V (f32 q is taken with f32 pools)
    with pytest.raises(ValueError, match="one dtype"):
        RP.fused_ragged_paged_attention(**dict(a, q=a["q"].float()))
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        RP.check_geometry(16, 128, torch.float64)
    b = _variant_args(kw, "ragged")
    with pytest.raises(ValueError, match="contiguous"):
        RP.ragged_paged_attention(**dict(b, q=b["q"].transpose(1, 2)
                                         .contiguous().transpose(1, 2)))


PAGED = [  # h, hk, d, page, pool dtype, q in f32
    (32, 8, 128, 16, torch.bfloat16, False),   # Llama-3-8B
    (32, 8, 128, 16, torch.bfloat16, True),
    (6, 1, 16, 8, torch.float32, False),       # the reference test's 6/1
    (4, 4, 64, 32, torch.float16, False),      # group 1
    (32, 1, 128, 16, torch.bfloat16, False),   # MQA, group 32
    (12, 2, 256, 8, torch.float16, True),      # group 6, head_dim 256
    (8, 2, 24, 16, torch.float32, False),
    (64, 2, 256, 32, torch.float32, False),    # the most shared memory
]


def _paged_case(dev, h, hk, d, page, dtype, q_f32, seed, ctxs=None,
                width=6):
    """Decode rows over a pool with seeded, distinct live pages and
    table tails poisoned with ids outside [0, P): by default an inactive
    row, one token, a page, a ragged context, the whole table and a
    context past it."""
    rng = np.random.RandomState(seed)
    if ctxs is None:
        ctxs = [0, 1, page, 3 * page + 5, width * page, width * page + 9,
                2 * page - 1]
    n_pages = [min(-(-c // page), width) for c in ctxs]
    num_pages = sum(n_pages) + 3
    perm = rng.permutation(num_pages)
    tables = np.empty((len(ctxs), width), np.int32)
    used = 0
    for i, n in enumerate(n_pages):
        tables[i] = rng.choice([-5, 10 ** 7, num_pages + 11], width)
        tables[i, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(dev).manual_seed(seed)
    qd = torch.float32 if q_f32 else dtype
    return dict(
        q=torch.randn(len(ctxs), h, d, device=dev, generator=g).to(qd),
        k_pages=torch.randn(num_pages, hk, page, d, device=dev,
                            generator=g).to(dtype),
        v_pages=torch.randn(num_pages, hk, page, d, device=dev,
                            generator=g).to(dtype),
        block_tables=torch.from_numpy(tables).to(dev),
        context_lens=torch.tensor(ctxs, dtype=torch.int32, device=dev))


def _close_paged(got, ref):
    if ref.dtype == torch.float16:
        ref, got = ref.float(), got.float()
        _, e = torch.frexp(ref)
        ulp = torch.where(ref == 0, torch.zeros_like(ref),
                          torch.ldexp(torch.ones_like(ref), e - 11))
        vec = ref.abs().amax(dim=-1, keepdim=True)
        assert torch.isfinite(got).all()
        assert not bool(((got - ref).abs() > ulp + 2 ** -10 * vec).any())
    else:
        _close_any(got, ref)


@pytest.mark.parametrize("case", PAGED)
def test_paged_attention_matches_plain(dev, case):
    a = _paged_case(dev, *case, seed=case[0] + case[2])
    before = PA.launches["paged"]
    out = PA.paged_attention(**a)
    assert PA.launches["paged"] == before + 1
    ref = PA.paged_attention_ref(**a)
    torch.cuda.synchronize()
    assert out.dtype == a["q"].dtype and out.shape == a["q"].shape
    _close_paged(out, ref)
    assert not out[0].any()                 # the inactive row
    # a context past the table attends the whole table
    capped = dict(a, context_lens=a["context_lens"].clamp_max(
        a["block_tables"].shape[1] * a["k_pages"].shape[2]))
    assert torch.equal(PA.paged_attention(**capped), out)
    # custom scale
    _close_paged(PA.paged_attention(**a, scale=0.05),
                 PA.paged_attention_ref(**a, scale=0.05))


def test_paged_attention_rows_are_independent(dev):
    """A row's output is bit for bit the same alone and inside a batch
    of 32, and from call to call."""
    rng = np.random.RandomState(3)
    ctxs = [0, 1] + rng.randint(1, 700, 30).tolist()
    a = _paged_case(dev, 32, 8, 128, 16, torch.bfloat16, False, 3, ctxs,
                    width=44)
    out = PA.paged_attention(**a)
    assert torch.equal(PA.paged_attention(**a), out)
    for i in (0, 1, 7, 31):
        alone = PA.paged_attention(
            a["q"][i:i + 1], a["k_pages"], a["v_pages"],
            a["block_tables"][i:i + 1], a["context_lens"][i:i + 1])
        assert torch.equal(alone[0], out[i]), i
    _close(out, PA.paged_attention_ref(**a))


def test_paged_attention_rejects_what_it_cannot_take(dev):
    a = _paged_case(dev, 32, 8, 128, 16, torch.bfloat16, False, 1)
    before = PA.launches["paged"]
    with pytest.raises(ValueError, match="preconditions not met"):
        PA.paged_attention(**dict(a, q=a["q"][:, :31]))
    with pytest.raises(ValueError, match="float32 pools"):
        PA.paged_attention(**dict(a, q=a["q"].half()))
    with pytest.raises(ValueError, match="float32 pools"):
        q8 = a["k_pages"].to(torch.int8)
        PA.paged_attention(**dict(a, k_pages=q8, v_pages=q8))
    with pytest.raises(ValueError, match="int32"):
        PA.paged_attention(**dict(a, block_tables=a["block_tables"].long()))
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_attention(**dict(a, q=a["q"].transpose(1, 2).contiguous()
                                  .transpose(1, 2)))
    big = torch.zeros(2, 1024, 256, device=dev)
    pool = torch.zeros(4, 2, 8, 256, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        PA.paged_attention(big, pool, pool, a["block_tables"][:2],
                           a["context_lens"][:2])
    assert not PA.supported(big, pool, pool, a["block_tables"][:2],
                            a["context_lens"][:2])
    assert PA.launches["paged"] == before


def test_paged_kv_cache_on_the_card(dev):
    from paddle_tpu_torch.inference import PagedKVCache
    cache = PagedKVCache(64, 16, 8, 128)
    assert cache.k_pages.is_cuda and cache.k_pages.dtype == torch.bfloat16
    g = torch.Generator(dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()
    for sid, n in enumerate((40, 1, 130)):
        cache.admit(sid, n)
        cache.write(sid, rand(n, 8, 128), rand(n, 8, 128))
    for _ in range(3):
        for sid in range(3):
            cache.extend(sid, 1)
            cache.write(sid, rand(1, 8, 128), rand(1, 8, 128))
        q = rand(3, 32, 128)
        before = PA.launches["paged"]
        out = cache.attend([0, 1, 2], q)
        assert PA.launches["paged"] == before + 1
        ref = cache.attend([0, 1, 2], q, use_kernel=False)
        assert PA.launches["paged"] == before + 1
        torch.cuda.synchronize()
        _close(out, ref)


def test_engine_checks_the_kernel_geometry_at_construction(dev):
    from paddle_tpu_torch.inference.serving import LlamaServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    model = LlamaForCausalLM(tiny_llama_config(), device=dev)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        LlamaServingEngine(model.double(), max_batch=2, page_size=8,
                           num_pages=16)
    # an f32 model at 64-slot pages is served by the kernels
    engine = LlamaServingEngine(model.float(), max_batch=2, page_size=64,
                                num_pages=16)
    before = dict(RP.launches)
    out = engine.generate([[1, 2, 3, 4, 5]], max_new_tokens=3)
    assert len(out[0]) == 3 and RP.launches != before
