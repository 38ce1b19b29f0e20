"""The training and MoE/int8 kernels against their plain versions on
the card, at small shapes and edge cases that ``chip_smoke.py`` does not
reach: head dim 64, GQA groups 1 and 4, non-causal and shorter-query
batches, the autograd path end to end, and the flash kernels' general
instance (f32, f16 and bf16 at head dims 8 to 256); the loss kernel's
two instances on ragged row tiles, D and vocab tails, labels outside
``[0, V)`` (in the padded tail too), in f32, bf16, f16 and mixed inputs,
rows bitwise the same alone and in a batch and two calls bitwise; the
grouped GEMMs (float and int8) on empty experts, ragged row, K and N
tails, group sizes past the stride, f32, bf16 and f16, 33-64 live rows of
an expert, and the backward's dx on the transposed weight (both cluster
instances, rows bitwise the same alone and among others); registers and
spills of the redesigned kernels; the dequant matmul at decode
and prefill row counts; a ragged last scale block in both int8 kernels;
every instance of the ragged paged attention family (rope-fused,
post-rope fused and read-only, over float and int8 pools) at head dims
8 to 256, pages of 8 to 64 slots and bf16, f16 and f32 models, with
multi-chunk rows, an inactive row and poisoned table tails, the write
launch alone bitwise against the plain write (pages of 8 to 256 slots,
head dims 8 to 256, a 600-token chunk, decode-only), and the engine's
geometry check at construction; the decode paged attention
kernel over bf16, f16, f32 and raw int8 pools (q in any float dtype) at
GQA groups 1, 4, 6, 32 and 512, head dims 16 to 256 and pages of 8, 16
and 32 slots, with inactive and one-token rows, poisoned table tails,
contexts past the table, int64 tables and lens and a strided q, rows of
one split and of many bitwise the same alone and in a batch, and
``PagedKVCache`` on the card; the sampler's Gumbel pass (``gumbel_noise``
bits and uniforms bit for bit the plain version's at vocabularies 1 to
128256, bases past 2^32 and negative seeds; ``gumbel_argmax`` tokens on
kept and cut rows, rows that keep nothing, NaN and -0 scores, more rows
than one grid column, bf16 and strided scores, rows alone and batched,
two calls bitwise).

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
products. The Gumbel noise within ``GUMBEL_REL`` (2^-13) of max(|g|, 1);
a token may differ from the plain version's only where the plain
version's top two perturbed scores lie within that tolerance.
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
from paddle_tpu_torch.ops import sampling as SM
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
    assert inst["forward.wgmma"] and inst["dq.wgmma"] and inst["dkv.wgmma"]


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


# the loss kernel's instances: n, d, v (d % 8 != 0: the general instance)
LOSS = [(1, 64, 7), (300, 200, 1000), (130, 40, 513), (77, 37, 300),
        (5, 9, 2048), (256, 4096, 600)]
LOSS_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
               (torch.bfloat16, torch.float16)]


def _loss_inputs(dev, n, d, v, dtype_h, dtype_w, seed=0):
    g = torch.Generator(dev).manual_seed(seed + n + d + v)
    h = torch.randn(n, d, device=dev, generator=g).to(dtype_h)
    w = (torch.randn(v, d, device=dev, generator=g) * 0.2).to(dtype_w)
    lab = torch.randint(0, v, (n,), device=dev, generator=g)
    if n > 4:
        lab[:4] = torch.tensor([-100, v, v + 3, 1 << 20], device=dev)
    return h, w, lab


@pytest.mark.parametrize("dtype_h,dtype_w", LOSS_DTYPES)
@pytest.mark.parametrize("case", LOSS)
def test_loss_kernel_instances_match_plain(dev, case, dtype_h, dtype_w):
    """Each instance (``kernel_instance``'s rule) at every dtype mix
    against the plain version on the same inputs: lse and pick within
    1e-5 of max(|x|, 1); ignored and out-of-range labels pick 0; int32
    labels as int64."""
    n, d, v = case
    h, w, lab = _loss_inputs(dev, n, d, v, dtype_h, dtype_w)
    inst = FC.kernel_instance(dtype_h, dtype_w, d)
    before = FC.instance_launches[inst]
    lse, pick = FC._launch(h, w, lab.to(torch.int32))
    assert FC.instance_launches[inst] == before + 1
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab, 64)
    for got, ref in ((lse, lse_r), (pick, pick_r)):
        assert torch.isfinite(got).all()
        assert float(((got - ref).abs() / ref.abs().clamp_min(1)).max()) \
            <= 1e-5
    if n > 4:
        assert not pick[:4].any()


@pytest.mark.parametrize("dtype_h,dtype_w", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16)])
def test_loss_kernel_rows_are_independent(dev, dtype_h, dtype_w):
    """Rows 0, 5, 130 and 299 alone and among 300 (three row tiles of
    the tensor-core instance): lse and pick bitwise equal; two calls
    bitwise equal (the vocab split and its merge order are fixed)."""
    h, w, lab = _loss_inputs(dev, 300, 512, 3000, dtype_h, dtype_w, seed=7)
    lse, pick = FC._launch(h, w, lab)
    lse2, pick2 = FC._launch(h, w, lab)
    assert torch.equal(lse, lse2) and torch.equal(pick, pick2)
    for i in (0, 5, 130, 299):
        one_lse, one_pick = FC._launch(h[i:i + 1], w, lab[i:i + 1])
        assert torch.equal(one_lse[0], lse[i]), i
        assert torch.equal(one_pick[0], pick[i]), i


def test_loss_autograd_16bit_on_the_card(dev):
    """bf16 hidden and weight through the autograd Function: the kernel
    forward, d_hidden and d_weight in their inputs' dtypes, against the
    plain path."""
    h, w, lab = _loss_inputs(dev, 96, 64, 300, torch.bfloat16,
                             torch.bfloat16, seed=3)
    grads = []
    for plain in (False, True):
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        if plain:
            lse, pick = FC.fused_linear_cross_entropy_ref(h, w, lab, 128)
            saved, FC._launch = FC._launch, lambda *a: (lse, pick)
        try:
            loss = FC.fused_linear_cross_entropy(hg, wg, lab, vocab_chunk=128)
            loss.backward()
        finally:
            if plain:
                FC._launch = saved
        grads.append((loss.detach(), hg.grad, wg.grad))
    (lk, dhk, dwk), (lp, dhp, dwp) = grads
    assert dhk.dtype == torch.bfloat16 and dwk.dtype == torch.bfloat16
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
    _close(dhk, dhp)
    _close(dwk, dwp)


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
    """y and dx launch the kernel (bf16 and f16 the cluster instance,
    whose dx reads the transposed weight K-contiguous through its
    strides; f32 the tile instance); dw is the plain masked product."""
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


@pytest.mark.parametrize("kind", ["float", "q8", "q8 f16", "float f16",
                                  "float dx"])
def test_grouped_gemm_rows_are_independent(dev, kind):
    """A row's out is bit for bit the same whatever the other rows: rows
    0, 5 and 37 alone, then among 8 and among 64 rows of their expert
    (both kernels' cluster instances, bf16 and f16 x, the float one on
    the stored and on the transposed weight; the narrow grid splits K
    over a cluster)."""
    g = torch.Generator(dev).manual_seed(4)
    dt = torch.float16 if kind.endswith("f16") else torch.bfloat16
    w = torch.randn(2, 256, 128, device=dev, generator=g).to(dt)
    rows = torch.randn(64, 256, device=dev, generator=g).to(dt)
    x = torch.zeros(128, 256, device=dev, dtype=dt)
    x[:64] = rows
    if kind == "float dx":
        wt = torch.randn(2, 128, 256, device=dev, generator=g).to(dt)
        run = lambda x, gs: GG.grouped_gemm(  # noqa: E731
            x, wt.transpose(1, 2), gs)
    elif kind.startswith("float"):
        run = lambda x, gs: GG.grouped_gemm(x, w, gs)  # noqa: E731
    else:
        q, s = quantize_weight(w.float(), 32)
        run = lambda x, gs: GG.grouped_gemm_q8(x, q, s, gs, 32)  # noqa
    for t in (8, 64):
        packed = run(x, torch.tensor([t, 0], device=dev))
        for i in (0, 5, 37):
            if i >= t:
                continue
            one = torch.zeros_like(x)
            one[0] = rows[i]
            alone = run(one, torch.tensor([1, 0], device=dev))
            assert torch.equal(alone[0], packed[i]), (i, t)


# the float kernel's cluster instance: e, c, k, n, group sizes
GROUPED_CLUSTER = [
    (8, 64, 512, 256, [64, 0, 33, 17, 50, 1, 0, 40]),   # 1-64 live rows
    (4, 10, 72, 136, [12, 0, 1, 10]),       # gs > C, ragged K and N tiles
    (3, 5, 256, 64, [0, 0, 0]),             # every expert empty
    (2, 70, 200, 128, [70, 65]),            # two row chunks, 65+ rows
    (8, 8, 4096, 1024, [8, 0, 3, 1, 0, 2, 1, 1]),   # K split
]


@pytest.mark.parametrize("layout", ["stored", "transposed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GROUPED_CLUSTER)
def test_grouped_gemm_float_cluster_instance_matches_plain(dev, dtype, case,
                                                           layout):
    """The float kernel's cluster instance against the plain version, on
    the stored [E, K, N] weight and on the transposed view of an [E, N,
    K] one (the backward's dx layout): outs within the dtype's bound,
    rows past each expert's size zero; one launch of the instance."""
    e, c, k, n, gs = case
    x, w, gs_t = _grouped_inputs(dev, dtype, e, c, k, n, gs, seed=8)
    if layout == "transposed":
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
        assert w.stride(1) == 1
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    assert gemm_instance("grouped_gemm", dtype, k, n) == "cluster"
    before = GG.instance_launches["grouped_gemm.cluster"]
    y = GG.grouped_gemm(x, w, gs_t)
    assert GG.instance_launches["grouped_gemm.cluster"] == before + 1
    assert y.dtype == dtype
    _close_gemm(y, GG.grouped_gemm_ref(x, w, gs_t))
    y3 = y.reshape(e, c, -1)
    for ei, m in enumerate(gs):
        assert not y3[ei, min(m, c):].any()


# the int8 kernel's cluster instance: e, c, k, n, block, group sizes
GROUPED_Q8 = [
    (8, 64, 512, 256, 128, [64, 0, 33, 17, 50, 1, 0, 40]),  # 33-64 live
    (4, 10, 72, 144, 16, [12, 0, 1, 10]),    # gs > C, ragged K, N 144
    (3, 5, 256, 64, 64, [0, 0, 0]),          # every expert empty
    (2, 70, 200, 128, 64, [70, 65]),         # two row chunks, ragged block
    (8, 8, 4096, 1024, 128, [8, 0, 3, 1, 0, 2, 1, 1]),   # K split
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GROUPED_Q8)
def test_grouped_gemm_q8_cluster_instance_matches_plain(dev, dtype, case):
    """The cluster instance against the plain version: outs within the
    dtype's bound, rows past each expert's size zero; one launch of the
    instance."""
    e, c, k, n, block, gs = case
    x, w, gs_t = _grouped_inputs(dev, dtype, e, c, k, n, gs, seed=6)
    q, s = quantize_weight(w.float(), block)
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    assert gemm_instance("grouped_gemm_q8", dtype, k, n, block) == "cluster"
    before = GG.instance_launches["grouped_gemm_q8.cluster"]
    y = GG.grouped_gemm_q8(x, q, s, gs_t, block)
    assert GG.instance_launches["grouped_gemm_q8.cluster"] == before + 1
    assert y.dtype == dtype
    _close_gemm(y, GG.grouped_gemm_q8_ref(x, q, s, gs_t, block))
    y3 = y.reshape(e, c, -1)
    for ei, m in enumerate(gs):
        assert not y3[ei, min(m, c):].any()


def test_redesigned_kernels_do_not_spill(dev):
    """The loss kernel's tensor-core instance, both grouped GEMMs'
    cluster instances and the ragged family's write launch (``ptxas -v``
    of their builds): no spill stores or loads in any instantiation."""
    from paddle_tpu_torch.ops import _build
    found = 0
    for lib, frag in (("fused_linear_cross_entropy", "linear_ce_fwd_tc"),
                      ("grouped_gemm", "q8_cluster_kernel"),
                      ("grouped_gemm", "float_cluster_kernel"),
                      ("ragged_paged_attention", "kv_write_kernel")):
        for name, what in _build.ptxas_report(lib).items():
            if frag in name:
                found += 1
                assert "spill stores 0 B, loads 0 B" in what, (name, what)
    assert found >= 4 + 6 + 12 + 12


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
    ("gg", torch.float16, 3, 60, 48, None),
    ("gg", torch.bfloat16, 3, 40, 20, None),
    ("gg", torch.float32, 3, 37, 29, None),
    ("gg_q8", torch.float16, 3, 96, 64, 24),
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


ROWS = ("block_tables", "kv_lens", "q_starts", "q_lens", "w_starts",
        "w_flats", "w_ends")


def _retyped(a, model=None, forms=False):
    """A call's arguments in the reference's other operand forms: q and
    the fresh K/V in the ``model`` dtype; with ``forms``, int64 rows, f64
    rope tables, bf16 read-only scale sidecars and a strided read-only
    q."""
    a = dict(a)
    if model is not None:
        for k in ("q", "new_k", "new_v"):
            if k in a:
                a[k] = a[k].to(model)
    if forms:
        for k in ROWS:
            if k in a:
                a[k] = a[k].long()
        for k in ("rope_sin", "rope_cos"):
            if k in a:
                a[k] = a[k].double()
        if "new_k" not in a:        # read only
            if "k_scale" in a:
                a["k_scale"] = a["k_scale"].bfloat16()
                a["v_scale"] = a["v_scale"].bfloat16()
            q = a["q"]
            a["q"] = torch.cat([q, q], dim=-1)[..., :q.shape[-1]]
    return a


def _check_family(dev, case, variant, dtype, model=None, forms=False):
    kw, written, num_pages = _rpa_case(dev, *case, seed=len(case[-1]),
                                       dtype=dtype)
    read_only = variant.startswith("ragged")
    fn, ref = (RP.ragged_paged_attention, RP.ragged_paged_attention_ref) \
        if read_only else (RP.fused_ragged_paged_attention,
                           RP.fused_ragged_paged_attention_ref)
    a_k, a_r = (_retyped(_variant_args(kw, variant), model, forms)
                for _ in range(2))
    before = RP.launches[variant]
    out = fn(**a_k)
    assert RP.launches[variant] == before + (1 if read_only else 2)
    out_r = ref(**a_r)
    torch.cuda.synchronize()
    assert out.dtype == a_k["q"].dtype
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
    orig_args = _retyped(_variant_args(kw, variant), model, forms)
    for name in names:
        got, want, orig = a_k[name], a_r[name], orig_args[name]
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


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pools,model", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float16)])
def test_ragged_attention_takes_mixed_dtypes(dev, variant, pools, model):
    """q and the fresh K/V in another float dtype than the pools' (C9):
    the reference computes in f32 from both and casts the fresh K/V to
    the pools' dtype (with rope, K after its rope through the model's
    dtype), so written slots stay the plain write's; the attention over
    float pools of another dtype is the general instance."""
    inst = "general" if not variant.endswith("q8") else \
        RP.attention_instance(model, RPA[0][2])
    before = RP.instance_launches[f"{variant}.{inst}"]
    _check_family(dev, RPA[0], variant, pools, model=model)
    assert RP.instance_launches[f"{variant}.{inst}"] == before + 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_ragged_attention_takes_the_reference_forms(dev, variant):
    """int64 rows, f64 rope tables, bf16 read-only sidecars and a strided
    read-only q, converted before the launch as the reference converts
    them (C9)."""
    _check_family(dev, RPA[1], variant, torch.bfloat16, forms=True)


# the write launch alone: hk, group, d, page, qblock, seqs, dtype; pages
# of 8-256 slots, head_dim 8-256, every model dtype, a 600-token chunk in
# one row and a decode-only batch
WRITE_DOMAIN = [
    (2, 2, 8, 8, 8, [(20, [8]), (5, [1])], torch.float16),
    (2, 4, 128, 16, 16, [(5, [16, 7]), (40, [1]), (0, [3])], torch.bfloat16),
    (2, 2, 72, 48, 8, [(40, [8, 1]), (3, [1])], torch.bfloat16),
    (1, 4, 256, 64, 8, [(9, [8, 2]), (63, [1])], torch.float32),
    (2, 2, 128, 256, 8, [(300, [1]), (10, [5])], torch.float16),
    (8, 4, 128, 16, 600, [(100, [600]), (30, [1])], torch.bfloat16),
    (8, 4, 128, 16, 1, [(9, [1]), (63, [1]), (0, [1]), (200, [1])],
     torch.bfloat16),
]


@pytest.mark.parametrize("variant", ["fused_rope", "fused_rope_q8", "fused",
                                     "fused_q8"])
@pytest.mark.parametrize("case", WRITE_DOMAIN)
def test_kv_write_launch_matches_plain_write(dev, case, variant):
    """The write launch alone against the plain version's write (the
    pools after ``fused_ragged_paged_attention_ref``): written slots
    (roped K, V, int8 slots) and their scales bit for bit, every other
    slot (the dump page included) unchanged."""
    kw, written, num_pages = _rpa_case(dev, *case[:-1], seed=len(case[-2]),
                                       dtype=case[-1])
    a_k, a_r = _variant_args(kw, variant), _variant_args(kw, variant)
    orig = _variant_args(kw, variant)
    meta = tuple(a_k[k] for k in ("kv_lens", "q_starts", "q_lens",
                                  "w_starts", "w_flats"))
    before = RP.launches[variant]
    RP._launch_write(RP._lib(), a_k["new_k"], a_k["new_v"], a_k["k_pages"],
                     a_k["v_pages"], a_k["block_tables"], meta,
                     a_k.get("k_scale"), a_k.get("v_scale"),
                     a_k.get("rope_sin"), a_k.get("rope_cos"))
    assert RP.launches[variant] == before + 1
    RP.fused_ragged_paged_attention_ref(**a_r)
    torch.cuda.synchronize()
    hk, page = kw["k_pages"].shape[1:3]
    keep = ~written[:, None, :].expand(num_pages, hk, page)
    for name in ("k_pages", "v_pages") + (
            ("k_scale", "v_scale") if variant.endswith("q8") else ()):
        assert torch.equal(a_k[name], a_r[name]), name
        assert torch.equal(a_k[name][keep], orig[name][keep]), name


def test_ragged_attention_rejects_what_it_cannot_take(dev):
    """What the fused calls write in place they neither copy nor convert
    (a stated difference): strided or misaligned pools and non-f32
    sidecars raise before any launch; the read-only forms run (C9)."""
    kw, _, _ = _rpa_case(dev, *RPA[0], seed=1)
    a = _variant_args(kw, "fused_q8")
    with pytest.raises(ValueError, match="int8 pools with scales"):
        RP.fused_ragged_paged_attention(**dict(a, k_scale=None,
                                               v_scale=None))
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        RP.check_geometry(16, 128, torch.float64)
    before = dict(RP.launches)
    with pytest.raises(ValueError, match="float32 sidecars"):
        RP.fused_ragged_paged_attention(**dict(
            a, k_scale=a["k_scale"].bfloat16(),
            v_scale=a["v_scale"].bfloat16()))
    f = _variant_args(kw, "fused")
    wide = torch.cat([f["k_pages"], f["k_pages"]], dim=-1)
    with pytest.raises(ValueError, match="in place"):
        RP.fused_ragged_paged_attention(**dict(
            f, k_pages=wide[..., :f["k_pages"].shape[-1]]))
    flat = torch.empty(f["k_pages"].numel() + 1, dtype=torch.bfloat16,
                       device=dev)
    odd = flat[1:].view(f["k_pages"].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        RP.fused_ragged_paged_attention(**dict(f, k_pages=odd))
    assert RP.launches == before
    # a q of another dtype than the fresh K/V is taken now
    out = RP.fused_ragged_paged_attention(**dict(a, q=a["q"].float()))
    assert out.dtype == torch.float32
    b = _variant_args(kw, "ragged")
    out = RP.ragged_paged_attention(**dict(b, q=b["q"].transpose(1, 2)
                                           .contiguous().transpose(1, 2)))
    _close_dtype(out, RP.ragged_paged_attention_ref(**b))


# the tensor-core instance (bf16 and f16 at head_dim % 16 == 0): rows
# whose contexts cross several splits (256 keys per busy warp) and end
# inside a page, a prefill row, a one-token row and the inactive row
RPA_TC_SEQS = [(2900, [1]), (1100, [16, 5]), (0, [3]), (700, [1]),
               (255, [1])]


# 80 and 144: an odd count of 16-column groups, and rows whose 16-byte
# units do not divide the block (the copies' general loop)
@pytest.mark.parametrize("d", [64, 80, 128, 144, 256])
@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("variant", ["fused_rope", "fused_rope_q8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_attention_tensor_core_instance(dev, dtype, variant, page, d):
    """Float and int8 pools through the tensor-core instance against the
    plain version (the int8 scales factored out of the products: within
    the same bound), with the write's slots as the family's test."""
    assert RP.attention_instance(dtype, d) == "tensor-core"
    before = RP.instance_launches[f"{variant}.tensor-core"]
    _check_family(dev, (2, 4, d, page, 16, RPA_TC_SEQS), variant, dtype)
    assert RP.instance_launches[f"{variant}.tensor-core"] == before + 1


@pytest.mark.parametrize("variant", ["ragged", "ragged_q8"])
def test_ragged_attention_rows_are_independent(dev, variant):
    """A row's output is bit for bit the same alone and among the
    dispatch's other rows (the split depends on the row alone), and from
    call to call."""
    seqs = [(1900, [1]), (40, [16, 9]), (600, [1]), (0, [5]), (3000, [1])]
    kw, _, _ = _rpa_case(dev, 2, 4, 128, 16, 16, seqs, seed=5)
    a = _variant_args(kw, variant)
    out = RP.ragged_paged_attention(**a)
    assert torch.equal(RP.ragged_paged_attention(**a), out)
    rows = ("q", "block_tables", "kv_lens", "q_starts", "q_lens")
    for i in range(a["block_tables"].shape[0]):
        alone = RP.ragged_paged_attention(
            **{k: (v[i:i + 1] if k in rows else v) for k, v in a.items()})
        assert torch.equal(alone[0], out[i]), i
    _close_dtype(out, RP.ragged_paged_attention_ref(**a))


def test_ragged_attention_is_bitwise_across_calls(dev):
    """Two fused calls on the same inputs (the slots they write are the
    same values) agree bit for bit: the splits merge in one order, with
    no atomics."""
    kw, _, _ = _rpa_case(dev, 2, 4, 128, 16, 16, RPA_TC_SEQS, seed=7)
    a = _variant_args(kw, "fused_rope_q8")
    before = RP.instance_launches["fused_rope_q8.tensor-core"]
    out1 = RP.fused_ragged_paged_attention(**a)
    out2 = RP.fused_ragged_paged_attention(**a)
    assert RP.instance_launches["fused_rope_q8.tensor-core"] == before + 2
    assert torch.equal(out1, out2)


def test_flash_dq_is_bitwise_across_calls(dev):
    """dQ sums each q tile's keys in registers in one fixed order (no
    atomics): two launches on the same inputs agree bit for bit."""
    g = torch.Generator(dev).manual_seed(12)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q, do = torch.randn(2, 384, 8, 128, **bf), torch.randn(2, 384, 8, 128, **bf)
    k, v = torch.randn(2, 384, 2, 128, **bf), torch.randn(2, 384, 2, 128, **bf)
    out, lse = FT.flash_attention_fwd_ref(q, k, v, True)
    args = (q, k, v, do, lse, FT.attention_delta(out, do), True, 128 ** -0.5)
    before = FT.instance_launches["dq.wgmma"]
    dq1 = FT._launch_dq(*args)
    dq2 = FT._launch_dq(*args)
    assert FT.instance_launches["dq.wgmma"] == before + 2
    assert torch.equal(dq1, dq2)


PAGED = [  # h, hk, d, page, pool dtype, q dtype (None: the pools'), form
    (32, 8, 128, 16, torch.bfloat16, None, None),   # Llama-3-8B
    (32, 8, 128, 16, torch.bfloat16, torch.float32, None),
    (6, 1, 16, 8, torch.float32, None, None),       # the reference test's 6/1
    (4, 4, 64, 32, torch.float16, None, None),      # group 1
    (32, 1, 128, 16, torch.bfloat16, None, None),   # MQA, group 32: 2 tiles
    (12, 2, 256, 8, torch.float16, torch.float32, None),  # group 6, d 256
    (8, 2, 24, 16, torch.float32, None, None),
    (64, 2, 256, 32, torch.float32, None, None),
    (8, 2, 72, 8, torch.float16, None, None),       # d % 16 == 8 on mma
    # the reference's operand forms (C9)
    (32, 8, 128, 16, torch.bfloat16, None, "int64"),
    (32, 8, 128, 16, torch.bfloat16, None, "strided q"),
    (32, 8, 128, 16, torch.float32, torch.bfloat16, None),
    (32, 8, 128, 16, torch.float16, torch.bfloat16, None),
    (32, 8, 128, 16, torch.int8, torch.bfloat16, None),   # raw int8 pools
    (8, 2, 40, 8, torch.int8, torch.float32, None),
    (1024, 2, 256, 8, torch.float32, None, None),   # group 512
]


def _paged_case(dev, h, hk, d, page, dtype, q_dtype, seed, ctxs=None,
                width=6):
    """Decode rows over a pool with seeded, distinct live pages and
    table tails poisoned with ids outside [0, P): by default an inactive
    row, one token, a page, a ragged context, the whole table and a
    context past it. int8 pools hold random values in [-127, 127]."""
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

    def pool():
        shape = (num_pages, hk, page, d)
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, device=dev, generator=g,
                                 dtype=torch.int8)
        return torch.randn(*shape, device=dev, generator=g).to(dtype)
    q = torch.randn(len(ctxs), h, d, device=dev, generator=g)
    if dtype == torch.int8:
        q = q / 16          # scores of int8 keys stay within exp's range
    return dict(q=q.to(q_dtype or dtype), k_pages=pool(), v_pages=pool(),
                block_tables=torch.from_numpy(tables).to(dev),
                context_lens=torch.tensor(ctxs, dtype=torch.int32,
                                          device=dev))


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


def _paged_form(a, form):
    """The operands in one of the reference's other forms: int64 tables
    and lens, or q a strided view."""
    if form == "int64":
        return dict(a, block_tables=a["block_tables"].long(),
                    context_lens=a["context_lens"].long())
    if form == "strided q":
        q = a["q"]
        return dict(a, q=torch.cat([q, q], dim=-1)[..., :q.shape[-1]])
    return a


@pytest.mark.parametrize("case", PAGED)
def test_paged_attention_matches_plain(dev, case):
    *geom, form = case
    a = _paged_form(_paged_case(dev, *geom, seed=case[0] + case[2]), form)
    assert form != "strided q" or not a["q"].is_contiguous()
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_rows_are_independent(dev, dtype):
    """A row's output is bit for bit the same alone and inside a batch
    of 32, and from call to call, rows of one split and of many (splits
    of 128 keys up to 512, of 256 up to 1024, of 512 past) alike."""
    rng = np.random.RandomState(3)
    ctxs = [0, 1, 257, 1025, 3000] + rng.randint(1, 700, 27).tolist()
    a = _paged_case(dev, 32, 8, 128, 16, dtype, None, 3, ctxs, width=200)
    out = PA.paged_attention(**a)
    assert torch.equal(PA.paged_attention(**a), out)
    for i in (0, 1, 2, 3, 4, 7, 31):
        alone = PA.paged_attention(
            a["q"][i:i + 1], a["k_pages"], a["v_pages"],
            a["block_tables"][i:i + 1], a["context_lens"][i:i + 1])
        assert torch.equal(alone[0], out[i]), i
    _close_any(out, PA.paged_attention_ref(**a))


def test_paged_attention_rejects_what_it_cannot_take(dev):
    """Outside the reference's rule the call raises before any launch;
    every form the reference converts runs in one launch (C9)."""
    a = _paged_case(dev, 32, 8, 128, 16, torch.bfloat16, None, 1)
    before = PA.launches["paged"]
    with pytest.raises(ValueError, match="preconditions not met"):
        PA.paged_attention(**dict(a, q=a["q"][:, :31]))
    with pytest.raises(ValueError, match="integers"):
        PA.paged_attention(**dict(a, block_tables=a["block_tables"].float()))
    with pytest.raises(ValueError, match="one dtype"):
        PA.paged_attention(**dict(a, v_pages=a["v_pages"].half()))
    assert PA.launches["paged"] == before
    q8 = a["k_pages"].to(torch.int8)
    big = torch.randn(2, 1024, 256, device=dev)
    pool = torch.randn(4, 2, 8, 256, device=dev)
    for kw in (dict(a, q=a["q"].half()),
               dict(a, k_pages=q8, v_pages=q8),
               dict(a, block_tables=a["block_tables"].long()),
               dict(a, q=a["q"].transpose(1, 2).contiguous()
                    .transpose(1, 2)),
               dict(q=big, k_pages=pool, v_pages=pool,
                    block_tables=a["block_tables"][:2] % 4,
                    context_lens=a["context_lens"][:2])):
        assert PA.supported(**kw)
        out = PA.paged_attention(**kw)
        assert PA.launches["paged"] == before + 1
        before += 1
        _close_paged(out, PA.paged_attention_ref(**kw))


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


# ----------------------------------------------------------------------
# the sampler's Gumbel pass
# ----------------------------------------------------------------------

def _gumbel_rows(dev, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g)
    folds = torch.randint(0, 2 ** 31, (n,), generator=g)
    return seeds.to(dev), folds.to(dev)


@pytest.mark.parametrize("v", [1, 2047, 2048, 2049, 32000, 128256])
def test_gumbel_noise_bit_for_bit(dev, v):
    seeds, folds = _gumbel_rows(dev, 5, v)
    bases = torch.tensor([0, v, 2 ** 32 - 3, 2 ** 33 + 5, 7 * v],
                         device=dev)
    before = SM.launches["gumbel_noise"]
    bits, u, g = SM.gumbel_noise(seeds, folds, bases, v)
    assert SM.launches["gumbel_noise"] == before + 1
    rb, ru, rg = SM.gumbel_noise_ref(seeds, folds, bases, v)
    torch.cuda.synchronize()
    assert torch.equal(bits, rb)
    assert torch.equal(u.view(torch.int32), ru.view(torch.int32))
    err = ((g - rg).abs() / rg.abs().clamp_min(1.0)).max()
    assert float(err) <= SM.GUMBEL_REL


def _tokens_ok(got, scores, seeds, folds, bases, thr):
    """Kernel tokens against the plain version's: equal, or within the
    Gumbel tolerance of the plain version's best perturbed score."""
    z = SM.perturbed_scores(scores, seeds, folds, bases, thr)
    want = z.argmax(dim=-1)
    rows = torch.nonzero(got != want)[:, 0]
    for i in rows.tolist():
        a, b = float(z[i, want[i]]), float(z[i, got[i]])
        assert 0.0 <= a - b <= 2 * SM.GUMBEL_REL * 17.0 + 1e-5 * abs(a), \
            (i, a, b)
    return want


@pytest.mark.parametrize("n,v", [(1, 5), (8, 32000), (8, 128256),
                                 (70, 4099), (300, 1000)])
def test_gumbel_argmax_against_the_plain_version(dev, n, v):
    g = torch.Generator(dev).manual_seed(n + v)
    scores = torch.randn((n, v), device=dev, generator=g) * 3
    seeds, folds = _gumbel_rows(dev, n, n)
    bases = torch.arange(n, device=dev) * v
    # thresholds: keep all, keep the top part, keep nothing
    q = scores.quantile(0.9, dim=-1) if v > 1 else scores[:, 0]
    thr = torch.where(torch.arange(n, device=dev) % 3 == 0,
                      torch.full_like(q, float("-inf")), q)
    thr[n - 1] = float("inf")
    scores[0, v // 2] = float("nan")         # never kept
    scores[n // 2, 0] = -0.0
    before = SM.launches["gumbel_argmax"]
    got = SM.gumbel_argmax(scores, seeds, folds, bases, thr)
    again = SM.gumbel_argmax(scores, seeds, folds, bases, thr)
    assert SM.launches["gumbel_argmax"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _tokens_ok(got, scores, seeds, folds, bases, thr)
    assert int(got[n - 1]) == 0               # nothing kept
    # every row alone is the row in the batch
    for i in {0, n // 2, n - 1}:
        one = SM.gumbel_argmax(scores[i:i + 1], seeds[i:i + 1],
                               folds[i:i + 1], bases[i:i + 1],
                               thr[i:i + 1])
        assert int(one) == int(got[i])


def test_gumbel_argmax_converts_its_operands(dev):
    """bf16 and strided scores, int64 seeds and folds: converted, one
    launch each, the same tokens as the f32 contiguous call."""
    g = torch.Generator(dev).manual_seed(3)
    wide = torch.randn((6, 2 * 3000), device=dev, generator=g)
    scores = wide[:, ::2]
    seeds, folds = _gumbel_rows(dev, 6, 4)
    bases = torch.zeros(6, dtype=torch.int32, device=dev)
    thr = torch.full((6,), float("-inf"), device=dev)
    want = SM.gumbel_argmax(scores.contiguous(), seeds, folds, bases, thr)
    assert torch.equal(SM.gumbel_argmax(scores, seeds, folds, bases, thr),
                       want)
    lb = scores.bfloat16()
    assert torch.equal(SM.gumbel_argmax(lb, seeds, folds, bases, thr),
                       SM.gumbel_argmax(lb.float(), seeds, folds, bases,
                                        thr))
    with pytest.raises(ValueError, match="integers"):
        SM.gumbel_argmax(scores, seeds.float(), folds, bases, thr)


# ----------------------------------------------------------------------
# CUDA-graph decode: the engine's tick and generate's step
# ----------------------------------------------------------------------

def _tick_state(engine):
    """Everything a tick writes: the scan's carry, out and tick counter,
    the pools and the scale sidecars."""
    g = engine._graphs.buffers
    return [g[k] for k in ("tokens", "lens", "out", "tick")] \
        + engine.k_pools + engine.v_pools + engine.k_scales + engine.v_scales


def _replayed_and_eager_tick(engine, mode):
    """One tick of ``mode`` over the engine's live requests: replayed from
    its graph, then (from the same state) the tick function run eagerly on
    the same static buffers. Returns both end states."""
    live = [r for r in engine._live.values() if not r.done]
    engine._ensure_tick(mode)
    starts = [engine.alloc.extend(r.seq_id, 1) for r in live]
    engine._load_scan(live, starts, mode, *engine._scan_rows(live))
    state = _tick_state(engine)
    before = [t.clone() for t in state]
    engine._run_tick(mode)
    replayed = [t.clone() for t in state]
    for t, b in zip(state, before):
        t.copy_(b)
    engine._tick(mode)
    torch.cuda.synchronize()
    return replayed, [t.clone() for t in state]


@pytest.mark.parametrize("kw", [{}, {"fused_rope": False},
                                {"fused_kv": False}, {"kv_dtype": "int8"}])
def test_decode_tick_graph_is_the_eager_tick(dev, kw):
    """A replayed tick graph is bit for bit the tick function run eagerly
    at the same padded shape, in each mode (greedy, bias only, sampled):
    next tokens, lens and every pool slot and scale."""
    from paddle_tpu_torch.inference import SamplingParams
    from paddle_tpu_torch.inference.serving import LlamaServingEngine, Request
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    model = LlamaForCausalLM(tiny_llama_config(), device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(0))
    engine = LlamaServingEngine(model, max_batch=4, page_size=8,
                                num_pages=48, **kw)
    sps = (None, SamplingParams(logit_bias={5: 3.0}),
           SamplingParams(temperature=0.9, top_p=0.9, seed=3))
    for i, sp in enumerate(sps):
        engine.add_request(Request(list(range(3 + 5 * i)), 20, sampling=sp))
    for mode in ("greedy", "bias", "sampled"):
        replayed, eager = _replayed_and_eager_tick(engine, mode)
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b), mode
    assert all(m in engine._graphs for m in ("greedy", "bias", "sampled"))


def test_failed_capture_raises_and_leaves_the_stream(dev):
    """A step that reads the device on the host cannot be captured: the
    helper raises what the capture raised, restores the current stream,
    and a good step still captures and replays."""
    from paddle_tpu_torch.ops._graphs import StepGraphs
    steps = StepGraphs(dev)
    x = steps.buffer("x", (8,), torch.float32)
    stream = torch.cuda.current_stream(dev)
    with pytest.raises(RuntimeError):
        steps.capture("bad", lambda: x.add_(float(x.sum().item())))
    assert torch.cuda.current_stream(dev) == stream and "bad" not in steps
    x.fill_(1.0)
    steps.capture("good", lambda: x.mul_(2.0))   # the warm-up runs: 2
    steps.replay("good")
    steps.replay("good")
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 8.0))


def test_generate_graph_is_the_eager_step(dev):
    """``generate``'s replayed decode step gives the tokens of the decode
    loop run eagerly over host ints, bit for bit, greedy and sampled."""
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    model = LlamaForCausalLM(tiny_llama_config(), device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(1))
    ids = torch.randint(0, 128, (3, 9), device=dev,
                        generator=torch.Generator(dev).manual_seed(2))
    for kw, sampler in ((dict(), (False, None, None, 1.0)),
                        (dict(do_sample=True, top_k=8, top_p=0.9, seed=4),
                         (True, 8, 0.9, 1.0))):
        got = model.generate(ids, max_new_tokens=12, **kw)
        caches = model._empty_caches(3, 64)
        tokens, length, out = ids, 0, []
        with torch.no_grad():
            for i in range(12):
                tokens, length, caches = model._decode_step(
                    tokens, length, caches, (kw.get("seed", 0), i), sampler)
                out.append(tokens)
        assert torch.equal(got, torch.cat([ids] + out, dim=1))


def test_generate_graph_follows_the_weights(dev):
    """After ``model.float()`` (the same parameter objects over new
    storage) ``generate`` captures its step anew: its tokens are the
    decode loop's run eagerly on the float weights, bit for bit, and the
    graph of the bf16 weights is freed."""
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    model = LlamaForCausalLM(tiny_llama_config(), device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(5))
    ids = torch.randint(0, 128, (2, 7), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    model.generate(ids, max_new_tokens=10)
    _, bf16 = model._decode_state
    model.float()
    got = model.generate(ids, max_new_tokens=10)
    _, f32 = model._decode_state
    assert f32 is not bf16 and f32.buffers["k0"].dtype == torch.float32
    caches = model._empty_caches(2, 64)
    tokens, length, out = ids, 0, []
    with torch.no_grad():
        for i in range(10):
            tokens, length, caches = model._decode_step(
                tokens, length, caches, (0, i), (False, None, None, 1.0))
            out.append(tokens)
    assert torch.equal(got, torch.cat([ids] + out, dim=1))
