"""Grouped GEMM over expert-contiguous ragged row blocks (port of
``paddle_tpu/ops/grouped_gemm.py``), float and int8 weights.

Shapes (E experts, stride C rows per expert, M = E * C rows):

  x            [M, K]     expert ``e`` owns rows ``[e*C, (e+1)*C)``; only
                          the first ``clip(group_sizes[e], 0, C)`` are real
  w            [E, K, N]  stacked per-expert weights
  group_sizes  [E] int    real rows per expert, on x's device
  -> y         [M, N]     y[e*C + i] = x[e*C + i] @ w[e] for i < the
                          expert's real rows, else 0

f32 accumulation, out in x's dtype. The int8 variant takes ``w_q [E, K,
N]`` int8 and ``scales [E, ceil(K/B), N]`` f32 and computes the same
against ``w_q * scales[e, k // B, n]``.

On CUDA tensors :func:`grouped_gemm` and :func:`grouped_gemm_q8` launch
the hand-written kernels of ``csrc/grouped_gemm.cu``, which read the
group sizes on the device (no host sync) and skip dead tiles; on CPU
tensors they run the plain versions :func:`grouped_gemm_ref` and
:func:`grouped_gemm_q8_ref`. Each out row depends only on its own x row,
bit for bit, on the card.

The kernels take the reference's kernel domain (:func:`supported`,
:func:`supported_q8`) and every shape its public functions take: one
rule, ``ops._tile_gemm.gemm_instance``, sends 16-bit x to each kernel's
cluster instance (the float kernel's at K % 8 and N % 8 zero: 16-bit
weights by TMA with no conversion; the int8 kernel's at K % 8, N % 16
and B % 16 zero: int8 converted in registers; both read each weight
byte once per expert), f32 x to the tile instances (the float kernel's
at K % 8 and N % 8 zero, the int8 kernel's at K % 8, N % 16 and B % 32
zero), and the rest (any K, N, B >= 1) to the general instance (f32
FMAs).
x and w of two dtypes are widened to f32 (exact) and the out cast to
x's dtype, as the reference computes them. :func:`grouped_gemm` is differentiable: dx is
the same grouped product against ``w`` transposed (read through its
strides, never copied), dw the masked f32 batched product
:func:`grouped_gemm_dw`.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.format import dequant_blocks
from . import _build
from ._tile_gemm import (CLUSTER_DEPTH, INSTANCES, gemm_instance,
                         split_count)

__all__ = ["grouped_gemm", "grouped_gemm_ref", "grouped_gemm_dw",
           "grouped_gemm_q8", "grouped_gemm_q8_ref", "supported",
           "supported_q8"]

#: kernel launches on the CUDA path, per kernel
launches = _build.counter(("grouped_gemm", "grouped_gemm_q8"))
#: the same launches by kernel and instance (``gemm_instance``)
instance_launches = _build.counter(f"{k}.{i}" for k in launches
                                   for i in INSTANCES[k])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

def _geometry(x, w, group_sizes):
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("expected x [M, K], w [E, K, N] and group_sizes "
                         f"[E]; got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    m, k = x.shape
    e, kw, n = w.shape
    if e == 0 or group_sizes.shape[0] != e or kw != k or m % e:
        raise ValueError(f"inconsistent shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} (M must be E * C)")
    if len({x.device, w.device, group_sizes.device}) != 1:
        raise ValueError("x, w and group_sizes must share one device")
    return e, m // e, k, n


def supported(x, w, group_sizes):
    """The reference's kernel rule without its TPU and VMEM clauses: x
    ``[M, K]`` in f32, f16 or bf16 with M a positive multiple of E, w
    ``[E, K, N]``, group_sizes ``[E]``, K % 8 == 0 and N % 8 == 0. The
    kernels take every other shape the public function takes too (the
    general instance)."""
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        return False
    m, k = x.shape
    e, kw, n = w.shape
    if e == 0 or group_sizes.shape[0] != e or kw != k:
        return False
    if m == 0 or m % e or x.dtype not in _DTYPES:
        return False
    return k % 8 == 0 and n % 8 == 0


def supported_q8(x, w_q, scales, group_sizes, block):
    """:func:`supported`'s rule for the int8 kernel, plus int8 weights,
    a block B >= 1 and f32 scales ``[E, ceil(K/B), N]``: the reference's
    rule, which also needs K % B == 0 (a ragged last block is taken
    here). The kernels take every other shape the public function takes
    too."""
    if not supported(x, w_q, group_sizes) or scales.dim() != 3:
        return False
    e, k, n = w_q.shape
    b = int(block)
    if b <= 0 or tuple(scales.shape) != (e, -(-k // b), n):
        return False
    return w_q.dtype == torch.int8 and scales.dtype == torch.float32


def _masked(x, e, c, gs):
    """``x`` as ``[E, C, K]`` f32 with rows at or past each expert's
    (clamped) size set to zero."""
    gs = gs.long().clamp(0, c)
    mask = torch.arange(c, device=x.device)[None, :] < gs[:, None]
    return torch.where(mask[..., None], x.reshape(e, c, -1).float(),
                       torch.zeros((), device=x.device))


def grouped_gemm_ref(x, w, group_sizes):
    """The plain version: mask each expert's padding rows, one f32
    batched product against the stacked weights, cast to x's dtype."""
    e, c, k, n = _geometry(x, w, group_sizes)
    y = torch.bmm(_masked(x, e, c, group_sizes), w.float())
    return y.to(x.dtype).reshape(e * c, n)


def grouped_gemm_q8_ref(x, w_q, scales, group_sizes, block):
    """The plain int8 version: dequantize the stacked weights to f32
    (the reference's expression), then :func:`grouped_gemm_ref`'s
    masked f32 product."""
    e, c, k, n = _geometry(x, w_q, group_sizes)
    w = dequant_blocks(w_q, scales, int(block))
    y = torch.bmm(_masked(x, e, c, group_sizes), w)
    return y.to(x.dtype).reshape(e * c, n)


def grouped_gemm_dw(x, g, group_sizes, dtype):
    """The weight gradient of :func:`grouped_gemm`: ``dw[e] = x[e]^T @
    g[e]`` over each expert's real rows, in f32, cast to ``dtype``. A
    plain batched product on either device (the reference leaves it
    outside its kernel too)."""
    e = group_sizes.shape[0]
    c = x.shape[0] // e
    return torch.bmm(_masked(x, e, c, group_sizes).transpose(1, 2),
                     _masked(g, e, c, group_sizes)).to(dtype)


def _lib():
    lib = _build.load("grouped_gemm")
    if not getattr(lib, "_gg_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gg_forward.argtypes = [i32] + [vp] * 4 + [i32] * 4 + [i64] * 3 \
            + [i32, i32, vp]
        lib.gg_forward.restype = i32
        lib.gg_q8_forward.argtypes = [i32] + [vp] * 5 + [i32] * 7 + [vp]
        lib.gg_q8_forward.restype = i32
        lib.gg_error_string.argtypes = [i32]
        lib.gg_error_string.restype = ctypes.c_char_p
        lib._gg_typed = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gg_error_string(rc).decode()})")


def _count(kernel, inst):
    launches[kernel] += 1
    instance_launches[f"{kernel}.{inst}"] += 1


def _operands(x, group_sizes, inst):
    x = x.contiguous()
    if inst != "general" and x.data_ptr() % 16:
        raise ValueError(f"the CUDA grouped GEMM's {inst} instance takes "
                         "16-byte aligned x")
    return x, group_sizes.to(torch.int32).contiguous()


def _launch_float(x, w, group_sizes):
    """The instance :func:`gemm_instance` picks. Raises only for what no
    instance takes: x of another dtype than f32, f16 or bf16, and, on
    the cluster and tile instances, w without a unit stride along K or
    N, with other strides that are not multiples of 8, or misaligned."""
    e, c, k, n = _geometry(x, w, group_sizes)
    out_dtype = x.dtype
    if w.dtype != x.dtype:
        # as the reference computes them: both in f32 (exact), out in x's
        # dtype
        x, w = x.float(), w.float()
    inst = gemm_instance("grouped_gemm", x.dtype, k, n)
    x, gs = _operands(x, group_sizes, inst)
    se, sk, sn = w.stride()
    # 16-byte vectors (tile) or tensor-map rows (cluster) along the
    # unit-stride axis of w: N (the stored weight) or K (its transpose,
    # the backward's dx)
    if inst != "general" and (
            (sn != 1 and sk != 1) or any(s % 8 for s in (se, sk, sn)
                                         if s != 1) or w.data_ptr() % 16):
        raise ValueError(
            f"the CUDA grouped GEMM's {inst} instance reads w with a unit "
            "stride along K or N, the other strides multiples of 8 and "
            f"16-byte alignment; got strides {w.stride()}")
    y = torch.empty((e * c, n), dtype=x.dtype, device=x.device)
    splits = split_count(x.device, e, k, n, CLUSTER_DEPTH) \
        if inst == "cluster" else 1
    lib = _lib()
    rc = lib.gg_forward(INSTANCES["grouped_gemm"][inst], x.data_ptr(),
                        w.data_ptr(), gs.data_ptr(), y.data_ptr(), e, c, k,
                        n, se, sk, sn, splits, _DTYPES[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "grouped_gemm")
    _count("grouped_gemm", inst)
    return y.to(out_dtype)


def _launch_q8(x, w_q, scales, group_sizes, block):
    """The instance :func:`gemm_instance` picks. Raises only for what no
    instance takes: x of another dtype than f32, f16 or bf16, weights
    that are not int8 ``[E, K, N]`` with f32 scales ``[E, ceil(K/B),
    N]``, and misaligned operands of the tile instance."""
    e, c, k, n = _geometry(x, w_q, group_sizes)
    inst = gemm_instance("grouped_gemm_q8", x.dtype, k, n, block)
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (e, -(-k // block), n) or block < 1:
        raise ValueError(
            "the CUDA int8 grouped GEMM takes int8 w [E, K, N] and f32 "
            f"scales [E, ceil(K/B), N]; got {w_q.dtype} {tuple(w_q.shape)}, "
            f"{scales.dtype} {tuple(scales.shape)}, block {block}")
    x, gs = _operands(x, group_sizes, inst)
    w_q, scales = w_q.contiguous(), scales.contiguous()
    if inst != "general" and (w_q.data_ptr() % 16 or scales.data_ptr() % 16):
        raise ValueError(f"the CUDA int8 grouped GEMM's {inst} instance "
                         "takes 16-byte aligned weights and scales")
    y = torch.empty((e * c, n), dtype=x.dtype, device=x.device)
    splits = split_count(x.device, e, k, n, block) \
        if inst == "cluster" else 1
    lib = _lib()
    rc = lib.gg_q8_forward(INSTANCES["grouped_gemm_q8"][inst], x.data_ptr(),
                           w_q.data_ptr(), scales.data_ptr(), gs.data_ptr(),
                           y.data_ptr(), e, c, k, n, block, splits,
                           _DTYPES[x.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "grouped_gemm_q8")
    _count("grouped_gemm_q8", inst)
    return y


def _grouped(x, w, group_sizes):
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_float(x, w, group_sizes)


class _GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _grouped(x, w, group_sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, gs = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # rows past each expert's size get zeros, as they must: those
            # x rows never reached the output
            dx = _grouped(g, w.transpose(1, 2), gs)
        if ctx.needs_input_grad[1]:
            dw = grouped_gemm_dw(x, g, gs, w.dtype)
        return dx, dw, None


def grouped_gemm(x, w, group_sizes):
    """``y[e*C + i] = x[e*C + i] @ w[e]`` for ``i < group_sizes[e]``,
    zeros past each expert's rows (see the module docstring).
    Differentiable in ``x`` and ``w``."""
    return _GroupedGemm.apply(x, w, group_sizes)


def grouped_gemm_q8(x, w_q, scales, group_sizes, block):
    """The int8-weight grouped GEMM: ``y[e*C + i] = x[e*C + i] @ (w_q[e]
    * scales[e])`` for ``i < group_sizes[e]``, zeros elsewhere (a
    ragged last scale block included). Not differentiable (quantized
    weights are frozen)."""
    _geometry(x, w_q, group_sizes)
    block = int(block)
    if x.device.type == "cpu":
        return grouped_gemm_q8_ref(x, w_q, scales, group_sizes, block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_q8(x, w_q, scales, group_sizes, block)
