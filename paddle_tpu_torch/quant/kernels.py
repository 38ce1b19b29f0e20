"""Weight-only int8 matmul ``y = x @ (q * per-block scales)`` (port of
``paddle_tpu/quant/kernels.py``).

The decode-side projection of int8 serving: device memory holds the
int8 weight and its f32 scale rows, and the dequantize happens in the
kernel next to the product. On a CUDA tensor :func:`dequant_matmul`
launches the hand-written kernel in ``csrc/dequant_matmul.cu`` (a
ragged last scale block included, where the reference's kernel needs K
to be a whole number of blocks) or raises; on a CPU tensor it runs the
plain version :func:`dequant_matmul_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _build
from ..ops._tile_gemm import TILE_K, split_count, split_scratch
from .format import dequant_blocks, effective_block

__all__ = ["dequant_matmul", "dequant_matmul_ref", "supported"]

#: kernel launches on the CUDA path
launches = 0

def dequant_matmul_ref(x, q, scales, block):
    """The plain version: dequantize to f32, one f32 product over the
    whole K, cast to ``x.dtype``."""
    w = dequant_blocks(q, scales, block)
    return torch.matmul(x.float(), w).to(x.dtype)


def supported(x, q, scales, block=None):
    """The shapes the CUDA kernel takes: bf16 or f32 ``x [..., K]``, 2-D
    int8 ``q [K, N]`` and f32 ``scales [ceil(K/B), N]`` with B a multiple
    of the 32-deep K tile, K % 8 == 0 and N % 16 == 0."""
    k = x.shape[-1]
    b = effective_block(k, block)
    return (x.dtype in (torch.bfloat16, torch.float32) and q.dim() == 2
            and scales.dim() == 2 and q.shape[0] == k
            and q.dtype == torch.int8 and scales.dtype == torch.float32
            and tuple(scales.shape) == (-(-k // b), q.shape[1])
            and b % TILE_K == 0 and k % 8 == 0 and q.shape[1] % 16 == 0)


def _lib():
    lib = _build.load("dequant_matmul")
    if not getattr(lib, "_dq_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dq_forward.argtypes = [vp] * 4 + [i32] * 5 + [vp, vp, i32, vp]
        lib.dq_forward.restype = i32
        lib.dq_error_string.argtypes = [i32]
        lib.dq_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _launch(x2, q, scales, block):
    """The kernel on 2-D ``x2 [M, K]`` (bf16 or f32)."""
    global launches
    m, k = x2.shape
    n = q.shape[1]
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA dequant kernel takes bf16 or f32 x, got "
                         f"{x2.dtype}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (-(-k // block), n):
        raise ValueError(
            "the CUDA dequant kernel takes int8 q and f32 scales "
            f"[ceil(K/B), N]; got {q.dtype} {tuple(q.shape)}, "
            f"{scales.dtype} {tuple(scales.shape)}, block {block}")
    if block % TILE_K or k % 8 or n % 16:
        raise ValueError(
            f"the CUDA dequant kernel needs a block that is a multiple of "
            f"{TILE_K}, K % 8 == 0 and N % 16 == 0; got block {block}, "
            f"K {k}, N {n}")
    x2 = x2.contiguous()
    if not (q.is_contiguous() and scales.is_contiguous()) \
            or any(t.data_ptr() % 16 for t in (x2, q, scales)):
        raise ValueError("the CUDA dequant kernel takes contiguous, 16-byte "
                         "aligned operands")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return y
    bf16 = x2.dtype == torch.bfloat16
    splits = split_count(x2.device, 1, k, n, block) if bf16 else 1
    partial, tickets = split_scratch(x2, splits, 1, m, n)
    lib = _lib()
    rc = lib.dq_forward(x2.data_ptr(), q.data_ptr(), scales.data_ptr(),
                        y.data_ptr(), m, k, n, block, splits,
                        _build.data_ptr(partial), _build.data_ptr(tickets),
                        int(bf16),
                        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {rc} "
                           f"({lib.dq_error_string(rc).decode()})")
    launches += 1
    return y


def dequant_matmul(x, w_q, scales, block=None):
    """``x [..., K] @ dequant(w_q [K, N], scales [ceil(K/B), N])`` ->
    ``[..., N]`` in ``x.dtype``, f32 math. CUDA tensors launch the
    kernel (and raise if they cannot); CPU tensors take
    :func:`dequant_matmul_ref`. Not differentiable: quantized weights
    are frozen."""
    k = x.shape[-1]
    b = effective_block(k, block)
    if w_q.shape[0] != k or scales.shape[-1] != w_q.shape[-1]:
        raise ValueError(f"x [..., {k}] does not match int8 weight "
                         f"{tuple(w_q.shape)} / scales {tuple(scales.shape)}")
    if len({x.device, w_q.device, scales.device}) != 1:
        raise ValueError("x, weight and scales must share one device")
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = dequant_matmul_ref(x2, w_q, scales, b)
    elif x.device.type == "cuda":
        y = _launch(x2, w_q, scales, b)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return y.reshape(x.shape[:-1] + (w_q.shape[-1],))
