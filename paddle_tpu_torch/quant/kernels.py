"""Weight-only int8 matmul ``y = x @ (q * per-block scales)`` (port of
``paddle_tpu/quant/kernels.py``).

The decode-side projection of int8 serving: device memory holds the
int8 weight and its f32 scale rows, and the dequantize happens in the
kernel next to the product. On a CUDA tensor :func:`dequant_matmul`
launches the hand-written kernels of ``csrc/dequant_matmul.cu`` or
raises; on a CPU tensor it runs the plain version
:func:`dequant_matmul_ref`.

The kernels take the reference's kernel domain (:func:`supported`) and
every shape its public function takes: one rule,
``ops._tile_gemm.gemm_instance``, sends 16-bit x with K % 8, N % 16 and
B % 16 zero to the cluster instance (the serving path), f32 x with B %
32 zero to the tile instance, and the rest to the general instance (f32
FMAs, any K, N, B >= 1). A ragged last scale block (K % B != 0) is
taken too, where the reference's kernel needs K to be a whole number of
blocks.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _build
from ..ops._tile_gemm import INSTANCES, cluster_splits, gemm_instance
from .format import dequant_blocks, effective_block

__all__ = ["dequant_matmul", "dequant_matmul_ref", "supported"]

#: kernel launches on the CUDA path by instance
#: (``ops._tile_gemm.gemm_instance``); ``launches`` is their sum
instance_launches = _build.counter(f"dequant_matmul.{i}"
                                   for i in INSTANCES["dequant_matmul"])


def __getattr__(name):
    if name == "launches":
        return sum(instance_launches.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dequant_matmul_ref(x, q, scales, block):
    """The plain version: dequantize to f32, one f32 product over the
    whole K, cast to ``x.dtype``."""
    w = dequant_blocks(q, scales, block)
    return torch.matmul(x.float(), w).to(x.dtype)


def supported(x, q, scales, block=None):
    """The kernel domain: the reference's kernel rule without its TPU
    and VMEM clauses, f32, f16 or bf16 ``x [..., K]`` with at least one
    row, 2-D int8 ``q [K, N]``, f32 ``scales [ceil(K/B), N]`` for the
    block B (clamped to K by ``effective_block``), K % 8 == 0 and N % 8
    == 0, where the reference also needs K % B == 0 (a ragged last block
    is taken here). The kernels take every other shape the public
    function takes too (the general instance)."""
    if x.dim() < 1 or q.dim() != 2 or scales.dim() != 2:
        return False
    k = x.shape[-1]
    kw, n = q.shape
    if kw != k or scales.shape[1] != n or k == 0:
        return False
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        return False
    if scales.shape[0] != -(-k // effective_block(k, block)):
        return False
    return x.numel() // k > 0 and k % 8 == 0 and n % 8 == 0


def _lib():
    lib = _build.load("dequant_matmul")
    if not getattr(lib, "_dq_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dq_forward.argtypes = [i32] + [vp] * 4 + [i32] * 6 + [vp]
        lib.dq_forward.restype = i32
        lib.dq_error_string.argtypes = [i32]
        lib.dq_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _launch(x2, q, scales, block):
    """The kernel instance :func:`gemm_instance` picks, on 2-D ``x2 [M,
    K]``. Raises for operands no instance takes: other dtypes than
    float x, int8 q and f32 scales ``[ceil(K/B), N]``; strided or
    misaligned operands of the cluster and tile instances."""
    m, k = x2.shape
    n = q.shape[1]
    inst = gemm_instance("dequant_matmul", x2.dtype, k, n, block)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (-(-k // block), n):
        raise ValueError(
            "the CUDA dequant kernels take int8 q and f32 scales "
            f"[ceil(K/B), N]; got {q.dtype} {tuple(q.shape)}, "
            f"{scales.dtype} {tuple(scales.shape)}, block {block}")
    x2, q, scales = x2.contiguous(), q.contiguous(), scales.contiguous()
    if inst != "general" and any(t.data_ptr() % 16 for t in (x2, q, scales)):
        raise ValueError(f"the CUDA dequant kernel's {inst} instance takes "
                         "16-byte aligned operands")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return y
    splits = cluster_splits(x2.device, k, n, block) if inst == "cluster" \
        else 1
    lib = _lib()
    rc = lib.dq_forward(INSTANCES["dequant_matmul"][inst], x2.data_ptr(),
                        q.data_ptr(), scales.data_ptr(), y.data_ptr(), m, k,
                        n, block, splits, _DTYPES[x2.dtype],
                        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {rc} "
                           f"({lib.dq_error_string(rc).decode()})")
    instance_launches[f"dequant_matmul.{inst}"] += 1
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
