"""Flash attention forward and backward with GQA (port of the reference
package's ``ops/flash_attention.py``).

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, Hk, D]`` with ``H % Hk ==
0``; query head ``h`` reads kv head ``h // (H // Hk)``, and K/V are
never replicated. Causal alignment is bottom-right: with ``offset = Sk -
Sq``, query ``i`` sees keys ``j <= i + offset``.

Backward uses the recomputation split of the reference:

  P_ij = exp(S_ij * scale - lse_i)      (S = Q K^T, masked to -1e30)
  delta_i = rowsum(dO_i * O_i)          (f32, computed here)
  dV_j = sum_i P_ij dO_i
  dS_ij = P_ij (dP_ij - delta_i) scale  (dP = dO V^T)
  dQ_i = sum_j dS_ij K_j,  dK_j = sum_i dS_ij Q_i

dK/dV sum over the group of query heads sharing a kv head.

On CUDA tensors :func:`flash_attention` launches the hand-written
kernels of ``csrc/flash_attention.cu`` (forward, dQ, dK/dV; outputs in
the inputs' dtypes, lse f32, f32 accumulation); on CPU tensors it runs
the plain versions :func:`flash_attention_fwd_ref` and
:func:`flash_attention_bwd_ref`. There is no fallback from one to the
other.

The kernels take the whole domain :func:`supported` states: f32, f16
and bf16, ``head_dim % 8 == 0`` up to 256, GQA, causal or not, sequence
lengths that are multiples of 128. One rule, :func:`kernel_instance`,
picks the instance from the dtype and head_dim:

- bf16 at head_dim 64 or 128: the tensor-core instance (forward and
  dQ and dK/dV on ``wgmma`` with TMA copies);
- every other (dtype, head_dim): the general instance (the same three
  kernels with every product an f32 FMA; f16 and bf16 read as 16-bit).

q, k and v of different dtypes are widened to f32 (exact) for the
general instance, and each gradient comes back in its input's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["supported", "kernel_instance", "flash_attention",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "attention_delta"]

BLOCK_Q = 128
BLOCK_K = 128
NEG_INF = -1e30

#: kernel launches on the CUDA path, one count per TPU kernel
launches = {"forward": 0, "dq": 0, "dkv": 0}
#: the same launches by kernel and instance (:func:`kernel_instance`)
instance_launches = {f"{k}.{i}": 0 for k, i in (
    ("forward", "wgmma"), ("forward", "general"), ("dq", "wgmma"),
    ("dq", "general"), ("dkv", "wgmma"), ("dkv", "general"))}

_TC_HEAD_DIMS = (64, 128)   # bf16 head_dims of the tensor-core instance
# the C entries' codes
_INSTANCES = {"tensor-core": 0, "general": 1}
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def kernel_instance(dtype, head_dim):
    """The CUDA instance that takes q/k/v of ``dtype`` at ``head_dim``:
    ``"tensor-core"`` for bf16 at head_dim 64 or 128 (the forward and
    both backward kernels on wgmma + TMA), ``"general"`` (f32 FMAs) for
    every other float dtype and head_dim of :func:`supported`'s domain.
    Operands of mixed dtypes run the general instance in f32."""
    if dtype == torch.bfloat16 and head_dim in _TC_HEAD_DIMS:
        return "tensor-core"
    return "general"


def supported(q, k, v, attn_mask, causal):
    """The reference's flash-path preconditions on ``[B, S, H, D]``
    tensors, without its two VMEM-budget clauses (a TPU limit: the
    kernels here stream K/V and Q/dO tiles through shared memory)."""
    if attn_mask is not None:
        return False
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        return False
    b, sq, h, d = q.shape
    bk, sk, hk, dk = k.shape
    if bk != b or hk == 0 or h % hk or dk != d:
        return False
    if causal and sq > sk:
        # bottom-right alignment would leave leading queries with no key
        return False
    if sq < BLOCK_Q or sk < BLOCK_K or sq % BLOCK_Q or sk % BLOCK_K:
        return False
    return d % 8 == 0 and d <= 256


def _scores(q, k, causal, scale):
    """f32 ``[B, H, Sq, Sk]`` scores ``q k^T * scale``, masked to
    ``NEG_INF`` above the bottom-right causal diagonal, and the
    head-major f32 q/k (k repeated over its query group)."""
    group = q.shape[2] // k.shape[2]
    qh = q.float().transpose(1, 2)
    kh = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s, qh, kh


def flash_attention_fwd_ref(q, k, v, causal=False, scale=None):
    """The plain forward: ``(out [B, Sq, H, D] in q's dtype, lse [B, H,
    Sq] f32)``, all arithmetic in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    with torch.autocast(q.device.type, enabled=False):
        s, _, _ = _scores(q, k, causal, scale)
        group = q.shape[2] // k.shape[2]
        vh = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(p, vh) / l
        lse = (m + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype), lse


def attention_delta(out, do):
    """``delta [B, H, Sq]`` f32: the row sums of ``dO * O``."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_attention_bwd_ref(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """The plain backward from the saved ``lse`` and ``delta`` (both
    ``[B, H, Sq]`` f32): ``(dq, dk, dv)`` in the dtypes of q, k, v, all
    arithmetic in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    b, sq, h, d = q.shape
    hk, sk = k.shape[2], k.shape[1]
    group = h // hk
    with torch.autocast(q.device.type, enabled=False):
        s, qh, kh = _scores(q, k, causal, scale)
        vh = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
        doh = do.float().transpose(1, 2)
        p = torch.exp(s - lse[..., None])
        dp = torch.matmul(doh, vh.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq = torch.matmul(ds, kh)
        dk = torch.matmul(ds.transpose(-1, -2), qh)
        dv = torch.matmul(p.transpose(-1, -2), doh)
        dk = dk.reshape(b, hk, group, sk, d).sum(dim=2)
        dv = dv.reshape(b, hk, group, sk, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_fa_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        shape = [i32] * 7 + [ctypes.c_float, vp]   # D,B,H,Hk,Sq,Sk,causal
        lib.fa_forward.argtypes = [i32] * 2 + [vp] * 5 + [i64] * 9 + shape
        lib.fa_backward_dq.argtypes = [i32] * 2 + [vp] * 7 + [i64] * 12 \
            + shape
        lib.fa_backward_dkv.argtypes = [i32] * 2 + [vp] * 8 + [i64] * 12 \
            + shape
        for fn in (lib.fa_forward, lib.fa_backward_dq, lib.fa_backward_dkv):
            fn.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        lib._fa_typed = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        msg = lib.fa_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _strides(*ts):
    """(batch, seq, head) element strides of each ``[B, S, H, D]``
    tensor, flattened."""
    return [s for t in ts for s in t.stride()[:3]]


def _check_kernel_operands(*ts):
    """The kernels' limits past :func:`supported`, on q, k, v (and dO);
    returns ``(instance, operands)``, the operands widened to f32 where
    their dtypes differ. Raises for strides, alignment and sequence
    lengths no instance takes."""
    if any(t.dtype not in _DTYPES for t in ts):
        raise ValueError("the CUDA flash kernels take float32, float16 or "
                         "bfloat16; got "
                         + ", ".join(str(t.dtype) for t in ts))
    if len({t.dtype for t in ts}) > 1:
        ts = tuple(t.float() for t in ts)
    inst = kernel_instance(ts[0].dtype, ts[0].shape[-1])
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError("the CUDA flash kernels need a unit stride "
                             "along head_dim")
        # the tensor-core instance copies 16-byte vectors (TMA boxes)
        if inst == "tensor-core" and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError("the bf16 head_dim 64/128 flash kernels need "
                             "16-byte aligned rows and strides that are "
                             "multiples of 8 elements")
    if ts[0].shape[1] % BLOCK_Q or ts[1].shape[1] % BLOCK_Q:
        raise ValueError(f"the CUDA flash kernels need sequence lengths "
                         f"that are multiples of {BLOCK_Q}")
    return inst, ts


def _codes(inst, t):
    return _INSTANCES[inst], _DTYPES[t.dtype]


def _count(kernel, inst):
    launches[kernel] += 1
    name = {"tensor-core": "wgmma", "general": "general"}[inst]
    instance_launches[f"{kernel}.{name}"] += 1


def _geometry(q, k, causal, scale):
    b, sq, h, d = q.shape
    return [d, b, h, k.shape[2], sq, k.shape[1], int(bool(causal)),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream]


def _launch_forward(q, k, v, causal, scale):
    inst, (qk, kk, vk) = _check_kernel_operands(q, k, v)
    lib = _lib()
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=qk.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = lib.fa_forward(*_codes(inst, qk), qk.data_ptr(), kk.data_ptr(),
                        vk.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        *_strides(qk, kk, vk),
                        *_geometry(q, k, causal, scale))
    _raise_on(lib, rc, "flash forward")
    _count("forward", inst)
    return out.to(q.dtype), lse


def _backward_operands(q, k, v, do, lse, delta):
    inst, ts = _check_kernel_operands(q, k, v, do)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
            or not lse.is_contiguous() or not delta.is_contiguous():
        raise ValueError("lse and delta must be contiguous f32 [B, H, Sq]")
    return inst, ts, [t.data_ptr() for t in ts + (lse, delta)]


def _launch_dq(q, k, v, do, lse, delta, causal, scale):
    inst, ts, ptrs = _backward_operands(q, k, v, do, lse, delta)
    lib = _lib()
    dq = torch.empty(q.shape, dtype=ts[0].dtype, device=q.device)
    rc = lib.fa_backward_dq(*_codes(inst, ts[0]), *ptrs, dq.data_ptr(),
                            *_strides(*ts), *_geometry(q, k, causal, scale))
    _raise_on(lib, rc, "flash dq")
    _count("dq", inst)
    return dq.to(q.dtype)


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    inst, ts, ptrs = _backward_operands(q, k, v, do, lse, delta)
    lib = _lib()
    dk = torch.empty(k.shape, dtype=ts[1].dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=ts[2].dtype, device=v.device)
    rc = lib.fa_backward_dkv(*_codes(inst, ts[0]), *ptrs, dk.data_ptr(),
                             dv.data_ptr(), *_strides(*ts),
                             *_geometry(q, k, causal, scale))
    _raise_on(lib, rc, "flash dk/dv")
    _count("dkv", inst)
    return dk.to(k.dtype), dv.to(v.dtype)


def _launch_backward(q, k, v, do, lse, delta, causal, scale):
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _forward(q, k, v, causal, scale):
    if q.device.type == "cuda":
        return _launch_forward(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_fwd_ref(q, k, v, causal, scale)


def _backward(q, k, v, do, lse, delta, causal, scale):
    if q.device.type == "cuda":
        return _launch_backward(q, k, v, do, lse, delta, causal, scale)
    return flash_attention_bwd_ref(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(out.dtype).contiguous()
        delta = attention_delta(out, do)
        dq, dk, dv = _backward(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query, key, value, attn_mask=None, causal=False,
                    scale=None):
    """Differentiable flash attention on q ``[B, S, H, D]``, k/v ``[B,
    S, Hk, D]`` (GQA native). Raises :class:`ValueError` where
    :func:`supported` does not hold."""
    if not supported(query, key, value, attn_mask, causal):
        raise ValueError(
            "flash_attention preconditions not met (need 4-D [B,S,H,D], S "
            f"% {BLOCK_Q} == 0, head_dim % 8 == 0 and <= 256, num_heads "
            "divisible by num_kv_heads, attn_mask None, and Sq <= Sk when "
            "causal); use scaled_dot_product_attention for the plain path")
    if len({query.device, key.device, value.device}) != 1:
        raise ValueError("query, key and value must share one device")
    s = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    return _FlashAttention.apply(query, key, value, bool(causal), float(s))
