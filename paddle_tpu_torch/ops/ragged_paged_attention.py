"""Ragged paged attention with fused rope and KV page write (port of
``paddle_tpu/ops/ragged_paged_attention.py``, rope-fused variant).

One call serves a mixed batch of prefill chunks and decode rows over a
shared paged KV pool. Shapes (T packed tokens, R rows, QB = ``qblock``):

  q             [T, H, D]        packed PRE-rope queries (model dtype)
  new_k, new_v  [T, Hk, D]       packed pre-rope K and V of the dispatch
  k/v_pages     [P, Hk, page, D] the pools, head-major; updated IN PLACE
  block_tables  [R, W] int32     page ids of each row's sequence (tail
                                 entries are clamped into [0, P))
  kv_lens       [R] int32        context of the row incl. its queries
                                 (0 marks an inactive row: zeros out)
  q_starts      [R] int32        absolute position of the row's 1st query
  q_lens        [R] int32        valid query tokens of the row
  w_starts      [R] int32        first position of the row's sequence
                                 written by this dispatch
  w_flats       [R] int32        that position's packed index
  w_ends        [R] int32        the sequence's final kv_len here
  rope_sin/cos  [T, D] f32       per-token rotary tables (:func:`rope_tables`)
  -> out        [R, QB, H, D]

Row r's token qi sits at packed index ``w_flats[r] + q_starts[r] -
w_starts[r] + qi`` and attends kv positions ``[0, q_start + qi]`` clipped
to ``[0, kv_len)``. For every active row ``kv_len == q_start + q_len``.

On a CUDA tensor :func:`fused_ragged_paged_attention` launches the
hand-written kernels in ``csrc/ragged_paged_attention.cu`` (a write
launch, then the attention launch, on one stream); on a CPU tensor it
runs the plain version :func:`fused_ragged_paged_attention_ref`. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["rope_tables", "ragged_paged_attention_ref",
           "fused_ragged_paged_attention_ref", "fused_ragged_paged_attention"]

NEG_INF = -1e30

#: kernel launches on the CUDA path (two per call: write, then attention)
launches = 0

_MAX_PAGE = 32        # the softmax step holds one key slot per lane of a warp
_MAX_HEAD_DIM = 128   # one thread per output column of a block


def rope_tables(pos, head_dim, base):
    """Per-dispatch rotary tables, one row per packed token: ``(sin,
    cos)``, each ``[T, D]`` f32 in the neox duplicated-half layout
    (``emb = cat([ang, ang])``). ``pos`` is any integer tensor; it is
    flattened to ``[T]``, and the tables land on its device."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=pos.device) / head_dim))
    ang = pos.reshape(-1).float()[:, None] * inv            # [T, D/2]
    emb = torch.cat([ang, ang], dim=-1)                     # [T, D]
    return emb.sin(), emb.cos()


def _rot_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope(x, sin, cos):
    """``x * cos + rotate_half(x) * sin`` in f32 on ``[T, heads, D]``
    with ``[T, D]`` tables, cast back to ``x.dtype``."""
    xf = x.float()
    out = xf * cos[:, None, :] + _rot_half(xf) * sin[:, None, :]
    return out.to(x.dtype)


def ragged_paged_attention_ref(q, k_pages, v_pages, block_tables, kv_lens,
                               q_starts, q_lens, scale=None):
    """Plain ragged paged attention on row-blocked ``q [R, QB, H, D]``:
    gather every row's pages into a contiguous window, mask, softmax in
    f32. Padded query rows and inactive rows come back as zeros."""
    r, qb, h, d = q.shape
    p, hk, page_size, _ = k_pages.shape
    group = h // hk
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    tables = block_tables.long().clamp(0, p - 1)
    # [R, W, Hk, page, D] -> [R, S, Hk, D]
    k = k_pages[tables].transpose(2, 3).reshape(r, -1, hk, d)
    v = v_pages[tables].transpose(2, 3).reshape(r, -1, hk, d)
    kq = k.repeat_interleave(group, dim=2).float()
    vq = v.repeat_interleave(group, dim=2).float()
    logits = torch.einsum("rqhd,rshd->rhqs", q.float(), kq) * s
    kpos = torch.arange(k.shape[1], device=dev)[None, None, None, :]
    qi = torch.arange(qb, device=dev)[None, :]
    qpos = (q_starts.long()[:, None] + qi)[:, None, :, None]
    qvalid = (qi < q_lens.long()[:, None])[:, None, :, None]
    mask = (kpos <= qpos) & (kpos < kv_lens.long()[:, None, None, None]) \
        & qvalid
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    # fully masked rows (padding, inactive) -> zeros, as the kernel's
    # l == 0 guard gives, not softmax's uniform weights
    w = torch.where(mask.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("rhqs,rshd->rqhd", w, vq)
    return out.to(q.dtype)


def fused_ragged_paged_attention_ref(q, new_k, new_v, k_pages, v_pages,
                                     block_tables, kv_lens, q_starts, q_lens,
                                     w_starts, w_flats, w_ends, dump_page,
                                     rope_sin, rope_cos, qblock, scale=None):
    """The plain version: rope the packed q and new K, write every
    active row's fresh K/V into its pages (in place), gather q into
    ``[R, qblock]`` row blocks, then :func:`ragged_paged_attention_ref`
    over the updated pools. ``w_ends`` and ``dump_page`` are accepted
    for signature parity; the dump page is never touched."""
    del w_ends, dump_page
    sin, cos = rope_sin.float(), rope_cos.float()
    q_rot = _rope(q, sin, cos)
    k_rot = _rope(new_k, sin, cos)
    r = block_tables.shape[0]
    page_size = k_pages.shape[2]
    tables = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    meta = torch.stack([m.long() for m in (kv_lens, q_starts, q_lens,
                                           w_starts, w_flats)]).tolist()
    qr = q_rot.new_zeros((r, int(qblock)) + tuple(q_rot.shape[1:]))
    hidx = torch.arange(k_pages.shape[1], device=q.device)[None, :]
    for i, (kv, qs, n, ws, wf) in enumerate(zip(*meta)):
        if n <= 0:
            continue
        f0 = wf + qs - ws
        qr[i, :n] = q_rot[f0:f0 + n]
        if kv <= 0:
            continue
        pos = torch.arange(qs, qs + n, device=q.device)
        pages = tables[i, pos // page_size][:, None]
        offs = (pos % page_size)[:, None]
        k_pages[pages, hidx, offs] = k_rot[f0:f0 + n].to(k_pages.dtype)
        v_pages[pages, hidx, offs] = new_v[f0:f0 + n].to(v_pages.dtype)
    return ragged_paged_attention_ref(qr, k_pages, v_pages, tables, kv_lens,
                                      q_starts, q_lens, scale)


def _check(q, new_k, new_v, k_pages, v_pages, block_tables, meta, rope_sin,
           rope_cos, qblock):
    if q.dim() != 3 or new_k.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("expected q [T,H,D], new_k/new_v [T,Hk,D] and "
                         "pools [P,Hk,page,D]")
    t, h, d = q.shape
    p, hk, _, dk = k_pages.shape
    r = block_tables.shape[0]
    if new_k.shape != (t, hk, d) or new_v.shape != (t, hk, d) \
            or v_pages.shape != k_pages.shape or dk != d or h % hk \
            or d % 2 or t < 1 or int(qblock) < 1:
        raise ValueError(
            f"inconsistent shapes: q {tuple(q.shape)}, new_k "
            f"{tuple(new_k.shape)}, new_v {tuple(new_v.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, qblock "
            f"{qblock}")
    if block_tables.dim() != 2 or any(m.shape != (r,) for m in meta):
        raise ValueError("block_tables must be [R, W] and the per-row "
                         "metadata [R]")
    if rope_sin.shape != (t, d) or rope_cos.shape != (t, d):
        raise ValueError(f"rope tables must be [T, D] = {(t, d)}")
    devs = {a.device for a in (q, new_k, new_v, k_pages, v_pages,
                               block_tables, rope_sin, rope_cos, *meta)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def _lib():
    lib = _build.load("ragged_paged_attention")
    if not getattr(lib, "_rpa_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rpa_rope_kv_write.argtypes = [vp] * 12 + [i32] * 7 + [vp]
        lib.rpa_rope_kv_write.restype = i32
        lib.rpa_rope_attention.argtypes = [vp] * 12 + [i32] * 9 \
            + [ctypes.c_float, vp]
        lib.rpa_rope_attention.restype = i32
        lib.rpa_error_string.argtypes = [i32]
        lib.rpa_error_string.restype = ctypes.c_char_p
        lib._rpa_typed = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        msg = lib.rpa_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch(q, new_k, new_v, k_pages, v_pages, block_tables, meta,
            rope_sin, rope_cos, qblock, scale):
    global launches
    kv_lens, q_starts, q_lens, w_starts, w_flats = meta
    if any(a.dtype != torch.bfloat16
           for a in (q, new_k, new_v, k_pages, v_pages)):
        raise ValueError(
            "the CUDA kernel takes q, new_k, new_v and both pools in "
            f"bfloat16; got {q.dtype}, {new_k.dtype}, {new_v.dtype}, "
            f"{k_pages.dtype}, {v_pages.dtype}")
    if any(a.dtype != torch.int32 for a in (block_tables, *meta)) \
            or rope_sin.dtype != torch.float32 \
            or rope_cos.dtype != torch.float32:
        raise ValueError("block tables and row metadata must be int32, "
                         "rope tables float32")
    ops = (q, new_k, new_v, k_pages, v_pages, block_tables, rope_sin,
           rope_cos, *meta)
    if not all(a.is_contiguous() for a in ops):
        raise ValueError("the CUDA kernel takes contiguous operands")
    t, h, d = q.shape
    p, hk, page_size, _ = k_pages.shape
    r, w = block_tables.shape
    # pages of at most 32 x 128 bf16 = 8 KB per head, fetched as 16-byte
    # vectors
    if page_size > _MAX_PAGE or d > _MAX_HEAD_DIM or d % 8 \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(
            f"the CUDA kernel takes pages of at most {_MAX_PAGE} slots, "
            f"16-byte aligned pools and head_dim <= {_MAX_HEAD_DIM}, a "
            f"multiple of 8; got page_size {page_size}, head_dim {d}")
    lib = _lib()
    qb = int(qblock)
    out = torch.empty((r, qb, h, d), dtype=q.dtype, device=q.device)
    if r == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = [a.data_ptr() for a in (rope_sin, rope_cos, block_tables,
                                  kv_lens, q_starts, q_lens, w_starts,
                                  w_flats)]
    rc = lib.rpa_rope_kv_write(new_k.data_ptr(), new_v.data_ptr(),
                               k_pages.data_ptr(), v_pages.data_ptr(), *ptr,
                               r, t, hk, d, p, page_size, w, stream)
    _raise_on(lib, rc, "rope_kv_write")
    launches += 1
    rc = lib.rpa_rope_attention(q.data_ptr(), k_pages.data_ptr(),
                                v_pages.data_ptr(), *ptr, out.data_ptr(),
                                r, t, h, hk, d, p, page_size, w, qb,
                                float(scale), stream)
    _raise_on(lib, rc, "ragged_attention_rope")
    launches += 1
    return out


def fused_ragged_paged_attention(q, new_k, new_v, k_pages, v_pages,
                                 block_tables, kv_lens, q_starts, q_lens,
                                 w_starts, w_flats, w_ends, dump_page,
                                 rope_sin, rope_cos, qblock, scale=None):
    """Rope + KV page write + ragged paged attention in one call (see
    the module docstring for shapes). Returns ``out [R, qblock, H,
    D]``. The fresh K (roped) and V are written into ``k_pages`` /
    ``v_pages`` IN PLACE; the dump page is never written.

    CUDA tensors launch the hand-written kernels, bf16 only (and raise
    if they cannot); CPU tensors, of any float dtype, run :func:`fused_ragged_paged_attention_ref`."""
    meta = (kv_lens, q_starts, q_lens, w_starts, w_flats)
    _check(q, new_k, new_v, k_pages, v_pages, block_tables,
           meta + (w_ends,), rope_sin, rope_cos, qblock)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return fused_ragged_paged_attention_ref(
            q, new_k, new_v, k_pages, v_pages, block_tables, kv_lens,
            q_starts, q_lens, w_starts, w_flats, w_ends, dump_page,
            rope_sin, rope_cos, qblock, s)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, new_k, new_v, k_pages, v_pages, block_tables, meta,
                   rope_sin, rope_cos, qblock, s)
