"""Paged KV-cache bookkeeping (port of
``paddle_tpu/inference/paged_cache.py``).

:class:`PageAllocator` is host Python: a free list of page ids, a
refcount per allocated page and a block table per live sequence. The
device side is the per-layer page pools ``[P, Hk, page, D]`` that the
serving engine owns and the ragged paged attention kernel reads and
writes through these tables.

:class:`PagedKVCache` is one layer's K/V pool bundled with its own
allocator, for decoders written around a paged decode cache: one
sequence per row, ``write`` scatters K/V into the pools, ``attend``
runs the decode-step paged attention kernel over them.

:func:`quantize_kv_int8` is the int8 page quantiser: the serving
engine's two-op path stores its output in int8 pools with f32 scale
sidecars, and the CUDA write kernel computes the same bits.
"""

from __future__ import annotations

import math
import threading
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..observability import metrics as _om
from ..ops import paged_attention as _pa

__all__ = ["PageAllocator", "PagedKVCache", "quantize_kv_int8"]

#: the f32 rounding of the double 1/127: the scale multiplies by it
#: (no divide), bit for bit the reference quantiser's constant
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_kv_int8(x):
    """Symmetric per-head int8 quantization of K/V over the last
    (head_dim) axis: ``x [..., D]`` float -> ``(q, scale)``, ``q`` int8
    of ``x``'s shape and ``scale`` f32 of ``x.shape[:-1]``, one scale
    per (token, head). In f32: ``scale = max(absmax, 1e-8) * f32(1/127)``
    (a multiply by the rounded reciprocal, not a divide), then
    ``round(x / scale)`` half to even, clipped to +-127. Dequantization
    is ``q.float() * scale[..., None]``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) * INV_127
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


class PageAllocator:
    """Free-list page allocator + per-sequence block tables.

    Pages are **refcounted** so a page can be shared by several owners
    (a prefix cache pinning a prefilled prefix, or several sequences
    admitted against it). A page returns to the free list only when its
    last reference drops. Writing into a shared page goes through
    :meth:`ensure_writable` (copy-on-write).

    ``cow_count`` and ``double_free_count`` are plain counters of
    copy-on-write copies and of ignored (idempotent) releases; the same
    events count in the registry's ``kv_page_cow_total`` and
    ``kv_page_double_free_total``."""

    def __init__(self, num_pages, page_size, max_pages_per_seq=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq or num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._free_set = set(self._free)
        self._refs: dict[int, int] = {}     # page -> refcount (allocated)
        self._tables: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}
        # seq -> [its table list, the list's prefix as int32, prefix
        # length] for batch_views; extend only appends, and the other
        # mutations of a table drop its entry
        self._rows: dict[int, list] = {}
        # copy-on-write copies and ignored (idempotent) releases, as plain
        # counts and as the reference's registry counters
        self.cow_count = 0
        self._m_cow = _om.counter(
            "kv_page_cow_total",
            "copy-on-write page copies triggered by a write into a "
            "shared page")
        self.double_free_count = 0
        self._m_double_free = _om.counter(
            "kv_page_double_free_total",
            "release() calls ignored because the sequence or page was "
            "already free")
        self._lock = threading.Lock()

    @property
    def free_pages(self):
        return len(self._free)

    def live_sequences(self):
        return sorted(self._tables)

    def admit(self, seq_id, n_tokens, shared_pages=None):
        """Reserve pages for a new sequence of ``n_tokens`` (prefill).
        ``shared_pages`` (already allocated, e.g. a prefix match) lead
        the block table with their refcount bumped; only the remaining
        pages come from the free list."""
        shared = list(shared_pages or ())
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already admitted")
            need = max(1, math.ceil(n_tokens / self.page_size))
            if need > self.max_pages_per_seq:
                raise ValueError(
                    f"{n_tokens} tokens needs {need} pages > "
                    f"max_pages_per_seq ({self.max_pages_per_seq})")
            if len(shared) > need:
                raise ValueError(
                    f"{len(shared)} shared prefix pages exceed the "
                    f"{need} pages {n_tokens} tokens need")
            for p in shared:
                if p in self._free_set or p not in self._refs:
                    raise ValueError(
                        f"shared page {p} is not allocated; a prefix "
                        f"match must hold a live reference")
            if need - len(shared) > len(self._free):
                raise MemoryError(
                    f"paged cache exhausted: need {need - len(shared)} "
                    f"pages, {len(self._free)} free")
            for p in shared:
                self._refs[p] += 1
            self._tables[seq_id] = shared + [
                self._pop_free() for _ in range(need - len(shared))]
            self._lens[seq_id] = n_tokens
            return list(self._tables[seq_id])

    def _pop_free(self):
        # caller holds self._lock
        p = self._free.pop()
        self._free_set.discard(p)
        self._refs[p] = 1
        return p

    def extend(self, seq_id, n_tokens=1):
        """Grow a sequence by ``n_tokens``, allocating pages as page
        boundaries are crossed. Returns the previous length (the write
        offset of the first new token)."""
        with self._lock:
            table, ln = self._tables[seq_id], self._lens[seq_id]
            new_len = ln + n_tokens
            need = max(1, math.ceil(new_len / self.page_size))
            if need > self.max_pages_per_seq:
                raise ValueError(
                    f"sequence {seq_id} exceeds max_pages_per_seq")
            while len(table) < need:
                if not self._free:
                    raise MemoryError("paged cache exhausted on extend")
                table.append(self._pop_free())
            self._lens[seq_id] = new_len
            return ln

    def rollback(self, seq_id, n_tokens):
        """Shrink a live sequence by its LAST ``n_tokens``; table-tail
        pages wholly past the new length drop one reference. Returns
        pages freed to the pool."""
        n_tokens = int(n_tokens)
        if n_tokens <= 0:
            return 0
        with self._lock:
            ln = self._lens[seq_id]
            if n_tokens > ln:
                raise ValueError(
                    f"cannot roll back {n_tokens} tokens of sequence "
                    f"{seq_id} (length {ln})")
            table = self._tables[seq_id]
            self._rows.pop(seq_id, None)
            new_len = ln - n_tokens
            need = max(1, math.ceil(new_len / self.page_size))
            freed = 0
            while len(table) > need:
                p = table.pop()
                if p in self._free_set or p not in self._refs:
                    self.double_free_count += 1
                    self._m_double_free.inc()
                    warnings.warn(
                        f"rollback of sequence {seq_id} found page {p} "
                        f"already free; skipping", RuntimeWarning,
                        stacklevel=2)
                    continue
                if self._decref_locked(p):
                    freed += 1
            self._lens[seq_id] = new_len
            return freed

    def release(self, seq_id):
        """Drop a finished sequence's references; pages whose LAST
        reference this was return to the free list. Idempotent: an
        unknown or already-released sequence (or a table entry already
        free) is a no-op counted in ``double_free_count`` with a
        :class:`RuntimeWarning`."""
        with self._lock:
            table = self._tables.pop(seq_id, None)
            self._rows.pop(seq_id, None)
            if table is None:
                self.double_free_count += 1
                self._m_double_free.inc()
                warnings.warn(
                    f"release of unknown or already-released sequence "
                    f"{seq_id} ignored", RuntimeWarning, stacklevel=2)
                return
            self._lens.pop(seq_id, None)
            for p in table:
                if p in self._free_set or p not in self._refs:
                    self.double_free_count += 1
                    self._m_double_free.inc()
                    warnings.warn(
                        f"page {p} of sequence {seq_id} already free; "
                        f"skipping double insert", RuntimeWarning,
                        stacklevel=2)
                    continue
                self._decref_locked(p)

    def _decref_locked(self, p):
        # caller holds self._lock and proved p is allocated
        self._refs[p] -= 1
        if self._refs[p] <= 0:
            del self._refs[p]
            self._free.append(p)
            self._free_set.add(p)
            return True
        return False

    def incref(self, page):
        """Take an extra reference on an allocated page."""
        with self._lock:
            if page in self._free_set or page not in self._refs:
                raise ValueError(f"cannot incref free page {page}")
            self._refs[page] += 1

    def decref(self, page):
        """Drop one reference; frees the page at zero. Returns True if
        the page went back to the free list. Decref of an already-free
        page is the same counted no-op as a double release."""
        with self._lock:
            if page in self._free_set or page not in self._refs:
                self.double_free_count += 1
                self._m_double_free.inc()
                warnings.warn(f"decref of free page {page} ignored",
                              RuntimeWarning, stacklevel=2)
                return False
            return self._decref_locked(page)

    def page_ref(self, page):
        """Current refcount of a page (0 = free)."""
        with self._lock:
            return self._refs.get(page, 0)

    def export_table(self, seq_id):
        """``(pages, n_tokens)`` snapshot of a live sequence. Raises
        :class:`KeyError` for unknown sequences."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError(seq_id)
            return list(self._tables[seq_id]), self._lens[seq_id]

    def import_table(self, seq_id, n_tokens):
        """Admit a resumed sequence against freshly drawn, exclusively
        owned pages (never prefix-shared ones)."""
        return self.admit(seq_id, n_tokens)

    def take_pages(self, n):
        """Draw ``n`` standalone pages, refcount 1 each, all or none
        (:class:`MemoryError` when the free list is short)."""
        with self._lock:
            if n > len(self._free):
                raise MemoryError(
                    f"paged cache exhausted: need {n} standalone "
                    f"pages, {len(self._free)} free")
            return [self._pop_free() for _ in range(n)]

    def ensure_writable(self, seq_id, pos):
        """Copy-on-write guard for a K/V write at token position
        ``pos``: if the page holding it is shared, swap a private page
        into this sequence's table and drop one reference on the
        original. Returns ``(old_page, new_page)`` when the caller must
        copy the page's device content, else None."""
        with self._lock:
            table = self._tables[seq_id]
            idx = pos // self.page_size
            p = table[idx]
            if self._refs.get(p, 0) <= 1:
                return None
            if not self._free:
                raise MemoryError(
                    "paged cache exhausted on copy-on-write")
            new = self._pop_free()
            table[idx] = new
            self._rows.pop(seq_id, None)
            self._refs[p] -= 1
            self.cow_count += 1
            self._m_cow.inc()
            return (p, new)

    def context_len(self, seq_id):
        return self._lens[seq_id]

    def page_positions(self, seq_id, start, count):
        """(page_ids, offsets) numpy arrays for token positions
        ``start .. start+count`` of a sequence."""
        table = self._tables[seq_id]
        pos = np.arange(start, start + count)
        page_ids = np.asarray([table[p] for p in pos // self.page_size])
        return page_ids, pos % self.page_size

    def _table_row(self, seq_id):
        """A sequence's block table as int32, converted from its list once
        per page (extend appends to the cached prefix)."""
        table = self._tables[seq_id]
        row = self._rows.get(seq_id)
        if row is None or row[0] is not table:
            row = self._rows[seq_id] = [table, np.empty(0, np.int32), 0]
        n = len(table)
        if n > row[2]:
            if n > row[1].size:
                grown = np.empty(max(n, 2 * row[1].size), np.int32)
                grown[:row[2]] = row[1][:row[2]]
                row[1] = grown
            row[1][row[2]:n] = table[row[2]:]
            row[2] = n
        return row[1][:n]

    def batch_views(self, seq_ids, width=None, fill_page=0, device=None):
        """(block_tables [B, width] int32, context_lens [B] int32) for a
        batch, as tensors on ``device`` (default ``cuda``). Unused tail
        entries point at ``fill_page``. Both are filled in one host
        buffer (pinned for a card) and reach the device in one copy."""
        width = width or max(len(self._tables[s]) for s in seq_ids)
        b = len(seq_ids)
        dev = resolve_device(device)
        host = torch.empty((b * (width + 1),), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        buf = host.numpy()
        tables = buf[:b * width].reshape(b, width)
        tables.fill(fill_page)
        for i, s in enumerate(seq_ids):
            row = self._table_row(s)
            tables[i, :row.size] = row
        buf[b * width:] = [self._lens[s] for s in seq_ids]
        out = host.to(dev, non_blocking=True)
        return out[:b * width].view(b, width), out[b * width:]


class PagedKVCache(PageAllocator):
    """One layer's K/V pool bundled with its own allocator.

    The pools ``k_pages``/``v_pages`` are ``[P, Hk, page, D]`` of
    ``dtype``, zeros, on ``device`` (default ``cuda``; raises without a
    card unless the caller passes ``device="cpu"``). ``write`` updates
    them in place, where the reference builds new arrays."""

    def __init__(self, num_pages, page_size, num_kv_heads, head_dim,
                 dtype=torch.bfloat16, max_pages_per_seq=None, device=None):
        super().__init__(num_pages, page_size, max_pages_per_seq)
        dev = resolve_device(device)
        # head-major [P, Hk, page, D]: the layout the kernel reads
        shape = (num_pages, num_kv_heads, page_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=dev)

    def write(self, seq_id, k, v, start=None):
        """Scatter ``[S, Hk, D]`` new K/V (tensors or arrays, cast to the
        pool's dtype) at position ``start`` (default: end of
        already-written context minus the new tokens — i.e. the tokens
        just accounted by admit/extend)."""
        pool = self.k_pages
        k = torch.as_tensor(k).to(device=pool.device, dtype=pool.dtype)
        v = torch.as_tensor(v).to(device=pool.device, dtype=pool.dtype)
        s = k.shape[0]
        if start is None:
            start = self._lens[seq_id] - s
        page_ids, offs = self.page_positions(seq_id, start, s)
        # target (page_ids[s], h, offs[s], :): [S, 1] / [1, Hk] index
        # tensors broadcast to [S, Hk] scatter sites
        pid = torch.as_tensor(page_ids, dtype=torch.long,
                              device=pool.device)[:, None]
        off = torch.as_tensor(offs, dtype=torch.long,
                              device=pool.device)[:, None]
        hidx = torch.arange(pool.shape[1], device=pool.device)[None, :]
        self.k_pages[pid, hidx, off] = k
        self.v_pages[pid, hidx, off] = v

    def attend(self, seq_ids, q, scale=None, use_pallas=None,
               use_kernel=None):
        """Decode-step attention for ``q [B, H, D]`` over the batch's
        pages; rows of ``q`` correspond to ``seq_ids``. On the card
        ``use_pallas=False`` (the reference's name; ``use_kernel`` is an
        alias; both default to True) runs the plain version instead of
        the kernel; on the CPU both run the plain version. Passing both
        names with different values raises :class:`ValueError`."""
        if use_pallas is not None and use_kernel is not None \
                and bool(use_pallas) != bool(use_kernel):
            raise ValueError(f"use_pallas={use_pallas!r} and its alias "
                             f"use_kernel={use_kernel!r} disagree")
        use_pallas = next((bool(x) for x in (use_pallas, use_kernel)
                           if x is not None), True)
        tables, lens = self.batch_views(seq_ids, device=self.k_pages.device)
        fn = _pa.paged_attention if use_pallas else _pa.paged_attention_ref
        return fn(q, self.k_pages, self.v_pages, tables, lens, scale=scale)
