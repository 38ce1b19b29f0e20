"""Host-DRAM KV page tier: pause/resume for the degradation ladder (port
of ``paddle_tpu/inference/kv_tier.py``).

Under pool pressure the serving engine's evict rung *destroys* work: the
victim's KV pages are dropped and the request re-prefills from token
zero. With the tier on, the page table makes pages the unit of migration
instead: a victim's pages are copied to the host (int8 pages at half the
bytes; the f32 scale sidecars travel with their pages) into a bounded
host pool, the device pages return to the allocator, and the request
parks in the ``paused`` lifecycle status until the requeue pump resumes
it: a restore into freshly admitted pages, after which the resumed
request's remaining tokens are bitwise what an uninterrupted run
produces.

Robustness is the headline contract:

- every failure is TYPED (:class:`TierError` subclasses) and the
  serving engine degrades to the old behavior: a failed export falls
  through to the evict rung, a failed or torn restore to the
  evict -> requeue path (never a wedge, never a leak);
- restore data is CRC-checked per page slot (CRC-32 over the raw bytes
  of every pool's slot, chained K pools, V pools, K scales, V scales:
  the reference's values for the same bytes). The CRCs commit to the
  source bytes at export, so a host copy corrupted anywhere between the
  export and the restore is detected and re-prefilled, never decoded;
- accounting is leak-proof: ``kv_tier_pages`` / ``kv_tier_bytes``
  return to baseline when parked requests resume, cancel, expire, or
  drain.

Fault points ``tier.d2h`` / ``tier.h2d`` (:mod:`paddle_tpu_torch.testing
.faults`, via :func:`~paddle_tpu_torch.testing.faults.fire_copy`) make
every path reproducibly testable: ``sleep`` = a slow copy, ``raise`` = a
failed copy, ``bitflip`` = a torn copy (this module flips one byte of the
host buffer, so the CRC check must catch it). Sequence copies fire with
``path="seq"`` and demoted prefix-cache pages with ``path="prefix"``.

On the card: an export gathers the sequence's pages with one
``index_select`` a pool after every queued write to the pools (the
dispatches write them in place), then copies each gather into a pinned
host tensor the tier owns, and waits once. A restore writes the pages
IN PLACE into the engine's pool tensors (``index_copy_`` on the current
stream): the decode tick's CUDA graphs baked the pools' addresses, so a
pool is never rebound, and :meth:`KvPageTier.restore_seq` returns the
same lists it was given. Restores ride async staging: a daemon thread
CRC-verifies the next resume candidate's host copy and copies it to the
card on its own stream, recording an event; the restore makes the
current stream wait on that event and marks the staged tensors as used
there. Staging is skipped while a fault plan is active (chaos runs stay
deterministic), and all of the tier's device work holds
:data:`~paddle_tpu_torch.ops._graphs.CAPTURE_LOCK`, so it never overlaps
a CUDA graph capture. On the CPU the host copies are plain tensors.
"""

from __future__ import annotations

import binascii
import queue
import threading
import time

import numpy as np
import torch

from ..observability import metrics as _om
from ..ops._graphs import CAPTURE_LOCK
from ..testing import faults as _faults

__all__ = ["KvPageTier", "TierError", "TierCapacityError",
           "TierExportError", "TierRestoreError", "TierCorruptError"]


class TierError(RuntimeError):
    """Base of every typed host-tier failure. The serving engine
    catches THIS and degrades to the pre-tier behavior (evict on
    export failure, evict -> requeue on restore failure)."""


class TierCapacityError(TierError):
    """The bounded host pool cannot hold the copy (after demoted
    prefix pages, the tier's lowest-value tenants, were evicted to
    make room)."""


class TierExportError(TierError):
    """The device-to-host copy failed (injected or real)."""


class TierRestoreError(TierError):
    """The host-to-device restore failed (injected or real); the host
    copy is freed: the fallback re-prefills, stale bytes must not
    linger."""


class TierCorruptError(TierRestoreError):
    """A page of the host copy failed its CRC check: the copy was torn
    somewhere between export and restore. Caught BEFORE anything lands
    on the device."""


#: restore latency buckets (milliseconds), the reference's
_RESTORE_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                       50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)


def _tier_metrics():
    return {
        "pages": _om.gauge(
            "kv_tier_pages",
            "KV pages currently held in the host-DRAM tier (paused "
            "sequences + demoted prefix pages)"),
        "bytes": _om.gauge(
            "kv_tier_bytes",
            "bytes of K/V data (plus int8 scale sidecars) currently "
            "held in the host-DRAM tier"),
        "restore_ms": _om.histogram(
            "kv_tier_restore_ms",
            "H2D restore latency of one paused sequence (CRC verify + "
            "device put + page scatter), milliseconds",
            buckets=_RESTORE_BUCKETS_MS),
        "errors": _om.counter(
            "kv_tier_errors_total",
            "typed host-tier failures by stage (d2h / h2d / crc / "
            "capacity); every one degraded to the pre-tier behavior",
            labelnames=("stage",)),
    }


def _gather_host(pools, idx):
    """ONE gather a pool (``index_select`` of the pages ``idx``), then ONE
    device-to-host copy each: host tensors ``[n_pages, ...page shape]``
    the tier owns. On the card the gathers follow every write queued to
    the pools (the dispatches write them in place on their stream) and
    the copies land asynchronously in pinned memory, waited for once; on
    the CPU the gather is the copy."""
    if not pools:
        return []
    dev = pools[0].device
    cuda = dev.type == "cuda"
    with CAPTURE_LOCK:
        if cuda:
            torch.cuda.synchronize(dev)
        ix = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
        out = []
        for p in pools:
            g = p.index_select(0, ix)
            if cuda:
                h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                h.copy_(g, non_blocking=True)
                g = h
            out.append(g)
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
    return out


def _raw(a):
    """A host tensor's raw bytes as a numpy ``uint8`` view with the same
    leading page axis (bf16 has no numpy dtype)."""
    return a.view(torch.uint8).numpy()


def _page_crcs(arrays, n_pages):
    """crc32 per page SLOT, chained across every pool's bytes for that
    slot: one checksum covers a page's K, V and scale sidecars."""
    views = [_raw(a) for a in arrays]
    crcs = []
    for i in range(n_pages):
        c = 0
        for a in views:
            c = binascii.crc32(a[i], c)
        crcs.append(c)
    return crcs


def _find_corrupt_page(arrays, crcs):
    """Index of the first page slot whose recomputed CRC mismatches,
    or None when every page verifies."""
    got = _page_crcs(arrays, len(crcs))
    return next((i for i, (c, want) in enumerate(zip(got, crcs))
                 if c != want), None)


def _tear(arrays):
    """The injected torn copy: flip one byte in the middle of the
    first buffer, the minimal corruption the CRC check must catch."""
    if not arrays:
        return
    flat = _raw(arrays[0]).reshape(-1)
    flat[flat.size // 2] ^= 0xFF


def _scatter(pools, idx, devs):
    """Write ``devs`` (``[n, ...page shape]`` each) into the pages ``idx``
    of ``pools`` IN PLACE, on the current stream; no pool is rebound."""
    if not pools:
        return
    ix = torch.as_tensor(np.asarray(idx, np.int64), device=pools[0].device)
    for p, d in zip(pools, devs):
        p.index_copy_(0, ix, d.to(p.device, p.dtype, non_blocking=True))


class _HostSeq:
    """One paused sequence's host copy: per-pool page tensors (gather
    order: k layers, v layers, then scale sidecars when present),
    per-page-slot CRCs committed to the SOURCE bytes, the byte account
    the bounded pool charges, and the pools' device (staging's
    target)."""

    __slots__ = ("key", "n_tokens", "n_pages", "arrays", "crcs",
                 "nbytes", "device")

    def __init__(self, key, n_tokens, n_pages, arrays, crcs, nbytes,
                 device):
        self.key = key
        self.n_tokens = n_tokens
        self.n_pages = n_pages
        self.arrays = arrays
        self.crcs = crcs
        self.nbytes = nbytes
        self.device = device


class _HostPrefixPage:
    """One demoted prefix-cache page: single-page per-pool tensors plus
    the chain linkage (``parent`` hex key) promotion needs to re-pin it
    in chain order."""

    __slots__ = ("key", "parent", "arrays", "crc", "nbytes", "stamp")

    def __init__(self, key, parent, arrays, crc, nbytes, stamp):
        self.key = key
        self.parent = parent
        self.arrays = arrays
        self.crc = crc
        self.nbytes = nbytes
        self.stamp = stamp


def _nbytes(arrays):
    return sum(a.numel() * a.element_size() for a in arrays)


def _flat(k_pools, v_pools, k_scales, v_scales):
    return list(k_pools) + list(v_pools) + list(k_scales or []) \
        + list(v_scales or [])


class KvPageTier:
    """Bounded host-DRAM pool of paused-sequence pages and demoted
    prefix pages.

    The pool is byte-bounded (``max_bytes``): an export that does not
    fit, after evicting demoted prefix pages (the lowest-value tenants),
    raises :class:`TierCapacityError` and the engine falls back to the
    evict rung. Paused sequences are never evicted by the tier itself;
    their lifecycle (resume / cancel / deadline / drain) belongs to the
    serving engine, which must :meth:`free` every entry it parks:
    ``kv_tier_bytes`` returning to baseline is the leak check the chaos
    tests enforce. ``prefetch`` turns the restore staging on.
    """

    def __init__(self, max_bytes=256 << 20, prefetch=True):
        self.max_bytes = int(max_bytes)
        self._lock = threading.RLock()
        self._seqs: dict[int, _HostSeq] = {}
        self._prefix: dict[str, _HostPrefixPage] = {}
        self._bytes = 0
        self._next_key = 0
        self._clock = 0
        self._m = _tier_metrics()
        # plain-int stats (always on; the bench/test surface)
        self.exports = 0
        self.restores = 0
        self.export_failures = 0
        self.restore_failures = 0
        self.crc_failures = 0
        self.capacity_rejections = 0
        self.prefix_demotions = 0
        self.prefix_promotions = 0
        # async staging: spawned lazily on the first stage() call, fed a
        # bounded queue of resume candidates
        self._prefetch = bool(prefetch)
        self._stage_q: queue.Queue = queue.Queue(maxsize=2)
        self._staged: dict[int, object] = {}
        self._stage_thread = None
        self._stream = None              # the staging copies' own stream
        self._closed = False

    # -- accounting ---------------------------------------------------
    @property
    def bytes(self):
        with self._lock:
            return self._bytes

    @property
    def pages(self):
        with self._lock:
            return (sum(e.n_pages for e in self._seqs.values())
                    + len(self._prefix))

    @property
    def seq_count(self):
        with self._lock:
            return len(self._seqs)

    @property
    def prefix_count(self):
        with self._lock:
            return len(self._prefix)

    def _set_gauges_locked(self):
        self._m["bytes"].set(self._bytes)
        self._m["pages"].set(sum(e.n_pages for e in self._seqs.values())
                             + len(self._prefix))

    def _fit_locked(self, nbytes):
        """Make room for ``nbytes`` by evicting demoted prefix pages
        (LRU), never paused sequences. True when the copy fits."""
        if nbytes > self.max_bytes:
            return False
        while self._bytes + nbytes > self.max_bytes and self._prefix:
            victim = min(self._prefix.values(), key=lambda e: e.stamp)
            del self._prefix[victim.key]
            self._bytes -= victim.nbytes
        return self._bytes + nbytes <= self.max_bytes

    def stats(self):
        with self._lock:
            return {
                "bytes": self._bytes,
                "pages": (sum(e.n_pages for e in self._seqs.values())
                          + len(self._prefix)),
                "seqs": len(self._seqs),
                "prefix_pages": len(self._prefix),
                "exports": self.exports,
                "restores": self.restores,
                "export_failures": self.export_failures,
                "restore_failures": self.restore_failures,
                "crc_failures": self.crc_failures,
                "capacity_rejections": self.capacity_rejections,
                "prefix_demotions": self.prefix_demotions,
                "prefix_promotions": self.prefix_promotions,
            }

    # -- paused sequences ---------------------------------------------
    def export_seq(self, k_pools, v_pools, k_scales, v_scales, table,
                   n_tokens, step=None):
        """Copy one sequence's pages ``table`` to the host pool; returns
        the tier key the engine parks on the request. Raises
        :class:`TierExportError` (injected/failed copy) or
        :class:`TierCapacityError` (pool full). On any raise nothing is
        charged to the pool."""
        flat = _flat(k_pools, v_pools, k_scales, v_scales)
        try:
            torn = _faults.fire_copy("tier.d2h", step=step, path="seq")
            arrays = _gather_host(flat, table)
        except Exception as e:
            with self._lock:
                self.export_failures += 1
            self._m["errors"].labels("d2h").inc()
            raise TierExportError(f"D2H export failed: {e!r}") from e
        nbytes = _nbytes(arrays)
        # CRCs commit to the SOURCE bytes before any tear lands: a torn
        # copy corrupts data after the source was checksummed, which is
        # exactly what the restore-side verify must catch
        crcs = _page_crcs(arrays, len(table))
        if torn:
            _tear(arrays)
        with self._lock:
            if not self._fit_locked(nbytes):
                self.capacity_rejections += 1
                self._m["errors"].labels("capacity").inc()
                raise TierCapacityError(
                    f"host tier full: {self._bytes} + {nbytes} bytes "
                    f"> max_bytes={self.max_bytes}")
            key = self._next_key
            self._next_key += 1
            self._seqs[key] = _HostSeq(
                key, int(n_tokens), len(table), arrays, crcs, nbytes,
                flat[0].device if flat else torch.device("cpu"))
            self._bytes += nbytes
            self.exports += 1
            self._set_gauges_locked()
        return key

    def restore_seq(self, key, k_pools, v_pools, k_scales, v_scales,
                    table, step=None):
        """Restore a paused sequence into the freshly admitted pages of
        ``table`` and free the host copy. The pages are written IN PLACE
        into the given pool tensors (the decode tick's CUDA graphs baked
        their addresses), and the same four lists ``(k_pools, v_pools,
        k_scales, v_scales)`` are returned. Raises
        :class:`TierRestoreError` / :class:`TierCorruptError`; the host
        copy is freed then too (the fallback re-prefills from scratch,
        so keeping stale bytes would only leak)."""
        with self._lock:
            ent = self._seqs.get(key)
        if ent is None:
            raise TierRestoreError(f"unknown tier key {key}")
        t0 = time.perf_counter()
        try:
            torn = _faults.fire_copy("tier.h2d", step=step, path="seq")
        except Exception as e:
            self.free(key)
            with self._lock:
                self.restore_failures += 1
            self._m["errors"].labels("h2d").inc()
            raise TierRestoreError(f"H2D restore failed: {e!r}") from e
        if torn:
            _tear(ent.arrays)
        staged = self._take_staged(key)
        if staged is None:
            # CRC verify per page BEFORE anything lands on the device
            # (the staging thread verified already when `staged` is set,
            # and staging is off while a fault plan is active, so a torn
            # buffer always reaches this check)
            bad = _find_corrupt_page(ent.arrays, ent.crcs)
            if bad is not None:
                self.free(key)
                with self._lock:
                    self.crc_failures += 1
                self._m["errors"].labels("crc").inc()
                raise TierCorruptError(
                    f"host copy of tier key {key} failed CRC at page "
                    f"slot {bad}/{ent.n_pages}: torn copy detected")
        flat = _flat(k_pools, v_pools, k_scales, v_scales)
        with CAPTURE_LOCK:
            if staged is None:
                devs = ent.arrays
            else:
                devs, event = staged
                if event is not None:
                    # the staged copies were made on the staging stream
                    cur = torch.cuda.current_stream(devs[0].device)
                    cur.wait_event(event)
                    for d in devs:
                        d.record_stream(cur)
            _scatter(flat, table, devs)
        self.free(key)
        with self._lock:
            self.restores += 1
        self._m["restore_ms"].observe(
            (time.perf_counter() - t0) * 1e3)
        return k_pools, v_pools, k_scales, v_scales

    def free(self, key):
        """Drop a parked sequence's host copy (resume consumed it, or
        the request cancelled / expired / drained). Idempotent: a cancel
        racing a resume is a counted no-op. Returns True when an entry
        was actually freed."""
        with self._lock:
            self._staged.pop(key, None)
            ent = self._seqs.pop(key, None)
            if ent is None:
                return False
            self._bytes -= ent.nbytes
            self._set_gauges_locked()
            return True

    def seq_tokens(self, key):
        """Token count of a parked copy (None when unknown)."""
        with self._lock:
            ent = self._seqs.get(key)
            return ent.n_tokens if ent is not None else None

    # -- demoted prefix pages -----------------------------------------
    def put_prefix(self, key, parent, k_pools, v_pools, k_scales,
                   v_scales, page, step=None):
        """Demote ONE cold prefix-cache page into the host tier before it
        is dropped. ``key`` / ``parent`` are the chain-hash hex strings
        promotion needs to re-pin the page in chain order. Returns True
        when stored; False when the bounded pool has no room (paused
        sequences are never evicted to make one). Raises
        :class:`TierExportError` on a failed copy."""
        try:
            torn = _faults.fire_copy("tier.d2h", step=step,
                                     path="prefix")
            arrays = _gather_host(
                _flat(k_pools, v_pools, k_scales, v_scales), [page])
        except Exception as e:
            with self._lock:
                self.export_failures += 1
            self._m["errors"].labels("d2h").inc()
            raise TierExportError(
                f"prefix D2H export failed: {e!r}") from e
        nbytes = _nbytes(arrays)
        crc = _page_crcs(arrays, 1)[0]
        if torn:
            _tear(arrays)
        with self._lock:
            if key in self._prefix:
                return True                 # first writer wins
            if self._bytes + nbytes > self.max_bytes:
                self.capacity_rejections += 1
                return False
            self._clock += 1
            self._prefix[key] = _HostPrefixPage(
                key, parent, arrays, crc, nbytes, self._clock)
            self._bytes += nbytes
            self.prefix_demotions += 1
            self._set_gauges_locked()
        return True

    def has_prefix(self, key):
        with self._lock:
            return key in self._prefix

    def restore_prefix(self, key, k_pools, v_pools, k_scales, v_scales,
                       page, step=None):
        """Promote one demoted prefix page into allocator page ``page``
        (in place, as :meth:`restore_seq`, returning the same lists) and
        drop the host copy (it lives on the device again). Raises
        :class:`TierRestoreError` / :class:`TierCorruptError`; the entry
        is freed on failure (the cold path re-prefills it)."""
        with self._lock:
            ent = self._prefix.get(key)
        if ent is None:
            raise TierRestoreError(f"unknown prefix key {key!r}")

        def _drop():
            with self._lock:
                e = self._prefix.pop(key, None)
                if e is not None:
                    self._bytes -= e.nbytes
                    self._set_gauges_locked()

        try:
            torn = _faults.fire_copy("tier.h2d", step=step,
                                     path="prefix")
        except Exception as e:
            _drop()
            with self._lock:
                self.restore_failures += 1
            self._m["errors"].labels("h2d").inc()
            raise TierRestoreError(
                f"prefix H2D restore failed: {e!r}") from e
        if torn:
            _tear(ent.arrays)
        if _find_corrupt_page(ent.arrays, [ent.crc]) is not None:
            _drop()
            with self._lock:
                self.crc_failures += 1
            self._m["errors"].labels("crc").inc()
            raise TierCorruptError(
                f"host copy of prefix page {key!r} failed CRC: torn "
                f"copy detected")
        with CAPTURE_LOCK:
            _scatter(_flat(k_pools, v_pools, k_scales, v_scales),
                     [int(page)], ent.arrays)
        _drop()
        with self._lock:
            self.prefix_promotions += 1
        return k_pools, v_pools, k_scales, v_scales

    def prefix_parent(self, key):
        with self._lock:
            ent = self._prefix.get(key)
            return ent.parent if ent is not None else None

    # -- async restore staging ----------------------------------------
    def stage(self, key):
        """Hint that ``key`` is the next resume candidate: a daemon
        thread CRC-verifies its host copy and copies it to the device so
        the boundary restore finds it there. Best-effort, and a no-op
        while a fault plan is active (chaos runs must hit the
        synchronous verify/restore path deterministically)."""
        if not self._prefetch or self._closed or _faults.active():
            return
        with self._lock:
            if key not in self._seqs or key in self._staged:
                return
            self._staged[key] = None        # queued, not ready
            if self._stage_thread is None:
                self._stage_thread = threading.Thread(
                    target=self._stage_worker, daemon=True,
                    name="kv-tier-stage")
                self._stage_thread.start()
        try:
            self._stage_q.put_nowait(key)
        except queue.Full:
            with self._lock:
                self._staged.pop(key, None)

    def _to_device(self, ent):
        """The staging copy of ``ent``: ``(device tensors, event)``. On
        the card the copies run on the tier's own stream and the event
        marks their end; on the CPU the host tensors are the device's and
        there is no event."""
        dev = ent.device
        if dev.type != "cuda":
            return list(ent.arrays), None
        with CAPTURE_LOCK, torch.cuda.device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(self._stream):
                devs = [a.to(dev, non_blocking=True) for a in ent.arrays]
                event = torch.cuda.Event()
                event.record(self._stream)
        return devs, event

    def _stage_worker(self):
        while not self._closed:
            try:
                key = self._stage_q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._lock:
                ent = self._seqs.get(key)
                pending = key in self._staged
            if ent is None or not pending:
                continue
            if _find_corrupt_page(ent.arrays, ent.crcs) is not None:
                # leave it to the synchronous restore path, which types
                # the corruption and falls back
                with self._lock:
                    self._staged.pop(key, None)
                continue
            staged = self._to_device(ent)
            with self._lock:
                if key in self._staged and key in self._seqs:
                    self._staged[key] = staged

    def _take_staged(self, key):
        with self._lock:
            return self._staged.pop(key, None)

    def close(self):
        """Stop the staging thread (idempotent; entries stay)."""
        self._closed = True
        t = self._stage_thread
        if t is not None:
            t.join(timeout=1.0)
            self._stage_thread = None
