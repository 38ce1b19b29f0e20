"""Shared-prefix KV cache: content-addressed page reuse across requests
(port of ``paddle_tpu/inference/prefix_cache.py``; host Python only).

The traffic it serves is thousands of requests that share a long
page-aligned prefix (a system prompt, a few-shot header) followed by a
short unique suffix. Without reuse every request re-prefills the whole
prompt; with it the prefix is prefilled ONCE per engine and later
requests admit directly against the cached pages, paying only the
suffix.

Design:

- **Content addressing by chain hash.** Page ``i`` of a prompt is keyed
  by ``H(key_{i-1} || tokens_of_page_i)``: a page's key commits to the
  entire token prefix before it, so two prompts share a cached page
  only when every token up to and including that page is identical.
  The keys are the reference's byte for byte (same seed, SHA-1, int64
  token bytes), so a router hashing prompts for either package scores
  the same prefixes.
- **Page granularity.** Only FULL pages are cached (a partial page's
  K/V layout depends on tokens that haven't arrived), and a match never
  covers the final prompt token: the engine needs at least one real
  token to run through the model to produce the first-output logits.
  Because matches are therefore page-aligned, a sequence admitted on
  cached pages writes its suffix K/V into pages it exclusively owns;
  the shared pages stay immutable (and :meth:`PageAllocator
  .ensure_writable` copy-on-writes as a backstop).
- **Refcounted pinning.** The cache holds one allocator reference per
  cached page (``PageAllocator`` refcounts), so pages survive the
  sequence that prefilled them and are freed only when evicted here
  AND unreferenced by every live sequence.
- **LRU eviction, leaves first.** Evicting a middle page would strand
  its descendants unreachable (their keys chain through it), so only
  chain tails are eviction candidates; under pool pressure the serving
  engine asks the cache to give pages back before walking its
  degradation ladder.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

__all__ = ["PrefixCache", "chain_keys", "cacheable_pages"]

# the reference's chain seed, bytes for bytes (written in two literals)
_SEED = b"paddle_tpu" b".prefix"


def cacheable_pages(n_tokens, page_size):
    """Full pages of an ``n_tokens`` prompt eligible for caching —
    never covering the final token (the engine must run at least one
    real token through the model to get first-output logits)."""
    full = n_tokens // page_size
    if full and full * page_size >= n_tokens:
        full -= 1
    return full


def chain_keys(prompt_ids, page_size, n_pages=None, limit=None):
    """Chain-hash keys for a prompt's full page-aligned prefix pages.

    Page ``i`` is keyed by ``H(key_{i-1} || tokens_of_page_i)`` — the
    content address :class:`PrefixCache` stores pages under. Module-
    level so the cluster router can score prefix affinity with the
    SAME hashing a replica's cache uses, without holding any cache.
    ``limit`` caps the number of keys (hashing cost bound on the
    routing hot path)."""
    ids = np.asarray(prompt_ids, np.int64).reshape(-1)
    if n_pages is None:
        n_pages = cacheable_pages(len(ids), page_size)
    if limit is not None:
        n_pages = min(n_pages, int(limit))
    keys, prev = [], _SEED
    for i in range(n_pages):
        chunk = ids[i * page_size:(i + 1) * page_size]
        prev = hashlib.sha1(prev + chunk.tobytes()).digest()
        keys.append(prev)
    return keys


class _Entry:
    __slots__ = ("page", "key", "parent", "children", "last_used",
                 "depth")

    def __init__(self, page, key, parent, depth):
        self.page = page
        self.key = key
        self.parent = parent        # parent entry key, or None
        self.children = 0           # cached entries chaining through us
        self.last_used = 0
        self.depth = depth


class PrefixCache:
    """Per-engine (per-replica) shared-prefix page cache.

    Args:
        alloc: the engine's :class:`PageAllocator` (pages cached here
            are pinned with one allocator reference each).
        page_size: tokens per page; defaults to the allocator's.
        max_pages: optional cap on cached pages; inserting past it
            evicts LRU tails first.
    """

    def __init__(self, alloc, page_size=None, max_pages=None):
        self.alloc = alloc
        self.page_size = int(page_size or alloc.page_size)
        self.max_pages = max_pages
        self._entries: dict[bytes, _Entry] = {}
        # eviction candidates (entries no cached child chains through):
        # maintained incrementally so an eviction scans leaves — the
        # number of distinct chains — not every cached page
        self._leaves: dict[bytes, _Entry] = {}
        self._clock = 0
        self._lock = threading.RLock()
        # plain-int stats (always on); the engine layers the
        # serving_prefix_* metrics on top
        self.lookups = 0
        self.hits = 0
        self.saved_tokens = 0
        self.evictions = 0
        # demotion hook (host-DRAM KV tier): called as
        # ``demote(key, parent_key, page)`` for each page evict_pages
        # is about to drop, BEFORE its reference is released — the
        # serving engine wires it to a D2H copy into the host tier so
        # a cold system prompt survives pressure. Best-effort: any
        # exception is swallowed (the old behavior IS dropping the
        # page).
        self.demote = None

    # ------------------------------------------------------------------
    def _keys(self, prompt_ids, n_pages):
        """Chain keys for the first ``n_pages`` full pages."""
        return chain_keys(prompt_ids, self.page_size, n_pages=n_pages)

    def _cacheable_pages(self, n_tokens):
        return cacheable_pages(n_tokens, self.page_size)

    @property
    def pages(self):
        return len(self._entries)

    def hot_keys(self, n=16):
        """Hex chain keys of the ``n`` most recently used cached pages —
        the replica's advertised hot-prefix set. The cluster router
        hashes an incoming prompt with :func:`chain_keys` and scores
        replicas by overlap (prefix-affinity routing), so requests
        sharing a hot prefix land where its K/V already lives."""
        import heapq

        with self._lock:
            # nlargest, not a full sort: this runs per routable replica
            # per routing decision, and the cache can hold thousands of
            # entries
            es = heapq.nlargest(int(n), self._entries.values(),
                                key=lambda e: e.last_used)
            return [e.key.hex() for e in es]

    # ------------------------------------------------------------------
    def match(self, prompt_ids, record=True):
        """Longest cached page chain covering this prompt's prefix.

        Returns ``(pages, n_tokens)`` — the cached page ids (in prompt
        order) and the token count they cover (a multiple of
        ``page_size``, strictly less than ``len(prompt_ids)``). The
        caller passes ``pages`` to :meth:`PageAllocator.admit` as
        ``shared_pages`` (which takes the per-sequence references);
        this method takes none and only touches recency.

        ``record=False`` skips the lookup/hit/saved-token stats — for
        an admission's internal RE-match after a pressure retry, so
        one admission never counts twice."""
        n = len(np.asarray(prompt_ids).reshape(-1))
        with self._lock:
            if record:
                self.lookups += 1
            cand = self._cacheable_pages(n)
            pages = []
            for key in self._keys(prompt_ids, cand):
                e = self._entries.get(key)
                if e is None:
                    break
                self._clock += 1
                e.last_used = self._clock
                pages.append(e.page)
            if pages and record:
                self.hits += 1
                self.saved_tokens += len(pages) * self.page_size
            return pages, len(pages) * self.page_size

    def insert(self, prompt_ids, table):
        """Register a prefilled prompt's full pages for reuse.

        ``table`` is the sequence's block table (pages in prompt
        order). Every cacheable page not already present is pinned with
        one allocator reference. Present keys are left alone — the
        first writer wins, and a concurrent duplicate simply keeps its
        private pages. Returns the number of pages newly cached."""
        n = len(np.asarray(prompt_ids).reshape(-1))
        added = 0
        with self._lock:
            cand = min(self._cacheable_pages(n), len(table))
            parent = None
            for i, key in enumerate(self._keys(prompt_ids, cand)):
                e = self._entries.get(key)
                if e is None:
                    try:
                        self.alloc.incref(table[i])
                    except ValueError:
                        break       # page vanished (caller raced a release)
                    e = _Entry(table[i], key, parent, depth=i)
                    self._clock += 1
                    e.last_used = self._clock
                    self._entries[key] = e
                    self._leaves[key] = e
                    if parent is not None:
                        p = self._entries[parent]
                        p.children += 1
                        self._leaves.pop(parent, None)
                    added += 1
                parent = key
            if self.max_pages is not None:
                over = len(self._entries) - self.max_pages
                if over > 0:
                    self.evict_pages(over)
        return added

    def pin(self, key, page, parent=None, depth=0):
        """Adopt an already-allocated page under chain key ``key`` —
        the host-tier PROMOTION path: a demoted page was H2D-restored
        into ``page`` and rejoins the cache. The caller transfers ONE
        existing allocator reference (no incref here; on False the
        caller keeps its reference and should give the page back).
        ``parent`` must already be cached when given — promotion walks
        chains in order, so a dangling parent means the caller raced
        an eviction and the page is rejected. Returns True when
        adopted."""
        with self._lock:
            if key in self._entries:
                return False
            if parent is not None and parent not in self._entries:
                return False
            e = _Entry(page, key, parent, depth=depth)
            self._clock += 1
            e.last_used = self._clock
            self._entries[key] = e
            self._leaves[key] = e
            if parent is not None:
                p = self._entries[parent]
                p.children += 1
                self._leaves.pop(parent, None)
            return True

    # ------------------------------------------------------------------
    def evict_pages(self, n_pages):
        """Release up to ``n_pages`` cached pages, LRU chain-tails
        first. Returns how many pages went back to the allocator's
        free list (a page shared with a live sequence is unpinned from
        the cache but only frees once that sequence releases it)."""
        freed = 0
        with self._lock:
            for _ in range(int(n_pages)):
                if not self._leaves:
                    break
                v = min(self._leaves.values(),
                        key=lambda e: e.last_used)
                if self.demote is not None:
                    try:
                        self.demote(v.key, v.parent, v.page)
                    except Exception:
                        pass    # demotion is best-effort by contract
                del self._entries[v.key]
                del self._leaves[v.key]
                if v.parent is not None and v.parent in self._entries:
                    p = self._entries[v.parent]
                    p.children -= 1
                    if p.children == 0:
                        self._leaves[v.parent] = p
                self.evictions += 1
                if self.alloc.decref(v.page):
                    freed += 1
        return freed

    def clear(self):
        """Invalidate everything (weights reload, tokenizer change —
        any event that makes cached K/V wrong). Returns pages freed."""
        with self._lock:
            return self.evict_pages(len(self._entries))

    def stats(self):
        with self._lock:
            return {"pages": len(self._entries),
                    "lookups": self.lookups, "hits": self.hits,
                    "hit_rate": (self.hits / self.lookups
                                 if self.lookups else 0.0),
                    "saved_tokens": self.saved_tokens,
                    "evictions": self.evictions}
