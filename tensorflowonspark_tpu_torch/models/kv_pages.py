"""Host-side page pool + shared prefix index for the paged KV decode cache.

The port's own copy of ``tensorflowonspark_tpu/models/kv_pages.py`` (numpy
only; the JAX package cannot be imported without JAX), unchanged in
behaviour and held to the reference's cases by
``tests/test_torch_kv_pages.py``.

The device side of KV paging lives in ``models/gpt.py`` (a per-layer K/V
POOL of ``kv_pool_pages`` fixed-size pages indexed through a per-row
block table) and the admission machinery in ``models/serving.py``.  This
module is the pure-Python allocator those layers share: which physical
page holds which logical page of which request, which pages several
requests SHARE because their prompts start identically, and which cached
pages to evict when the pool runs dry.

Why pages (vLLM's PagedAttention, Kwon et al. 2023): a dense cache
reserves ``max_batch x max_position_embeddings`` K/V slots whether or
not they are live, so admission capacity is slots, not memory.  With
pages, a request holds exactly ``ceil((prompt + budget) / page_tokens)``
pages and admission backpressures on FREE PAGES — short requests pack
many-per-slot's-worth of memory, long ones are refused before they can
OOM the pool.

Why a prefix index (SGLang's RadixAttention, Zheng et al. 2023): the
million-user workload is many requests over FEW distinct system prompts.
K/V for positions ``0..m*page_tokens-1`` is a pure function of tokens
``0..m*page_tokens-1`` (causal attention, absolute positions), so a page
whose full token prefix matches can be SHARED read-only instead of
re-prefilled.  The index maps a page-granular CHAINED content hash (page
``i``'s key digests the page's tokens AND page ``i-1``'s key, so equal
keys imply equal full prefixes, not just equal pages) to the physical
page holding that K/V.

Lifecycle rules (locked by ``tests/test_kv_pages.py``):

- ``admit`` matches the longest indexed chain over the prompt's full
  pages — capped so at least ONE prompt token remains to prefill (the
  first generated token needs the last prompt position's logits, and a
  shared page must never be re-written) — then allocates fresh pages
  for the tail.  Matched pages get a refcount each; divergence past the
  match is copy-on-write by construction: the diverging page is a fresh
  private page the request prefills itself, the shared original is
  untouched.
- ``commit`` (called once the prefill that computes their K/V has been
  dispatched) inserts the request's own full prompt pages into the
  index; the request holds a refcount on every page it shares or
  indexed.
- ``release`` (request finished) drops those refcounts and frees the
  request's unindexed pages (decode tail, partial prompt page).  An
  indexed page at refcount 0 is NOT freed: it parks in an LRU of
  reusable cached pages and is evicted — removed from the index, its
  K/V forgotten — only when allocation needs it.  ``free_pages`` (the
  admission/backpressure signal) therefore counts free + evictable.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _page_key(prev: bytes, tokens: np.ndarray) -> bytes:
    """Chained content key of one full token page: digests the previous
    page's key, so equal keys imply equal whole prefixes."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def chain_keys(prompt: np.ndarray, page_tokens: int) -> list[bytes]:
    """Chained content keys for every FULL page of ``prompt`` — computed
    identically by the exporting (prefill) and adopting (decode) sides
    of a KV-page handoff, so a transfer keyed on them can never seat a
    session against the wrong prefix."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    keys: list[bytes] = []
    prev = b""
    for i in range(prompt.size // page_tokens):
        prev = _page_key(prev, prompt[i * page_tokens:(i + 1) * page_tokens])
        keys.append(prev)
    return keys


def hash_page_data(arrays, n_pages: int) -> list[bytes]:
    """Per-page content hash of gathered KV page data: page ``j``'s
    digest covers its slice of EVERY leaf (all layers, K and V), so a
    corrupt or torn transfer of any byte of a page fails verification.
    ``arrays`` are the batcher's gathered pool leaves — page axis at
    ``ndim - 4`` (``[..., page, page_tokens, heads, head_dim]``)."""
    out: list[bytes] = []
    for j in range(int(n_pages)):
        h = hashlib.blake2b(digest_size=16)
        for a in arrays:
            a = np.asarray(a)
            h.update(np.ascontiguousarray(
                np.take(a, j, axis=a.ndim - 4)).tobytes())
        out.append(h.digest())
    return out


class PageLease:
    """One request's hold on pool pages: the physical page per logical
    page (``page_ids[i]`` backs token positions ``i*page_tokens ..``),
    how many leading pages are SHARED from the prefix index
    (read-only), and the bookkeeping ``KVPagePool.commit``/``release``
    need.  ``tail_start = n_shared * page_tokens`` is the first prompt
    position the request must prefill itself."""

    __slots__ = ("page_ids", "n_shared", "tail_start", "outcome",
                 "_insert", "_held", "_released")

    def __init__(self, page_ids: list[int], n_shared: int,
                 page_tokens: int, outcome: str,
                 insert: list[tuple[bytes, int]]):
        self.page_ids = list(page_ids)
        self.n_shared = int(n_shared)
        self.tail_start = int(n_shared) * int(page_tokens)
        self.outcome = outcome          # "hit" | "partial" | "miss"
        self._insert = insert           # (chain_key, page_id) to index
        self._held = list(page_ids[:n_shared])  # refcounted holds
        self._released = False


class KVPagePool:
    """Allocator + refcounted prefix index over ``total_pages`` physical
    pages of ``page_tokens`` tokens each (module docstring).  Driven by
    one thread (the batcher's); no lock of its own."""

    def __init__(self, total_pages: int, page_tokens: int, *,
                 prefix_cache: bool = True):
        if total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got {total_pages}")
        if page_tokens < 1 or page_tokens & (page_tokens - 1):
            raise ValueError(f"page_tokens must be a positive power of "
                             f"two, got {page_tokens}")
        self.total_pages = int(total_pages)
        self.page_tokens = int(page_tokens)
        self.prefix_cache = bool(prefix_cache)
        self._free: list[int] = list(range(self.total_pages - 1, -1, -1))
        self._index: dict[bytes, int] = {}     # chain key -> page id
        self._key_of: dict[int, bytes] = {}    # page id -> chain key
        self._ref: dict[int, int] = {}         # indexed page -> holders
        #: refcount-0 indexed pages, oldest-released first (dict
        #: preserves insertion order = the LRU order)
        self._lru: dict[int, None] = {}
        self.hits = 0
        self.misses = 0
        self.partials = 0
        self.evictions = 0

    # -- capacity ----------------------------------------------------------
    def free_pages(self) -> int:
        """Allocatable pages RIGHT NOW: free + evictable cached — the
        admission backpressure signal ``ContinuousBatcher.load()``
        carries to the scheduler's routing tie-break."""
        return len(self._free) + len(self._lru)

    def cached_pages(self) -> int:
        """Indexed pages currently held by no request (reusable until
        evicted)."""
        return len(self._lru)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-int(total_tokens) // self.page_tokens)

    def stats(self) -> dict:
        return {"hit": self.hits, "miss": self.misses,
                "partial": self.partials, "evictions": self.evictions,
                "free_pages": self.free_pages(),
                "cached_pages": self.cached_pages(),
                "total_pages": self.total_pages}

    # -- admission ---------------------------------------------------------
    def match_tokens(self, prompt: np.ndarray) -> int:
        """How many leading prompt tokens an ``admit`` right now would
        cover from the prefix index — a SIDE-EFFECT-FREE peek (no
        refcounts, no allocation, no eviction, no stats).  The paged
        batcher uses it to decide chunked-admission skips without
        leasing: a trial lease's allocation could evict cached prefix
        pages that an immediate release cannot restore."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not self.prefix_cache or prompt.size == 0:
            return 0
        pt = self.page_tokens
        shareable = min(prompt.size // pt, (prompt.size - 1) // pt)
        matched = 0
        prev = b""
        for i in range(shareable):
            prev = _page_key(prev, prompt[i * pt:(i + 1) * pt])
            if prev not in self._index:
                break
            matched += 1
        return matched * pt

    def admit(self, prompt: np.ndarray, total_tokens: int) \
            -> PageLease | None:
        """Lease pages for one request: longest-indexed-chain prefix
        match over the prompt's full pages, fresh pages for the rest of
        ``total_tokens`` (prompt tail + decode budget).  None when the
        pool cannot allocate the tail — the caller keeps the request
        queued (admission backpressure).  Outcome counters move at
        ``commit`` time, so an abandoned lease (released uncommitted)
        never skews the hit rate."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pt = self.page_tokens
        if not 0 < prompt.size <= total_tokens:
            raise ValueError(f"bad lease shape: prompt {prompt.size}, "
                             f"total {total_tokens}")
        n_logical = self.pages_needed(total_tokens)
        # with the index disabled there is nothing to hash: no match to
        # attempt, no insert to prepare (commit() skips insertion too)
        n_full = prompt.size // pt if self.prefix_cache else 0
        # cap the match so >= 1 prompt token stays unprefilled: shared
        # pages are read-only, and the first generated token needs the
        # last prompt position run through the model
        shareable = min(n_full, (prompt.size - 1) // pt)
        keys: list[bytes] = []
        prev = b""
        for i in range(n_full):
            prev = _page_key(prev, prompt[i * pt:(i + 1) * pt])
            keys.append(prev)
        matched: list[int] = []
        for i in range(shareable):
            pid = self._index.get(keys[i])
            if pid is None:
                break
            matched.append(pid)
        fresh = self._allocate(n_logical - len(matched), protect=matched)
        if fresh is None:
            return None
        for pid in matched:         # hold AFTER allocation succeeded
            self._ref[pid] += 1
            self._lru.pop(pid, None)
        outcome = ("miss" if not matched
                   else "hit" if len(matched) == shareable else "partial")
        insert = [(keys[i], fresh[i - len(matched)])
                  for i in range(len(matched), n_full)]
        return PageLease(matched + fresh, len(matched), pt, outcome,
                         insert)

    def adopt(self, prompt: np.ndarray, total_tokens: int) \
            -> PageLease | None:
        """Lease pages to ADOPT a handed-off session whose prompt K/V
        was computed elsewhere (a prefill gang) and arrives as imported
        page data instead of a local prefill.

        Like :meth:`admit`, the longest indexed chain over the prompt's
        full pages is shared (those pages need no data import at all —
        cross-request prefix reuse composes with the handoff), and fresh
        pages cover the rest of ``total_tokens``.  Unlike ``admit``
        there is no ">= 1 prompt token re-runs" cap: nothing is
        prefilled here, the session already carries its first token, so
        EVERY full prompt page is shareable and indexable.  The caller
        imports data into ``page_ids[n_shared : ceil(prompt/page_tokens)]``
        and then :meth:`commit` s, making the imported pages matchable.
        None when the pool cannot allocate (admission backpressure)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pt = self.page_tokens
        if not 0 < prompt.size <= total_tokens:
            raise ValueError(f"bad adopt shape: prompt {prompt.size}, "
                             f"total {total_tokens}")
        n_logical = self.pages_needed(total_tokens)
        n_full = prompt.size // pt if self.prefix_cache else 0
        keys = chain_keys(prompt, pt) if self.prefix_cache else []
        matched: list[int] = []
        for i in range(n_full):
            pid = self._index.get(keys[i])
            if pid is None:
                break
            matched.append(pid)
        fresh = self._allocate(n_logical - len(matched), protect=matched)
        if fresh is None:
            return None
        for pid in matched:         # hold AFTER allocation succeeded
            self._ref[pid] += 1
            self._lru.pop(pid, None)
        outcome = ("miss" if not matched
                   else "hit" if len(matched) == n_full else "partial")
        insert = [(keys[i], fresh[i - len(matched)])
                  for i in range(len(matched), n_full)]
        return PageLease(matched + fresh, len(matched), pt, outcome,
                         insert)

    def adopt_cached(self, keys) -> dict[bytes, int]:
        """Import bare CACHED prefix pages (a peer's cloned prefix index
        at standby promotion): allocate a page per unseen key off the
        free list — never evicting resident cached pages for imported
        ones — and park it in the LRU at refcount 0, indexed and
        matchable once the caller has written its K/V.  Keys must arrive
        in the donor's insertion order (chain parents precede children),
        so truncating at capacity keeps every imported chain reachable.
        Returns ``{key: page_id}`` for the pages actually allocated."""
        out: dict[bytes, int] = {}
        if not self.prefix_cache:
            return out
        for key in keys:
            if key in self._index:
                continue
            if not self._free:
                break
            pid = self._free.pop()
            self._index[key] = pid
            self._key_of[pid] = key
            self._ref[pid] = 0
            self._lru[pid] = None
            out[key] = pid
        return out

    def export_index(self) -> list[tuple[bytes, int]]:
        """Every indexed (chain key, physical page) pair in insertion
        order — parents precede children, so an importer consuming a
        prefix of this list never creates an unreachable chain."""
        return list(self._index.items())

    def _allocate(self, n: int, protect: list[int]) -> list[int] | None:
        """``n`` pages off the free list, evicting oldest refcount-0
        cached pages when it runs dry; None when even eviction cannot
        cover the request.  ``protect`` (the pages a concurrent match
        just selected) must not be evicted to serve the same lease."""
        avoid = set(protect)
        evictable = sum(1 for pid in self._lru if pid not in avoid)
        if n > len(self._free) + evictable:
            return None
        out: list[int] = []
        lru_iter = iter([pid for pid in self._lru if pid not in avoid])
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
                continue
            pid = next(lru_iter)
            del self._lru[pid]
            del self._index[self._key_of.pop(pid)]
            del self._ref[pid]
            self.evictions += 1
            out.append(pid)
        return out

    def commit(self, lease: PageLease) -> None:
        """Index the lease's own full prompt pages (their K/V has been
        computed by a dispatched prefill) and count the admission
        outcome.  Duplicate content (two identical prompts admitted in
        the same round, before either committed) keeps the FIRST page;
        the loser's copy stays a private unindexed page and frees at
        release."""
        if lease.outcome == "hit":
            self.hits += 1
        elif lease.outcome == "partial":
            self.partials += 1
        else:
            self.misses += 1
        if self.prefix_cache:
            for key, pid in lease._insert:
                if key in self._index:
                    continue
                self._index[key] = pid
                self._key_of[pid] = key
                self._ref[pid] = 1
                lease._held.append(pid)
        lease._insert = []

    def release(self, lease: PageLease) -> None:
        """Return a finished (or abandoned) request's pages: refcounted
        holds drop one holder — at zero the page parks in the LRU, still
        indexed — and unindexed pages go straight back to the free
        list.  Idempotent."""
        if lease._released:
            return
        lease._released = True
        held = set(lease._held)
        for pid in lease.page_ids:
            if pid in held:
                self._ref[pid] -= 1
                if self._ref[pid] == 0:
                    self._lru[pid] = None
            else:
                self._free.append(pid)
        lease._insert = []
