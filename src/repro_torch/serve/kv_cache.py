"""Paged KV cache: fixed-size pages, free-list allocator, block tables
(PyTorch port of ``repro.serve.kv_cache``).

Each layer's cache is a shared pool of fixed-size **pages**:

    k_pages / v_pages : (Hkv, num_pages + 1, page_size, D)
    kv_pages          : (1, num_pages + 1, page_size, r + dr)   (MLA)

A sequence owns an ordered **block table** of pool-page indices; logical
position ``t`` lives at ``(block_table[t // page_size], t % page_size)``.
Pages are handed out page-at-a-time from a host-side free list, so a
retiring request's pages are immediately reusable by the next admission
(serve/engine.py).

**The sink page.**  Every pool carries one page more than it serves:
index ``num_pages``, the last, which the allocator never hands out.  The
reference scatters the writes of inactive slots, of speculative tails
past a block table and of pad rows to index ``num_pages`` with
``mode="drop"``; PyTorch has no dropping scatter, so the port sends those
writes to the sink instead.  The scatter stays one ``index_put_`` on the
device (no mask select, so no host sync), and no live row is ever
written by a dropped one.  ``num_pages``, :func:`page_bytes`, the
allocator, its audit and :func:`find_nonfinite_pages` do not count the
sink; :func:`pool_num_pages` gives the served count of a pool.

**int8 pools** (``kv_dtype="int8"``): pages store int8 rows plus ONE f32
scale per (kv-head, page), ``k_scales``/``v_scales`` of shape
(Hkv, num_pages + 1) — the sink has a scale column too (MLA: one
``kv_scales`` (1, num_pages + 1) row for its shared pool).  Quantization
happens at write time (:func:`write_prompt_pages` per page,
:func:`quant_page_update` per decode token) with the shared
``optim.quant`` convention; the paged kernel dequantizes as it reads.

The JAX versions of the pool writers are pure functions that the engine
jits with donated pools; here they update the pools in place.  The
allocator and the radix tree are plain Python, copied from the
reference.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch.optim.quant import quant_with_scale, scale_for, scale_from_amax

#: serving pool dtypes: per-page-per-head f32 scales appear iff int8
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


class PoolAuditError(RuntimeError):
    """The page pool's bookkeeping is inconsistent (leak, double
    ownership, free/live overlap, ...) — serving on it would hand one
    sequence's KV to another or strand capacity forever."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache rows."""
    return -(-n_tokens // page_size)




class PageAllocator:
    """Free-list page allocator with refcounted sharing.

    Pages are recycled LIFO so a retire-then-admit reuses hot pages.
    ``alloc`` is all-or-nothing (raises before handing out a partial
    set) and hands pages out at refcount 1.  Sharing is explicit:
    ``ref`` pins a live page for another reader (the prefix cache, a
    second sequence sharing a prompt prefix), ``release`` drops one
    reference and recycles the page only when the LAST reader lets go.
    ``free`` is the strict single-owner API: it rejects double-frees,
    foreign pages AND pages other readers still hold — a shared page
    must be ``release``d, never hard-freed out from under its readers.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs: dict[int, int] = {}
        self._quarantined: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._refs)

    @property
    def num_shared(self) -> int:
        """Pages currently held by more than one reader."""
        return sum(1 for r in self._refs.values() if r >= 2)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            raise MemoryError(
                f"requested {n} pages, {len(self._free)} free "
                f"of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages) -> None:
        """Pin live pages for an additional reader (refcount++)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"cannot ref page {p}: not allocated")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages) -> None:
        """Drop one reference per page; recycle at refcount zero."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not allocated (double free?)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    def free(self, pages) -> None:
        """Single-owner free: rejects pages with live co-readers."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not allocated (double free?)")
            if self._refs[p] > 1:
                raise ValueError(
                    f"page {p} has {self._refs[p] - 1} live reader(s) — "
                    "release() shared pages instead of free()")
        self.release(pages)

    # -- fault containment --------------------------------------------------

    @property
    def num_quarantined(self) -> int:
        return len(self._quarantined)

    def quarantine(self, pages) -> int:
        """Remove pages from circulation entirely: a poisoned page (NaN
        rows, a lost board's HBM slice) must never be handed to a future
        admission.  Accepts free OR live pages — a live page loses ALL
        its references, so callers must tear down (or have already torn
        down) every owner first; the serving supervisor drops radix
        nodes and victim slots before quarantining.  Idempotent per
        page.  Returns the number newly quarantined."""
        n = 0
        for p in pages:
            p = int(p)
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range "
                                 f"[0, {self.num_pages})")
            if p in self._quarantined:
                continue
            if p in self._refs:
                del self._refs[p]
            else:
                self._free.remove(p)
            self._quarantined.add(p)
            n += 1
        return n

    def audit(self, owners: dict | None = None) -> dict:
        """Cross-check the pool's bookkeeping; raise
        :class:`PoolAuditError` listing every violation, else return a
        summary ``{"free", "live", "shared", "quarantined"}``.

        Internal invariants (always checked): the free list holds no
        duplicates, no page is simultaneously free and live (the
        double-ownership a ``pool_corrupt`` fault injects: the next
        alloc would hand a live slot's page to a new sequence), no page
        is quarantined AND circulating, every page is accounted for
        (free + live + quarantined == num_pages — a vanished page is a
        leak), and every live refcount is positive.

        ``owners`` optionally cross-checks CLAIMED ownership: a mapping
        of claimant name -> list of pages it believes it holds one
        reference on (engine slots, the radix tree).  Every live page's
        refcount must equal its total claim count — an excess claim is
        double ownership (two owners will both write the page), a
        missing claim is a leak (a reference nobody will ever release).
        """
        problems = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            dupes = sorted(p for p, c in Counter(self._free).items()
                           if c > 1)
            problems.append(f"free list holds duplicates: {dupes}")
        overlap = sorted(free_set & self._refs.keys())
        if overlap:
            problems.append(f"pages both free and live: {overlap}")
        qlap = sorted(self._quarantined
                      & (free_set | self._refs.keys()))
        if qlap:
            problems.append(f"quarantined pages still circulating: {qlap}")
        known = free_set | self._refs.keys() | self._quarantined
        missing = sorted(set(range(self.num_pages)) - known)
        if missing:
            problems.append(f"pages vanished (leaked): {missing}")
        alien = sorted(p for p in known
                       if not 0 <= p < self.num_pages)
        if alien:
            problems.append(f"out-of-range pages tracked: {alien}")
        badref = sorted(p for p, r in self._refs.items() if r <= 0)
        if badref:
            problems.append(f"non-positive refcounts: {badref}")
        if owners is not None:
            claims: Counter = Counter()
            holders: dict[int, list] = {}
            for name, pages in owners.items():
                for p in pages:
                    claims[int(p)] += 1
                    holders.setdefault(int(p), []).append(name)
            for p, c in sorted(claims.items()):
                r = self._refs.get(p, 0)
                if c > r:
                    problems.append(
                        f"page {p}: {c} claims > refcount {r} "
                        f"(double ownership by {holders[p]})")
            for p, r in sorted(self._refs.items()):
                c = claims.get(p, 0)
                if c < r:
                    problems.append(
                        f"page {p}: refcount {r} > {c} claim(s) "
                        f"(leaked reference)")
        if problems:
            raise PoolAuditError("; ".join(problems))
        return {"free": len(self._free), "live": len(self._refs),
                "shared": self.num_shared,
                "quarantined": len(self._quarantined)}


# ---------------------------------------------------------------------------
# radix prefix cache
# ---------------------------------------------------------------------------


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _RadixNode:
    __slots__ = ("chunk", "page", "children", "last_used")

    def __init__(self, chunk=(), page=-1):
        self.chunk = chunk  # the <= page_size tokens this page holds
        self.page = page    # pool page id (tree holds ONE allocator ref)
        self.children = {}  # chunk tuple -> _RadixNode
        self.last_used = 0


class RadixPrefixCache:
    """Radix tree over PAGE-GRANULAR token chunks → pool pages.

    Classic radix trees split edges at arbitrary token offsets; here a
    node IS one pool page, so edges can only be ≤ ``page_size`` tokens
    and never split — the tree mirrors the physical page layout exactly
    and a lookup's answer is directly a block-table prefix.  The tree
    holds one allocator reference per adopted page; ``lookup`` pins a
    second reference per returned page for the caller (the admitting
    slot), so a hot prefix stays resident however many sequences read
    it and however often eviction runs.

    Partial-overlap matches are allowed (a node whose chunk shares only
    its first ``o`` tokens with the query still contributes ``o``
    tokens + its page): rows past the match are masked by the reader's
    cache ``len`` and a reader never writes a shared page (the engine
    COW-forks partially-filled tails), so stale tail rows are exactly
    as harmless as a recycled page's garbage.  Lookup semantics are
    therefore the max common prefix over all inserted sequences — the
    brute-force oracle the tests check against.

    ``full_pages_only`` (int8 pools) stops insertion at the last FULL
    page: a partially-filled int8 page requantizes on every decode
    write by its owner, which would silently re-round rows a sharing
    reader already attends — full pages are immutable, so only they
    may be shared.
    """

    def __init__(self, allocator: PageAllocator, page_size: int, *,
                 full_pages_only: bool = False):
        self.allocator = allocator
        self.page_size = page_size
        self.full_pages_only = full_pages_only
        self.root = _RadixNode()
        self.hit_tokens = 0   # cumulative prefill tokens served from cache
        self.lookups = 0
        self.hits = 0
        self.evicted_pages = 0
        self.inserted_pages = 0  # pages the tree newly adopted
        self._tick = 0        # monotonic LRU clock

    # -- introspection ------------------------------------------------------

    def _walk(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                yield node, c
                stack.append(c)

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._walk())

    @property
    def num_pages(self) -> int:
        """Pages the tree currently holds a reference on."""
        return self.num_nodes

    def pages(self) -> list[int]:
        """Every page the tree holds a reference on (one per node) —
        the tree's ownership claim for :meth:`PageAllocator.audit`."""
        return [c.page for _, c in self._walk()]

    # -- lookup -------------------------------------------------------------

    def lookup(self, tokens):
        """Longest cached prefix of ``tokens``.

        Returns ``(match_len, pages)`` where ``pages`` maps positions
        ``[0, match_len)`` page-by-page.  Every returned page is PINNED
        (allocator refcount++) — the caller owns one reference per page
        and must ``release`` them (retirement / trimming).
        """
        self._tick += 1
        self.lookups += 1
        pg = self.page_size
        toks = [int(t) for t in tokens]
        node, i, pages, match = self.root, 0, [], 0
        while i < len(toks):
            rem = tuple(toks[i:i + pg])
            best = node.children.get(rem)  # exact fast path
            best_o = len(rem) if best is not None else 0
            if best is None:
                for c in node.children.values():
                    o = _common_prefix(c.chunk, rem)
                    if o > best_o:
                        best, best_o = c, o
            if best is None or best_o == 0:
                break
            best.last_used = self._tick
            pages.append(best.page)
            match += best_o
            if best_o < pg or best_o < len(best.chunk):
                break  # partial overlap / partial chunk: path ends here
            node, i = best, i + pg
        if self.full_pages_only and match % pg:
            # int8: a partially-matched page would have to be COW-forked
            # and then REQUANTIZED by its new owner's writes — round the
            # hit down so only whole immutable pages are ever served
            match -= match % pg
            pages = pages[:match // pg]
        self.allocator.ref(pages)
        if match:
            self.hits += 1
            self.hit_tokens += match
        return match, pages

    # -- insert -------------------------------------------------------------

    def insert(self, tokens, pages) -> int:
        """Record ``tokens`` (whose KV rows live in ``pages``, in page
        order) in the tree.  Adopted pages gain a tree-owned reference;
        the caller's references are untouched (a slot still releases
        its own pages at retirement — preemption relies on exactly
        this: insert then release keeps the tree's reference as the
        page's ONLY holder, so the KV survives, resident but
        evictable, until re-admission looks it up).  Duplicate chunks
        dedup onto the existing node; a partial leaf overtaken by a
        longer chunk upgrades in place (partial chunks are always
        leaves, so the swap can't orphan descendants).  Returns the
        number of pages the tree NEWLY adopted (0 when the sequence
        was already fully covered) — the engine's preemption
        accounting reports it as work preserved across the evict."""
        self._tick += 1
        pg = self.page_size
        toks = [int(t) for t in tokens]
        chunks = [tuple(toks[i:i + pg]) for i in range(0, len(toks), pg)]
        assert len(chunks) <= len(pages), (len(chunks), len(pages))
        node, adopted = self.root, 0
        for ci, chunk in enumerate(chunks):
            page = pages[ci]
            if len(chunk) < pg and self.full_pages_only:
                break  # int8: the partial tail requantizes — don't share
            child = node.children.get(chunk)
            if child is None:
                for key, c in list(node.children.items()):
                    o = _common_prefix(c.chunk, chunk)
                    if o == len(chunk):
                        # existing chunk extends ours: already covered
                        c.last_used = self._tick
                        return adopted
                    if o == len(c.chunk) and o < len(chunk):
                        # partial leaf upgraded by this longer chunk
                        if c.page != page:
                            self.allocator.ref([page])
                            self.allocator.release([c.page])
                            c.page = page
                            adopted += 1
                            self.inserted_pages += 1
                        del node.children[key]
                        c.chunk = chunk
                        node.children[chunk] = c
                        child = c
                        break
                if child is None:
                    child = _RadixNode(chunk, page)
                    self.allocator.ref([page])
                    adopted += 1
                    self.inserted_pages += 1
                    node.children[chunk] = child
            child.last_used = self._tick
            if len(chunk) < pg:
                break  # partial tail: nothing descends past it
            node = child
        return adopted

    # -- eviction -----------------------------------------------------------

    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` by dropping LRU LEAVES whose pages
        have no reader but the tree (allocator refcount == 1) — a
        pinned page is never evicted, an interior node never orphans
        its descendants.  Freeing a leaf can expose its parent, so the
        scan repeats until the quota is met or nothing is evictable.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n_pages:
            victims = [(c.last_used, parent, c) for parent, c in self._walk()
                       if not c.children
                       and self.allocator.refcount(c.page) == 1]
            if not victims:
                break
            victims.sort(key=lambda v: v[0])
            for _, parent, leaf in victims:
                if freed >= n_pages:
                    break
                del parent.children[leaf.chunk]
                self.allocator.release([leaf.page])
                freed += 1
                self.evicted_pages += 1
        return freed

    def drop_pages(self, pages) -> int:
        """Purge every node holding one of ``pages`` AND its whole
        subtree, releasing the tree's reference on each removed node's
        page.  Descendants must go too: their prefixes run *through*
        the dropped page's rows, so serving them would attend poisoned
        (or vanished) KV.  The serving supervisor calls this before
        quarantining pages a fault poisoned.  Returns nodes removed."""
        bad = {int(p) for p in pages}
        removed: list[_RadixNode] = []

        def _prune(node):
            for key, child in list(node.children.items()):
                if child.page in bad:
                    del node.children[key]
                    stack = [child]
                    while stack:
                        c = stack.pop()
                        removed.append(c)
                        stack.extend(c.children.values())
                else:
                    _prune(child)

        _prune(self.root)
        self.allocator.release([c.page for c in removed])
        self.evicted_pages += len(removed)
        return len(removed)

    def clear(self) -> int:
        """Drop every node (release all tree-held references)."""
        nodes = [c for _, c in self._walk()]
        self.allocator.release([c.page for c in nodes])
        self.root = _RadixNode()
        self.evicted_pages += len(nodes)
        return len(nodes)



# ---------------------------------------------------------------------------
# pool construction
# ---------------------------------------------------------------------------


def supports_paged(cfg) -> bool:
    """Paged serving covers the attention-cache families (GQA incl. SWA
    via in-kernel window masking, and MLA).  Recurrent state (SSM /
    hybrid) has O(1) per-sequence caches — nothing to page — and
    enc-dec cross-KV is per-request anyway."""
    return not (cfg.ssm_state or cfg.attn_every or cfg.is_enc_dec
                or cfg.frontend)


def _layer_pool(cfg, num_pages: int, page_size: int, dtype, device):
    # one page more than served: the sink (see the module docstring)
    if cfg.uses_mla:
        # one shared [c_kv | k_rope] pool, one scale row per page for int8
        shape = (1, num_pages + 1, page_size, cfg.kv_lora_rank + cfg.rope_head_dim)
        pool = {"kv_pages": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            pool["kv_scales"] = torch.zeros(shape[:2], dtype=torch.float32, device=device)
        return pool
    shape = (cfg.kv_heads, num_pages + 1, page_size, cfg.head_dim)
    pool = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:  # per-page-per-head scales, the sink's included
        for key in ("k_scales", "v_scales"):
            pool[key] = torch.zeros(shape[:2], dtype=torch.float32, device=device)
    return pool


def pool_num_pages(leaf: torch.Tensor) -> int:
    """Pages a pool leaf serves: its page axis less the sink."""
    return leaf.shape[1] - 1


def init_paged_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                      page_size: int = 16, num_pages: int | None = None,
                      kv_dtype: str | None = None, device="cuda"):
    """Paged serving caches for ``batch`` decode slots.

    Returns {"blocks": [per-layer pool dict], "block_tables":
    (B, pages_for(max_len)) int32 (-1 = unmapped), "lens": (B,) int32},
    all on ``device``.  ``num_pages`` defaults to full backing (every
    slot can reach ``max_len``); each pool holds one sink page beyond
    it.  ``kv_dtype`` ("f32"/"bf16"/"int8") overrides ``dtype`` for the
    pools; int8 pools carry per-page-per-head f32 scales next to the pages.
    """
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache: unsupported family {cfg.family!r} "
            "(recurrent/enc-dec/frontend caches are not paged)")
    if kv_dtype is not None:
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {tuple(KV_DTYPES)}, "
                             f"got {kv_dtype!r}")
        dtype = KV_DTYPES[kv_dtype]
    max_pp = pages_for(max_len, page_size)
    if num_pages is None:
        num_pages = batch * max_pp
    return {
        "blocks": [_layer_pool(cfg, num_pages, page_size, dtype, device)
                   for _ in range(cfg.num_layers)],
        "block_tables": torch.full((batch, max_pp), -1, dtype=torch.int32,
                                   device=device),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def page_bytes(cfg, page_size: int, kv_dtype: str = "f32") -> int:
    """Device bytes ONE logical page costs across all layers — the unit
    the engine's byte-budgeted pool sizing divides by (the sink page is
    not counted).  int8 pools add 4 B of scale per head and page."""
    dtype = KV_DTYPES[kv_dtype]
    item = torch.empty((), dtype=dtype).element_size()
    scales = 4 if dtype == torch.int8 else 0
    if cfg.uses_mla:
        width = cfg.kv_lora_rank + cfg.rope_head_dim
        per_layer = page_size * width * item + scales
    else:
        per_layer = cfg.kv_heads * (2 * page_size * cfg.head_dim * item
                                    + 2 * scales)
    return cfg.num_layers * per_layer


def pool_pages_for_bytes(cfg, pool_bytes: int, page_size: int,
                         kv_dtype: str = "f32") -> int:
    """Pages a byte budget buys.  A budget below one page is an error,
    not a silent over-allocation."""
    pages = pool_bytes // page_bytes(cfg, page_size, kv_dtype)
    if pages < 1:
        raise ValueError(
            f"pool_bytes={pool_bytes} buys zero {kv_dtype} pages "
            f"(page_bytes={page_bytes(cfg, page_size, kv_dtype)})")
    return pages


def page_size_of(caches) -> int:
    pool = caches["blocks"][0]
    return next(iter(pool.values())).shape[2]


def find_nonfinite_pages(paged_blocks) -> list[int]:
    """Served pool pages holding a non-finite value in ANY layer (the
    sink, which collects dropped writes, is not probed).  Every leaf
    keeps the page on axis 1.  int8 page rows cannot hold a NaN, but their
    f32 scales can, so quantized pools are probed through their scale
    leaves.  Reads the answer back to the host."""
    first = next(iter(paged_blocks[0].values()))
    n = pool_num_pages(first)
    bad = torch.zeros((n,), dtype=torch.bool, device=first.device)
    for pool in paged_blocks:
        for leaf in pool.values():
            if not leaf.is_floating_point():
                continue  # integer codes are always finite
            ok = torch.isfinite(leaf[:, :n]).transpose(0, 1).reshape(n, -1).all(dim=1)
            bad |= ~ok
    return [int(p) for p in torch.nonzero(bad).flatten().tolist()]


# ---------------------------------------------------------------------------
# prefix sharing: COW fork + prefix gather
# ---------------------------------------------------------------------------


def fork_page(paged_blocks, src: int, dst: int):
    """Copy-on-write fork: duplicate pool page ``src`` into ``dst``
    across every layer and every pool leaf (page rows and int8 scales),
    in place.  The engine calls this when a new reader would otherwise
    WRITE into a shared, partially-filled tail page: the reader gets a
    private copy to fill, the original stays byte-identical for its other
    readers.  Returns ``paged_blocks``."""
    for pool in paged_blocks:
        for leaf in pool.values():
            leaf[:, dst] = leaf[:, src]
    return paged_blocks


def _dense_rows(dense: dict) -> dict:
    """A batch-1 dense layer cache as ``{pool prefix: (T, H, W) rows}``:
    GQA's ``{"k": ..., "v": ...}`` rows per KV head, MLA's one ``"kv"``
    latent buffer as a single head (the layout of its pool)."""
    if "kv" in dense:
        return {"kv": dense["kv"][0][:, None, :]}
    return {"k": dense["k"][0], "v": dense["v"][0]}


def seed_prefix_dense(dense_caches, paged_blocks, block_row, n_prefix: int):
    """Gather a cached prefix's page rows into a freshly initialised
    batch-1 dense cache so chunked prefill can RESUME at ``n_prefix``.

    ``dense_caches`` is ``{"blocks": [per-layer {"k", "v", "len"}]}`` (MLA:
    ``{"kv", "len"}``; rows at and past ``n_prefix`` stay zero);
    ``block_row`` (pages_per_seq,) is the request's page ids on the pools'
    device; every layer's ``len`` becomes ``n_prefix``; int8 pages are
    dequantized by their page scales.  Written in place; returns
    ``dense_caches``."""
    first = next(iter(paged_blocks[0].values()))
    pg = first.shape[2]
    max_pp = block_row.shape[0]
    pos = torch.arange(n_prefix, device=first.device)
    page = block_row.long()[torch.clamp(pos // pg, max=max_pp - 1)]
    valid = page >= 0
    page = torch.where(valid, page, 0)  # gather page 0, mask its rows after
    slot = pos % pg
    for pool, dense in zip(paged_blocks, dense_caches["blocks"]):
        for key, dst in _dense_rows(dense).items():
            rows = pool[f"{key}_pages"][:, page, slot].float()    # (H, n, W)
            if f"{key}_scales" in pool:
                rows = rows * pool[f"{key}_scales"][:, page][..., None]
            rows = rows * valid[None, :, None]
            dst[:n_prefix] = rows.transpose(0, 1).to(dst.dtype)
        dense["len"] = n_prefix
    return dense_caches


# ---------------------------------------------------------------------------
# prefill copy-in
# ---------------------------------------------------------------------------


def write_prompt_pages(paged_blocks, dense_blocks, block_row, n_tokens: int,
                       row0_pos: int = 0, row_lo: int = 0):
    """Scatter one request's dense-prefill cache rows into its pages.

    paged_blocks: the per-layer pool list from :func:`init_paged_caches`;
    dense_blocks: the per-layer ``[{"k", "v", ...}]`` of a **batch-1**
    dense cache after prefill, each (1, T, Hkv, D) (MLA: ``[{"kv", ...}]``,
    (1, T, r + dr)); block_row: (pages_per_seq,) int32 page ids on the
    pools' device; n_tokens: live prompt length.  ``row0_pos`` is the
    position of dense row 0 — 0 for plain buffers, ``n_tokens - T`` for an
    SWA rolling buffer (the ordered snapshot).  Rows mapping outside
    [0, n_tokens) — pad rows, unwritten rolling rows, -1 table tails — go
    to the sink page.

    ``row_lo`` drops rows BELOW a position too: a prefix-cache hit means
    positions [0, row_lo) live in SHARED pages that must not be
    rewritten, so only the freshly prefilled suffix scatters.

    int8 pools quantize per (page, head) over the page's VALID rows.  The
    scales of every mapped page from the first non-shared one on are
    written: pages reserved beyond the prompt get the eps scale (their
    recycled codes dequantize to ~0 until a decode write replaces them);
    the scales of pages wholly below ``row_lo`` stay untouched (the engine
    page-aligns ``row_lo`` on int8 pools).  Written in place, one scatter
    per pool leaf; returns ``paged_blocks``."""
    first = next(iter(paged_blocks[0].values()))
    sink, pg = pool_num_pages(first), first.shape[2]
    max_pp = block_row.shape[0]
    t = next(iter(_dense_rows(dense_blocks[0]).values())).shape[0]
    pos = torch.arange(t, device=first.device) + row0_pos
    local = torch.clamp(pos // pg, 0, max_pp - 1)
    page = block_row.long()[local]
    valid = (pos >= 0) & (pos >= row_lo) & (pos < n_tokens) & (page >= 0)
    page = torch.where(valid, page, sink)
    slot = pos % pg
    if first.dtype == torch.int8:
        owned = torch.arange(max_pp, device=first.device) >= row_lo // pg
        spage = torch.where((block_row >= 0) & owned, block_row.long(), sink)

    def page_quant(rows):
        """rows (T, Hkv, W) -> (int8 rows, per-page scales (max_pp, Hkv))."""
        amax = torch.where(valid[:, None], rows.float().abs().amax(-1), 0.0)
        seg = torch.zeros((max_pp, amax.shape[1]), dtype=torch.float32,
                          device=amax.device)
        seg.scatter_reduce_(0, local[:, None].expand_as(amax), amax, "amax")
        scales = scale_from_amax(seg)
        return quant_with_scale(rows, scales[local][..., None]), scales

    for pool, dense in zip(paged_blocks, dense_blocks):
        for key, rows in _dense_rows(dense).items():               # (T, H, W)
            leaf = pool[f"{key}_pages"]
            if leaf.dtype == torch.int8:
                rows, scales = page_quant(rows)
                pool[f"{key}_scales"][:, spage] = scales.T
            leaf[:, page, slot] = rows.transpose(0, 1).to(leaf.dtype)
    return paged_blocks


def quant_page_update(pages, scales, page, slot, row):
    """Insert one decode token's row per sequence into its int8 page,
    requantizing the page under the (possibly grown) scale, in place.

    pages: (Hkv, num_pages + 1, pg, W) int8 pool; scales: (Hkv,
    num_pages + 1) f32; page/slot: (B,) write coordinates from
    ``_paged_token_coords`` (the sink page for inactive slots and dropped
    positions); row: (Hkv, B, W).  Returns (pages, scales).

    The page is gathered, dequantized, the new row inserted, and the
    whole page requantized at its new max: a row inside the old range
    leaves the old codes exact; a range-growing row re-rounds the page
    once.  Rows past the write slot are recycled-page garbage, masked out
    of the max and zeroed.  Dropped writes land on the sink, several at
    once if need be; the reference gathers a clipped live page for them
    and drops the write, so no live page is read or written in their
    place here either."""
    pg = pages.shape[2]
    b = page.shape[0]
    cur = pages[:, page].float() * scales[:, page][..., None, None]  # (Hkv, B, pg, W)
    cur[:, torch.arange(b, device=page.device), slot] = row.float()
    live = torch.arange(pg, device=page.device)[None, :] <= slot[:, None]  # (B, pg)
    cur = cur * live[None, :, :, None]
    new_scale = scale_for(cur, axes=(2, 3))                      # (Hkv, B)
    pages[:, page] = quant_with_scale(cur, new_scale[..., None, None])
    scales[:, page] = new_scale
    return pages, scales
