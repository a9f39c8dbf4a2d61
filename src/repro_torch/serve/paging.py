"""Paged KV-cache page allocator: a global pool of fixed-size pages.
Port of `repro/serve/paging.py` (pure numpy, copied, not imported).

OliVe's OVP packing keeps every quantized token at a FIXED byte cost per
(token, head) — 1 byte per value pair plus one f32 scale — so a KV cache
pages in fixed-size blocks with no sparsity side-tables. This module is
the host-side allocator for that pool:

  pool    — each cache site holds its K/V data as `(n_pages, page_size,
            Hkv, …)` tensors instead of a `(batch_slots, max_len, …)`
            slab; page `p` is a physically contiguous tile of
            `page_size` token rows.
  tables  — a per-slot block table `(batch_slots, pages_per_slot)` int32
            maps logical page `j` of a request (token rows
            [j*page_size, (j+1)*page_size)) to its physical page id; the
            paged decode kernel reads it per token, the dense path
            materializes pages into a slab (`gather_paged_cache`).
  accounting — `PagePool` below: free-list alloc/free keyed by request
            uid, admission-time `can_alloc` so the scheduler reserves a
            request's worst-case pages BEFORE admitting it (no
            mid-request OOM), occupancy/fragmentation stats, and
            `compact()` (defrag) which renumbers live pages onto the low
            end of the pool so an elastic deployment can shrink it.

A slab reserves `batch_slots * max_len` token rows; the pool reserves
only pages actually backing live tokens, so with mean active context `L`
the same memory serves ~`max_len / L` times the concurrent requests (see
`max_concurrent_requests`). Pages are position-independent: physical
fragmentation never costs bytes or correctness, so `compact()` exists
for pool elasticity, not hygiene.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PagePoolCfg:
    """Engine-facing paged-KV configuration (EngineCfg.page_pool).

    page_size: token rows per page; also the fused decode kernel's kv-tile
        size. Must be even (OVP nibbles pack 2 values/byte along head_dim;
        scales are per token so any even size aligns).
    n_pages: pool size. 0 = slab-equivalent capacity
        (batch_slots * ceil(max_len / page_size)) — same worst case HBM,
        but under-capacity pools are the point: admission blocks on
        `can_alloc`, so a pool sized for the REAL mean context serves
        strictly more concurrent requests from the same bytes.
    """
    page_size: int = 16
    n_pages: int = 0

    def __post_init__(self):
        if self.page_size < 2 or self.page_size % 2:
            raise ValueError(
                f"page_size must be an even int >= 2 (OVP packs value "
                f"pairs 2-per-byte along head_dim); got {self.page_size}")
        if self.n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {self.n_pages}")


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to back `tokens` rows (admission-time reservation)."""
    return max(1, math.ceil(tokens / page_size))


def kv_bytes_per_token_per_site(n_kv: int, head_dim: int,
                                kv_bits: int, fp_bytes: int = 4) -> int:
    """Bytes one token row costs in one cache site's pool.

    Packed (kv_bits=4): D/2 nibble bytes + one f32 scale, K and V each.
    fp: head_dim * itemsize, K and V each.
    """
    if kv_bits == 4:
        return 2 * (head_dim // 2 + 4) * n_kv
    return 2 * head_dim * fp_bytes * n_kv


def pool_pages_for_budget(hbm_bytes: int, page_size: int,
                          bytes_per_token: int) -> int:
    """Largest pool that fits `hbm_bytes` (bytes_per_token summed over
    every cache site)."""
    per_page = page_size * bytes_per_token
    return max(0, hbm_bytes // per_page)


def max_concurrent_requests(n_pages: int, page_size: int,
                            tokens_per_request: int) -> int:
    """How many requests of `tokens_per_request` reserved rows the pool
    admits at once — the capacity number the slab fixes at batch_slots."""
    return n_pages // pages_for(tokens_per_request, page_size)


class PagePool:
    """Free-list allocator over `n_pages` physical pages.

    Page ids are indices into every cache site's pool arrays — sites share
    one allocator because a request needs the same token rows in every
    layer, so one id list backs all of them. All accounting is host-side
    numpy/python (admission happens between engine steps); nothing here
    touches a device.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free stack, low page ids on top: fresh allocations pack the
        # low end of the pool first, which keeps compact() cheap
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0
        self.peak_used = 0

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages / self.n_pages

    def can_alloc(self, n: int) -> bool:
        """Admission gate: reserve-before-admit means a request either
        gets its whole worst-case page budget or stays queued."""
        return n <= len(self._free)

    def pages_of(self, owner: int) -> List[int]:
        return list(self._owned.get(owner, ()))

    def owners(self) -> List[int]:
        return sorted(self._owned)

    def high_watermark(self) -> int:
        """Highest live physical page id + 1 — the pool prefix an elastic
        deployment must keep resident. 0 when no page is held. After
        `compact()` this equals `used_pages` (no holes)."""
        live = [p for pages in self._owned.values() for p in pages]
        return max(live) + 1 if live else 0

    def fragmentation(self) -> float:
        """Free fraction of the live span [0, high_watermark): the holes
        `compact()` would squeeze out. 0.0 for an empty or perfectly
        packed pool; never affects correctness (pages are
        position-independent), only pool elasticity."""
        hw = self.high_watermark()
        return 0.0 if hw == 0 else 1.0 - self.used_pages / hw

    def stats(self) -> Dict[str, float]:
        """Pool ledger. `used_pages`/`free_pages`/`occupancy`/
        `high_watermark`/`fragmentation`/`owners` are instantaneous
        gauges; `allocs`/`frees`/`alloc_failures`/`peak_used` are
        lifetime counters (see `ServingEngine.stats()` for the shared
        semantics)."""
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "used_pages": self.used_pages,
                "free_pages": self.free_pages,
                "occupancy": self.occupancy(),
                "high_watermark": self.high_watermark(),
                "fragmentation": self.fragmentation(),
                "allocs": self.allocs, "frees": self.frees,
                "alloc_failures": self.alloc_failures,
                "peak_used": self.peak_used,
                "owners": len(self._owned)}

    # ------------------------------------------------------- alloc / free
    def alloc(self, n: int, owner: int) -> Optional[List[int]]:
        """n pages for request `owner`, or None (and a counted failure)
        when the pool cannot cover them — never a partial grant."""
        if n < 1:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(got)
        self.allocs += n
        self.peak_used = max(self.peak_used, self.used_pages)
        return got

    def free(self, owner: int, pages: Optional[List[int]] = None) -> int:
        """Release `pages` of `owner` (None = all of them). Returns the
        count released. Unknown pages raise — a double free would hand one
        physical page to two requests."""
        held = self._owned.get(owner)
        if held is None:
            if pages:
                raise KeyError(f"owner {owner} holds no pages")
            return 0
        if pages is None:
            pages = list(held)
        for p in pages:
            try:
                held.remove(p)
            except ValueError:
                raise KeyError(
                    f"page {p} is not held by owner {owner} "
                    f"(double free?)") from None
            self._free.append(p)
        if not held:
            del self._owned[owner]
        self.frees += len(pages)
        return len(pages)

    # ------------------------------------------------------------- defrag
    def compact(self) -> Tuple[np.ndarray, Dict[int, int]]:
        """Renumber live pages onto [0, used_pages) — defragmentation.

        Returns (src, remap): `src` (n_pages,) int32 gathers the POOL
        arrays (`new_pool = old_pool[src]` — new page i's data comes from
        old page src[i]), `remap` rewrites page ids everywhere they are
        held (block tables, `_owned` is rewritten in place). Pages are
        position-independent so this never changes served results (the
        defrag property test asserts bit-identical attention); its point
        is pool elasticity — after compaction the tail [used_pages,
        n_pages) is entirely free and can be released.
        """
        live = sorted(p for pages in self._owned.values() for p in pages)
        remap = {old: new for new, old in enumerate(live)}
        src = np.arange(self.n_pages, dtype=np.int32)
        src[:len(live)] = live
        spare = [p for p in range(self.n_pages) if p not in remap]
        src[len(live):] = spare
        for owner, pages in self._owned.items():
            self._owned[owner] = [remap[p] for p in pages]
        self._free = list(range(self.n_pages - 1, len(live) - 1, -1))
        return src, remap
