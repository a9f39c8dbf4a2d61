"""The port's page allocator against the reference's: the same alloc /
free / compact sequence on `repro.serve.paging.PagePool` and
`repro_torch.serve.paging.PagePool` gives the same page ids, compaction
maps and `stats()`, and both refuse the same misuse. The sizing helpers
agree too. Exact equality throughout (pure integer bookkeeping)."""
from __future__ import annotations

import numpy as np
import pytest

from repro.serve import paging as jpg
from repro_torch.serve import paging as tpg

from _torch_dist import one_torch_thread  # noqa: F401


def _both(n_pages=12, page_size=16):
    return jpg.PagePool(n_pages, page_size), tpg.PagePool(n_pages, page_size)


def _same(jp, tp):
    assert tp.stats() == jp.stats()
    assert tp.owners() == jp.owners()
    for owner in jp.owners():
        assert tp.pages_of(owner) == jp.pages_of(owner)


def test_alloc_free_compact_sequence_matches():
    jp, tp = _both()
    ops = [("alloc", 3, 1), ("alloc", 2, 2), ("alloc", 4, 3),
           ("free", 2, None), ("alloc", 1, 4), ("free", 1, [None]),
           ("alloc", 5, 5), ("compact",), ("alloc", 2, 6), ("free", 3, None),
           ("alloc", 20, 7), ("compact",)]
    for op in ops:
        if op[0] == "alloc":
            assert tp.alloc(op[1], op[2]) == jp.alloc(op[1], op[2])
        elif op[0] == "free":
            owner, pages = op[1], op[2]
            if pages == [None]:          # release part of an owner's pages
                pages = jp.pages_of(owner)[:1]
            assert tp.free(owner, pages) == jp.free(owner, pages)
        else:
            (jsrc, jmap), (tsrc, tmap) = jp.compact(), tp.compact()
            np.testing.assert_array_equal(tsrc, jsrc)
            assert tsrc.dtype == jsrc.dtype
            assert tmap == jmap
        _same(jp, tp)
    assert tp.high_watermark() == jp.high_watermark()
    assert tp.fragmentation() == jp.fragmentation()


def test_all_or_nothing_and_double_free_match():
    for pool in _both(n_pages=4):
        assert pool.alloc(5, 1) is None          # never a partial grant
        assert pool.alloc_failures == 1 and pool.used_pages == 0
        got = pool.alloc(4, 1)
        assert got == [0, 1, 2, 3]
        assert pool.alloc(1, 2) is None and not pool.can_alloc(1)
        pool.free(1, [2])
        with pytest.raises(KeyError, match="double free"):
            pool.free(1, [2])
        with pytest.raises(KeyError, match="holds no pages"):
            pool.free(9, [0])
        assert pool.free(9) == 0
        with pytest.raises(ValueError):
            pool.alloc(0, 3)
    with pytest.raises(ValueError):
        tpg.PagePool(0, 16)
    for cfg in (dict(page_size=3), dict(page_size=0), dict(n_pages=-1)):
        with pytest.raises(ValueError):
            jpg.PagePoolCfg(**cfg)
        with pytest.raises(ValueError):
            tpg.PagePoolCfg(**cfg)


@pytest.mark.parametrize("n_kv,head_dim,kv_bits", [(16, 64, 4), (2, 32, 0),
                                                   (4, 128, 4)])
def test_sizing_helpers_match(n_kv, head_dim, kv_bits):
    per_tok = tpg.kv_bytes_per_token_per_site(n_kv, head_dim, kv_bits)
    assert per_tok == jpg.kv_bytes_per_token_per_site(n_kv, head_dim,
                                                      kv_bits)
    for budget in (0, 10 ** 6, 3 * 10 ** 9):
        assert tpg.pool_pages_for_budget(budget, 16, per_tok) == \
            jpg.pool_pages_for_budget(budget, 16, per_tok)
    for tokens in (1, 16, 17, 300):
        assert tpg.pages_for(tokens, 16) == jpg.pages_for(tokens, 16)
        assert tpg.max_concurrent_requests(64, 16, tokens) == \
            jpg.max_concurrent_requests(64, 16, tokens)
