"""Seeded violation: a row-parallel split predicate that forgets int8
codes hold one value a row.

It passes any K that divides over the ranks, so an int8 weight of 70
rows over 2 ranks (35 rows, 35 values a shard) would cut an
outlier-victim pair at the shard boundary: the kernel pass must flag
KC_SHARD_SPLIT.
"""


def row_shard_pair_aligned(k_rows: int, tp: int, packed: bool) -> bool:
    return k_rows % tp == 0
