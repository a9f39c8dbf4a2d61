"""Seeded violation: an int8-code weight tiled with an odd K block.

Each int8 code row is one value, so a 3-row K tile holds one and a half
outlier-victim pairs: the kernel pass must flag KC_PAIR_SPLIT.
"""


def analysis_cases():
    from repro_torch.analysis.kernels import Launch

    def launches():
        return [Launch("K1", k_tiles=(("int8 K tile of 3 code rows", 3),))]

    return [{"name": "bad_pair_split", "launches": launches}]
