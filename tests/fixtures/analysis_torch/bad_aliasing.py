"""Seeded violation: a pool-writing call that allocates a new pool
instead of writing the one it was given.

Pages the call does not write would come back as whatever the new pool
holds instead of intact: the kernel pass must flag KC_ALIAS_MISSING.
"""


def analysis_cases():
    import torch

    def build(device):
        pool = torch.zeros((4, 8, 2, 8), dtype=torch.uint8, device=device)

        def fn(cache):
            fresh = torch.zeros_like(cache["k_data"])
            fresh[0] = cache["k_data"][0] + 1
            return {"k_data": fresh}
        return fn, ({"k_data": pool},)

    return [{"name": "bad_aliasing", "launches": lambda: [], "build": build,
             "pool_leaves": ("k_data",)}]
