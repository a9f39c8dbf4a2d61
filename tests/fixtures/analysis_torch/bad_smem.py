"""Seeded violation: a decode-attention plan that reserves more shared
memory a block than the budget (232,448 bytes on the H100): the kernel
pass must flag KC_SMEM_BUDGET.
"""


def analysis_cases():
    import dataclasses

    from repro_torch.kernels.decode_attn import decode_plan

    def launches():
        plan = decode_plan(4, 256, 16, 16, 64)
        return [dataclasses.replace(plan, smem=240 * 1024)]

    return [{"name": "bad_smem", "launches": launches}]
