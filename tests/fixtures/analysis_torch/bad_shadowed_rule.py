"""Seeded violation for the policy pass: a rule that an earlier rule
always wins over (POL_SHADOWED).
"""


def analysis_programs():
    from repro_torch.core.policy import (OLIVE_W4A4, OLIVE_W8A8,
                                         PolicyProgram, Rule)
    prog = PolicyProgram(
        rules=(Rule("*attn*", OLIVE_W8A8),
               Rule("*attn/wq*", OLIVE_W4A4)),          # behind *attn*
        default=OLIVE_W4A4, name="bad_shadowed_rule")
    return [("bad_shadowed_rule", prog)]
