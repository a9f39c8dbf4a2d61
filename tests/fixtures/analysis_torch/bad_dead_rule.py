"""Seeded violation for the policy pass: a rule glob that no arch's
param tree can match (POL_DEAD_RULE).
"""


def analysis_programs():
    from repro_torch.core.policy import (OLIVE_W4A4, OLIVE_W8A8,
                                         PolicyProgram, Rule)
    prog = PolicyProgram(
        rules=(Rule("*conv_stem*", OLIVE_W8A8),),       # no such site
        default=OLIVE_W4A4, name="bad_dead_rule")
    return [("bad_dead_rule", prog)]
