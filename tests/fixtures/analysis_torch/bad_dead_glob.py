"""Seeded violation for the policy pass: a calibration scale key that
matches no site of any arch (POL_DEAD_GLOB).
"""


def analysis_artifacts():
    return [("bad_artifact", {"layers/*/conv_stem/w": 0.5})]
