"""Seeded violation: a decline function returning an unregistered code.

`repro_torch.analysis`'s vocabulary pass must flag VOCAB_UNREGISTERED_CODE
on this file; see tests/test_torch_analysis.py.
"""


def decode_attn_decline_reason(q, cache):
    if q is None:
        return "decode_q_rank_bad"   # not in backends.base.DECLINE_CODES
    return None
