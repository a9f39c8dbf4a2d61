"""Seeded violation: a broad exception handler that swallows failures.

The hygiene pass must flag HYG_BROAD_EXCEPT on this file.
"""


def swallow(fn):
    try:
        return fn()
    except Exception:
        return None
