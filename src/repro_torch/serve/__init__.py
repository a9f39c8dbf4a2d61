"""Serving: the slab continuous-batching engine (`engine`)."""
