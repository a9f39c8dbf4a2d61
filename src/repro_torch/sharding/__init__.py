"""Sharding rules: which mesh axis each parameter and cache dimension
splits over (`rules.py`, a port of `repro/sharding/rules.py`)."""
