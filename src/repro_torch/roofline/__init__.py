"""Roofline model of the port on the H100: data-sheet constants (`hw`),
the work a step needs counted from its tensors (`step_stats`), the
`Roofline` terms of a step and its collectives (`analysis`), and the
dry run's records re-derived (`reanalyze`) and tabled (`report`)."""
from . import hw
from .analysis import Roofline, analyze, collective_bytes, count_collectives

__all__ = ["hw", "Roofline", "analyze", "collective_bytes",
           "count_collectives"]
