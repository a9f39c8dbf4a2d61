"""Roofline model of the port on the H100: data-sheet constants (`hw`),
the work a step needs counted from its tensors (`step_stats`), and the
`Roofline` terms of a step (`analysis`)."""
from . import hw
from .analysis import Roofline, analyze

__all__ = ["hw", "Roofline", "analyze"]
