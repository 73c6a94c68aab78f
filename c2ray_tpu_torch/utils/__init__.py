from .clocks import Clocks
from .report_memory import memory_report

__all__ = ["Clocks", "memory_report"]

from .small import mrgrnk, parse_length
