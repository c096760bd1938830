"""Dead-end pattern management (paper §4.4) — re-export shim.

The table implementations are now owned by the first-class failure-
pattern subsystem in :mod:`repro_torch.patterns` (``patterns.tables`` for the
host reference tables, ``patterns.store`` for the bounded hashed device
store). This module keeps the historical ``repro_torch.core.deadend`` import
path alive for the sequential oracle and the tests.
"""
from __future__ import annotations

from ..patterns.tables import (DeadEndStats, NumericDeadEndTable,
                               SetDeadEndTable)

__all__ = ["DeadEndStats", "NumericDeadEndTable", "SetDeadEndTable"]
