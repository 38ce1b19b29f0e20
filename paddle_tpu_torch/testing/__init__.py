"""Deterministic test harnesses (port of ``paddle_tpu/testing``).

Currently home to :mod:`.faults`, the fault-injection
plan that crash/recovery tests (checkpoint manager, elastic launch) use
to kill, hang, or corrupt a process at an exact instrumented point.
"""

from . import faults  # noqa: F401

__all__ = ["faults"]
