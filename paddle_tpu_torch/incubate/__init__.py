"""Incubating APIs (port of the reference package's ``incubate``): the
fused functional ops (:mod:`.nn`) and mixture-of-experts (:mod:`.moe`)."""

from . import nn  # noqa: F401
from . import moe  # noqa: F401

__all__ = ["nn", "moe"]
