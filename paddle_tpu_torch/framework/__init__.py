"""Framework-level helpers (port of the reference package's
``framework``): ``save`` / ``load``."""

from .io import load, save

__all__ = ["save", "load"]
