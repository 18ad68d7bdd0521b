"""Checkpoints of the port: atomic save and restore, an async writer, and
auto-resume, in the reference's file format."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
