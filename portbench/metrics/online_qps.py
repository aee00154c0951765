"""Queries answered per second of the window (the online cell)."""
from portbench.harness.readers import queries_per_s as read  # noqa: F401
