"""Percent of the kept profiled window with nothing on the device."""
from portbench.harness.readers import idle_share as read  # noqa: F401
