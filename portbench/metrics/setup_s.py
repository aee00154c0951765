"""Process start to the first timed request."""
from portbench.harness.readers import setup_s as read  # noqa: F401
