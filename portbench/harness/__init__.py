"""The harness: inputs, the system under test, the window, the trace and the check."""
