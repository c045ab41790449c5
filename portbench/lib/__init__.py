"""The harness's shared code: the window, the trace, the arithmetic."""
