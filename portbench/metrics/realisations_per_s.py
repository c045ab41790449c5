"""Realisations completed in the window over the window's length (the
window runs from the first call's start to the last call's end)."""
from portbench.lib.readers import realisations_per_s as read  # noqa: F401
