"""Milliseconds per realisation of the program's 'pca' stage
(``timing.StageClock``: CUDA events on the stream, so gaps where the
card waits on the host count), summed over its marks in a call."""
from portbench.lib.readers import stage_ms


def read(run):
    return stage_ms(run, "pca")
