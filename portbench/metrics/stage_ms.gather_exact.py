"""Milliseconds per realisation of the program's 'gather_exact' stage,
the COLA force components gathered by the exact trilinear interpolation
beyond the widest lattice band (one mark a component;
``timing.StageClock``: CUDA events on the stream); None where no gather
took that tier."""
from portbench.lib.readers import stage_ms


def read(run):
    return stage_ms(run, "gather_exact")
