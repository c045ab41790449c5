"""Milliseconds per realisation of the program's 'rsd' stage
(``timing.StageClock``: CUDA events on the stream, so gaps where the
card waits on the host count), summed over its marks in a call.

The chained cells' own name: it moves their own rate,
``realisations_per_s.chain``, which their host-bound calls' spread from
run to run gives a bound of its own."""
from portbench.lib.readers import stage_ms


def read(run):
    return stage_ms(run, "rsd")
