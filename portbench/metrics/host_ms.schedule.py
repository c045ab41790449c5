"""Host milliseconds a realisation of COLA's 'schedule' stage: building
the engine, whose step schedule integrates on the host (scipy ``quad``)."""
from portbench.lib.trace import host_ms


def read(run):
    return host_ms(run, "schedule")
