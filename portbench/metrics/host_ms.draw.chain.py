"""Host milliseconds a realisation of the 'draw' stage (from the mark
before it to its own, on the host's clock): what the host spends issuing
the keyed draws, beside ``stage_ms.draw.chain``'s time on the stream."""
from portbench.lib.trace import host_ms


def read(run):
    return host_ms(run, "draw")
