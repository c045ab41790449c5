"""Host milliseconds a realisation of the 'foregrounds' stage, beside
``stage_ms.foregrounds.chain``'s time on the stream."""
from portbench.lib.trace import host_ms


def read(run):
    return host_ms(run, "foregrounds")
