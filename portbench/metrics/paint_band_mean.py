"""The mean lattice band, in cells, of the COLA paints that took the
lattice kernel (``cola.band<b>`` counts): a wider band costs the paint
and the gathers more."""
from portbench.lib.trace import mean_band


def read(run):
    return mean_band(run, "cola.")
