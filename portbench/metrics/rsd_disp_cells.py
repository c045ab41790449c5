"""The mean over RSD remaps of the largest displacement the program read
for its tier, in cells (``rsdwork.disp_mcells`` / 1000 over
``rsdwork.disp_reads``): band 2 covers up to 2.0 cells, band 4 up to
4.0, so a reading near an edge says how close the cell sits to the next
kernel.  None where no displacement was read (or the program does not
count them)."""
from portbench.lib.trace import totals


def read(run):
    t = totals(run)
    reads = 0 if t is None else t["counts"].get("rsdwork.disp_reads", 0)
    if not reads:
        return None
    return t["counts"].get("rsdwork.disp_mcells", 0) / 1000.0 / reads
