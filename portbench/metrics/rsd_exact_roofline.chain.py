"""The RSD exact tier's share of its roofline, in %: the least time the
card could take for a realisation's exact remaps over the 'rsd_exact'
stage's ms.

The work is ``rsd_roofline``'s, counted from the program's
``rsdwork.exact_cells`` (the cells of the remaps that took the exact
tier), whatever implements the tier: each cell at least reads the density
and the LOS velocity and writes the result, 12 bytes in float32, 0.060 ms
for a 256^3 remap.  The sort, the gather and K3 add traffic above that
floor, so a fused sort-and-interpolate kernel would raise the share, and
it stays under 100%.  Both the count and the stage are per realisation
over every clocked realisation, the banded ones included.  None without
``rsdwork.exact_cells`` or the 'rsd_exact' stage (a program that does not
count or mark them, or a run in which no remap took the tier).  The
chained cells' own name."""
from portbench.lib import harness
from portbench.lib.peaks import bound_ms, share_pct
from portbench.lib.readers import stage_ms
from portbench.lib.trace import totals


def read(run):
    t = totals(run)
    cells = None if t is None else t["counts"].get("rsdwork.exact_cells")
    ms = stage_ms(run, "rsd_exact")
    if not cells or ms is None:
        return None
    work = harness.load_module("metrics", "rsd_roofline").work
    dtype = run.config["pipeline"].get("dtype", "float32")
    return share_pct(bound_ms(*work(cells / run.clocked_realisations,
                                    dtype), dtype)[0], ms)
