"""The RSD stage's share of its roofline, in %: the least time the card
could take for a realisation's RSD remaps over the 'rsd' stage's ms.

The work is counted from the program's ``rsdwork.cells`` (the cells its
remaps moved), whatever implements the tier: each remapped cell at least
reads the density and the LOS velocity and writes the result, three
words of the configuration's dtype (12 bytes in float32); the sigma_NL
normals can be drawn in registers, so they count no bytes.  ~10
operations a cell (the move, the wrap, the bracket, the interpolation).
Bytes bound it: 0.481 ms a realisation at 512^3 in float32.  The count
is a floor for any implementation of the stage, so the share stays
under 100% whatever a later program fuses into the remap.  None without
``rsdwork.cells`` (a program that does not count it).
"""
from portbench.lib.peaks import bound_ms, share_pct
from portbench.lib.readers import stage_ms
from portbench.lib.trace import totals

WORD_BYTES = {"float32": 4, "float64": 8}


def work(cells: float, dtype: str = "float32"):
    """(bytes, operations) of remapping ``cells`` cells in ``dtype``."""
    return 3 * WORD_BYTES[dtype] * cells, 10.0 * cells


def read(run):
    t = totals(run)
    if t is None or "rsdwork.cells" not in t["counts"]:
        return None
    dtype = run.config["pipeline"].get("dtype", "float32")
    cells = t["counts"]["rsdwork.cells"] / run.clocked_realisations
    return share_pct(bound_ms(*work(cells, dtype), dtype)[0],
                     stage_ms(run, "rsd"))
