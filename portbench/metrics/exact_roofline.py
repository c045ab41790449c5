"""The COLA exact CIC tier's share of its roofline, in %: the least time
the card could take for a realisation's exact force paints and gathers
over the 'paint_exact' and 'gather_exact' stages' ms.

The work is counted from shapes, whatever implements the tier (f32, N^3
particles on an N^3 mesh): an exact paint reads the three position
components and writes the mesh (``lib/readers.paint_work``, 16 N^3
bytes); a force evaluation's exact gather reads the positions once and
the three force meshes and writes the three components (36 N^3 bytes;
~60 operations a particle: the corners, their weights and 24 products).
Bytes bound both.  The counts are the program's ``exact.paint`` (one a
force evaluation) and ``exact.gather`` (one a component, three a force
evaluation); None without them (a program that does not count them).
"""
from portbench.lib.peaks import bound_ms, share_pct
from portbench.lib.readers import paint_work, stage_ms
from portbench.lib.trace import totals


def gather_work(N: int):
    """(bytes, operations) of one force evaluation's exact gather."""
    return 36 * N ** 3, 60.0 * N ** 3


def bound(N: int, paints: float, gathers: float) -> float:
    """The least ms of ``paints`` exact paints and ``gathers`` exact force
    components gathered."""
    return paints * bound_ms(*paint_work(N))[0] \
        + gathers / 3.0 * bound_ms(*gather_work(N))[0]


def read(run):
    t = totals(run)
    if t is None or "exact.paint" not in t["counts"]:
        return None
    R = run.clocked_realisations
    paints = t["counts"]["exact.paint"] / R
    gathers = t["counts"].get("exact.gather", 0) / R
    ms = [stage_ms(run, s) for s in ("paint_exact", "gather_exact")]
    if None in ms:
        return None
    return share_pct(bound(int(run.config["nsamp"]), paints, gathers),
                     sum(ms))
