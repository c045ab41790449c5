"""The COLA paint's share of its roofline, in %: the least time the card
could take for a realisation's force paints (``lib/readers.paint_work``,
bound by bytes: 0.080 ms a paint at 256^3) over the 'paint' stage's
ms (one mark a force evaluation, ``n_steps`` a realisation)."""
from portbench.lib.readers import paint_roofline as read  # noqa: F401
