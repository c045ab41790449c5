"""The P(k) stage's share of its roofline, in %: the least time the card
could take for the stage's work (``lib/readers.pk_work``: bytes over
3.35 TB/s or operations over 67 TFLOP/s, the larger) over the 'pk'
stage's ms.  At 256^3 the bytes bound it: 0.030 ms a realisation
in the single pipeline, 0.060 ms in the sharded step.

The chained cells' own name: it moves their own rate,
``realisations_per_s.chain``, which their host-bound calls' spread from
run to run gives a bound of its own."""
from portbench.lib.readers import pk_roofline as read  # noqa: F401
