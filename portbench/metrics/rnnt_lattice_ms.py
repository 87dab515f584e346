"""``rnnt_lattice_ms``: device time a step of the lattice recursion, the
launches under the program's ``rnnt.lattice`` span (the alpha rows of
``ops/rnnt_loss.py``) and their backward (:mod:`portbench.regions`), in the
traced steps, in ms."""

from portbench.metrics.rnnt_encode_ms import region_ms


def read(rec):
    return region_ms(rec, "rnnt.lattice")
