"""``rnnt_joint_ms``: device time a step of the joint's blocks, the
launches under the program's ``rnnt.joint`` spans (the forward's and the
checkpoint's recompute) and their backward (:mod:`portbench.regions`), in
the traced steps, in ms."""

from portbench.metrics.rnnt_encode_ms import region_ms


def read(rec):
    return region_ms(rec, "rnnt.joint")
