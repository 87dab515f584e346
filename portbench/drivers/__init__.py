"""One driver a kind of traffic: ``run(cell, seed, seconds, trace, device, t0_wall, workdir, fault, limits)`` returns a :class:`portbench.record.Record`."""
