"""What a run keeps of its window, for the metric readers.

A driver fills one :class:`Record`; each file under ``portbench/metrics``
reads from it the one number it is named for, or ``None`` where the run
has nothing for it to read (then the metric is left out of the line).
"""

from __future__ import annotations

import dataclasses

from portbench.trace import Trace


@dataclasses.dataclass
class Record:
    cell: str
    config: dict  # portbench/configs/<config>.json
    traffic: dict  # portbench/traffic/<traffic>.json
    chips: int
    setup_s: float = 0.0
    window_s: float = 0.0  # host clock, from the window's opening to its close
    frames: int = 0  # real frames completed in the window (all ranks)
    # training: one entry a step in the window, this process's rank
    steps: list = dataclasses.field(default_factory=list)  # {"frames", "t_pad", "batch"}
    data_waits_s: list = dataclasses.field(default_factory=list)  # host clock around each source.next()
    # decode: one entry a batch in the window
    batches: list = dataclasses.field(default_factory=list)  # {"rows"}
    # what else the window saw, for the line: training's validations
    # ([step, loss]), rollbacks, lr factor and recipe stop; decoding's host
    # seconds by phase (read, device, serialise)
    window: dict = dataclasses.field(default_factory=dict)
    trace: Trace | None = None  # the traced run's, this process's
    trace_extent: tuple | None = None  # the traced window on the trace's clock (us)
    busy_s: float | None = None  # averaged over the chips
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    compared: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    correct: bool = False
    program: dict = dataclasses.field(default_factory=dict)  # the program's side of the comparison
    numbers: dict = dataclasses.field(default_factory=dict)  # the numbers compared, by name

    @property
    def nnet(self) -> dict:
        return self.config["nnet"]

    @property
    def compute_dtype(self) -> str:
        return self.nnet.get("compute_dtype", "float32")
