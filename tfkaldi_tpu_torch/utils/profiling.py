"""Profiling hooks.

Port of :mod:`tfkaldi_tpu.utils.profiling` on ``torch.profiler`` (the
JAX package wraps ``jax.profiler``; the reference has no tracing at all,
SURVEY §5). :class:`Trace` (started and stopped by the caller, as the
training controller's ``profile_steps`` window does) and
:func:`trace_profile` (a context manager) capture the host activity of
every thread (the prefetch worker's ``prefetch.build`` spans beside the
loop's) and, where a card is present, the device activity of a region,
and export it as a Chrome trace
(``<logdir>/<host>_<pid>.<ns>.pt.trace.json``, readable in Perfetto or
``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


class Trace:
    """A ``torch.profiler`` capture of the CPU (and CUDA, with a card)
    activity, running from construction; :meth:`stop` ends it and writes
    the Chrome trace into ``logdir``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: str | None = None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # without it the profiler records only the thread that starts it
        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self._prof = torch.profiler.profile(activities=activities, experimental_config=every_thread)
        self._prof.start()

    def stop(self) -> str:
        """Stop the capture (once) and export it; returns the trace's path."""
        if self.path is None:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self.path = os.path.join(self.logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
            self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Capture a torch.profiler trace of the enclosed region into
    ``logdir``; yields the :class:`Trace` (its ``path`` is set on exit)."""
    trace = Trace(logdir)
    try:
        yield trace
    finally:
        trace.stop()
