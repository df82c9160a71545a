"""``--profile_dir``: a ``torch.profiler`` trace of a window of early steps.

Counterpart of ``trace`` in ``lance_distributed_training_tpu/utils/
profiling.py`` and of the JAX trainer's trace window: a profiler with CPU
activity, and CUDA activity on the card, records the host and device
timeline of the steps of the run's first epoch from epoch step 2 (steps 0
and 1 are warm-up) to epoch step 12 or the epoch's end, once a run, and
writes it as a Chrome trace (``chrome://tracing``, ui.perfetto.dev) into
the directory.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["ProfileWindow", "WINDOW"]

WINDOW = (2, 12)  # epoch steps [start, stop) of the traced window


class ProfileWindow:
    """Call :meth:`at` with the epoch step before each step of the traced
    epoch and :meth:`stop` after it (and in ``finally``). Threshold
    comparisons and a one-shot flag, not equality: the window opens at the
    first step at or past its start and closes at the first at or past its
    stop. ``path`` is the trace file once written."""

    def __init__(self, directory: str, cuda: bool):
        self.directory = directory
        self.cuda = cuda
        self.path: Optional[str] = None
        self._prof = None
        self._done = False

    def at(self, epoch_step: int) -> None:
        start, stop = WINDOW
        if self._prof is None and not self._done and epoch_step >= start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and epoch_step >= stop:
            self.stop()

    def stop(self) -> None:
        """Close an open window and write its trace (idempotent)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._done = True
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory,
                                 f"trace-{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(self.path)
