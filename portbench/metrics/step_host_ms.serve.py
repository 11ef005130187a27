"""Host: the median host-clock ms of the port's `saunet.step` span
(train/state.py::make_infer_step) over every step of the run, the window's
volumes by far the most. The step never waits on the card, so this is the
host's time to enqueue one volume's work; beside the step's device ms it
says whether the device's idle time lies inside the step or between
volumes."""
import statistics

from portbench.program_spans import records


def read(record):
    found = record and records("saunet.step")
    return statistics.median(r.host_ms for r in found) if found else None
