"""What the readers of the port's own spans share
(saunet_tpu_torch/utils/profiling.py::annotate): the records of one span
over the run's process."""
from __future__ import annotations

from typing import Optional


def records(name: str) -> Optional[list]:
    """The port's records of the span `name` (profiling.SpanRecord: its
    host_ms among them), oldest first; None where the port
    records no spans (a commit before them) or none of that name."""
    from saunet_tpu_torch.utils import profiling

    read = getattr(profiling, "span_records", None)
    if read is None:
        return None
    return [r for r in read() if r.name == name] or None
