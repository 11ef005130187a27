"""Shape stream: models/saunet.py::shape_stream (CUDA events from the d0
pre-hook to the fuse hook), mean ms a volume."""
from portbench.readers import mean_span


def read(record):
    return mean_span(record, "stream")
