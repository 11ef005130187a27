"""Decoder and head: Canny on K1, the edge fusion, the dual-attention
decoder, the head and the argmax (models/saunet.py::decode after the
stream, models/blocks.py): CUDA events from the fuse hook to the step's
end, mean ms a volume."""
from portbench.readers import mean_span


def read(record):
    return mean_span(record, "decoder")
