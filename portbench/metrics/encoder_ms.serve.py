"""Encoder: models/fused_encoder.py on K3 (bfloat16) or densenet.py
(float32): CUDA events from the step's start to the d0 pre-hook, mean ms a
volume."""
from portbench.readers import mean_span


def read(record):
    return mean_span(record, "encoder")
