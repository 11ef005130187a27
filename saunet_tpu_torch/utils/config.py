"""Model constants the forward reads (counterpart of
saunet_tpu/utils/config.py's `cfg.MODEL`).

BatchNorm momentum: flax keeps `ra = m * ra + (1 - m) * batch` with
m = 0.9 (saunet_tpu/utils/config.py:76); torch keeps
`ra = (1 - m) * ra + m * batch`, so the same update is torch momentum 0.1.
Serving reads only the running statistics; training will need it.
"""
from __future__ import annotations

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax 0.9

NUM_CLASSES = 4
NUM_FILTERS = 32
