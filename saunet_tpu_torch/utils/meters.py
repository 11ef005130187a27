"""Running statistics meter (counterpart of saunet_tpu/utils/meters.py)."""
from __future__ import annotations

import numpy as np


class AverageMeter:
    """Tracks running average/sum of scalars or numpy arrays."""

    def __init__(self):
        self.initialized = False
        self.val = None
        self.avg = None
        self.sum = None
        self.count = 0.0

    def initialize(self, val, weight):
        self.val = val
        self.avg = val
        self.sum = np.multiply(val, weight)
        self.count = weight
        self.initialized = True

    def update(self, val, weight=1):
        if isinstance(val, (list, tuple)):
            val = np.asarray(val)
        if not self.initialized:
            self.initialize(val, weight)
        else:
            self.val = val
            self.sum = np.add(self.sum, np.multiply(val, weight))
            self.count += weight
            self.avg = self.sum / self.count

    def value(self):
        return self.val

    def average(self):
        return self.avg
