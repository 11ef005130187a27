from .config import BN_EPS, BN_MOMENTUM, NUM_CLASSES, NUM_FILTERS
from .meters import AverageMeter

__all__ = ["AverageMeter", "BN_EPS", "BN_MOMENTUM", "NUM_CLASSES",
           "NUM_FILTERS"]
