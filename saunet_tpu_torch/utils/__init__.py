from .config import (
    BN_EPS,
    BN_MOMENTUM,
    NUM_CLASSES,
    NUM_FILTERS,
    AttrDict,
    assert_and_infer_cfg,
    cfg,
    default_config,
)
from .meters import AverageMeter
from .misc import as_numpy, color_encode
from .profiling import annotate, trace

__all__ = ["AttrDict", "AverageMeter", "BN_EPS", "BN_MOMENTUM",
           "NUM_CLASSES", "NUM_FILTERS", "annotate",
           "as_numpy", "assert_and_infer_cfg", "cfg", "color_encode",
           "default_config", "trace"]
