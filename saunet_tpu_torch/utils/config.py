"""Model constants the forward reads, and the attribute-dict config
(counterpart of saunet_tpu/utils/config.py).

BatchNorm momentum: flax keeps `ra = m * ra + (1 - m) * batch` with
m = 0.9 (saunet_tpu/utils/config.py:76, `cfg.MODEL.BN_MOMENTUM` below);
torch keeps `ra = (1 - m) * ra + m * batch`, so the same update is torch
momentum 0.1, which the port's BatchNorm2d reads as BN_MOMENTUM.

`AttrDict`, `default_config`, `cfg` and `assert_and_infer_cfg` are the JAX
package's config surface (the reference's Detectron-style global config):
nested attribute access and a recursive immutability latch, with the same
defaults; nothing in the port reads `cfg`.
"""
from __future__ import annotations

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax 0.9

NUM_CLASSES = 4
NUM_FILTERS = 32

IMMUTABLE = "__immutable__"


class AttrDict(dict):
    """dict with attribute access and a recursive immutability latch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[IMMUTABLE] = False
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, AttrDict):
                self[k] = AttrDict(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if self.__dict__[IMMUTABLE]:
            raise AttributeError(
                f"AttrDict is immutable; cannot set {name!r}")
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        self[name] = value

    def __setitem__(self, name, value):
        if self.__dict__.get(IMMUTABLE, False):
            raise AttributeError(
                f"AttrDict is immutable; cannot set {name!r}")
        super().__setitem__(name, value)

    def immutable(self, is_immutable: bool = True):
        """Recursively (un)freeze the config."""
        self.__dict__[IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self) -> bool:
        return self.__dict__[IMMUTABLE]

    def clone(self) -> "AttrDict":
        out = AttrDict()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, AttrDict) else v
        return out


def default_config() -> AttrDict:
    """The JAX package's defaults (its `config.py` surface)."""
    cfg = AttrDict()
    cfg.BATCH_WEIGHTING = False
    cfg.EPOCH = 0

    cfg.MODEL = AttrDict()
    # 'batchnorm' | 'syncbn': the port syncs BatchNorm by process group
    # (models/norm.py::sync_batch_norm); the knob is kept for the surface
    cfg.MODEL.NORM_FN = "batchnorm"
    cfg.MODEL.BN_MOMENTUM = 0.9  # flax convention: ra = m*ra + (1-m)*batch
    cfg.MODEL.BN_EPS = BN_EPS
    cfg.MODEL.BN_AXIS_NAME = None

    cfg.DATASET = AttrDict()
    cfg.DATASET.ACDC_DIR = ""
    cfg.DATASET.CROP_SIZE = 256
    cfg.DATASET.TRAIN_SPACING_MM = 1.25
    cfg.DATASET.TEST_SPACING_MM = 1.5
    cfg.DATASET.NUM_CLASSES = NUM_CLASSES

    cfg.TRAIN = AttrDict()
    cfg.TRAIN.LR = 1e-4
    cfg.TRAIN.BATCH_SIZE = 10
    cfg.TRAIN.NUM_EPOCH = 180
    cfg.TRAIN.OPTIMIZER = "radam"
    cfg.TRAIN.SEED = 304
    cfg.TRAIN.DTYPE = "bfloat16"  # compute dtype; params/stats stay float32
    return cfg


# The global config (mutable until a driver freezes it).
cfg = default_config()


def assert_and_infer_cfg(config: AttrDict = cfg,
                         make_immutable: bool = True) -> AttrDict:
    """Validate the settings and optionally freeze the config."""
    assert config.MODEL.NORM_FN in ("batchnorm", "syncbn")
    assert config.TRAIN.DTYPE in ("float32", "bfloat16")
    if make_immutable:
        config.immutable(True)
    return config
