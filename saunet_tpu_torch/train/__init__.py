from .checkpoint import (
    BestIoUPolicy,
    load_jax_variables,
    restore_checkpoint,
    restore_jax_train_state,
    restore_params_only,
    save_checkpoint,
)
from .losses import (
    DEFAULT_CLASS_WEIGHTS,
    dual_loss,
    edge_attention_loss,
    image_based_cross_entropy,
    label_smooth_softmax_ce,
)
from .metrics import intersection_and_union, pixel_acc
from .optim import cosine_epoch_schedule, create_optimizer, radam
from .state import (
    InferState,
    TrainState,
    create_train_state,
    make_eval_step,
    make_infer_step,
    make_train_step,
    serve_volume,
)

__all__ = ["BestIoUPolicy", "DEFAULT_CLASS_WEIGHTS", "InferState",
           "TrainState", "cosine_epoch_schedule", "create_optimizer",
           "create_train_state", "dual_loss", "edge_attention_loss",
           "image_based_cross_entropy", "intersection_and_union",
           "label_smooth_softmax_ce",
           "load_jax_variables", "make_eval_step", "make_infer_step",
           "make_train_step", "pixel_acc", "radam", "restore_checkpoint",
           "restore_jax_train_state", "restore_params_only",
           "save_checkpoint", "serve_volume"]
