"""Interpretability: vanilla and guided backprop and SmoothGrad
(counterpart of saunet_tpu/interpret)."""
from .saliency import (
    convert_to_grayscale,
    guided_gradients,
    guided_model,
    guided_relu,
    positive_negative_saliency,
    save_gradient_image,
    smooth_grad,
    vanilla_gradients,
)

__all__ = ["convert_to_grayscale", "guided_gradients", "guided_model",
           "guided_relu", "positive_negative_saliency", "save_gradient_image",
           "smooth_grad", "vanilla_gradients"]
