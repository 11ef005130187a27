"""saunet_tpu_torch: the PyTorch + CUDA (Hopper, sm_90a) port of saunet_tpu.

The JAX package (`saunet_tpu`) is the reference this port is held against.
This package imports torch and never jax. It covers the serving path today:
`models.build_unet`, `train.make_infer_step` and `cli.test_and_pack`, with
the Canny and eval dense-block TPU kernels ported to hand-written CUDA in
`csrc/` (wrappers in `ops/cuda/`).
"""
__version__ = "0.1.0"
