"""Card-side profilers (counterparts of the JAX package's
tools/profile_*.py, tools/exp_output_layout.py and
tools/predict_scaling.py): each mode splits a path of the port into
named segments and times each one, with the name of the JAX tool's row
that each segment answers to. Run them through
`python -m saunet_tpu_torch.cli.profile --what <mode>`.
"""
