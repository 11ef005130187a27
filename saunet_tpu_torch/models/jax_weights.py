"""Weight bridge: a JAX package `{'params', 'batch_stats'}` tree -> a port
state_dict (the other direction of saunet_tpu/models/torch_port.py).

The port's modules carry the flax tree's names, so the map is one to one:
flax path `a/b/c/<leaf>` is port key `a.b.c.<field>`.

  conv kernel (HWIO)                -> weight (OIHW), transpose(3, 2, 0, 1)
  ConvTranspose_* kernel (HWIO)     -> weight (in, out, kh, kw): flip both
                                       spatial axes, then transpose(2, 3, 0, 1)
  bias                              -> bias
  BN scale / bias                   -> weight / bias
  BN batch_stats mean / var         -> running_mean / running_var (plus
                                       num_batches_tracked = 0)

`port_leaf` is the map of one `params` leaf; `port_params` maps any tree
keyed like `params`, such as an optax state's moments
(train/optim.py::load_jax_opt_state).

Input leaves are numpy arrays (or anything `np.asarray` takes). A JAX
package checkpoint (`.msgpack`) gives such a tree through
`train.checkpoint.load_jax_variables`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def port_leaf(path: tuple, v: np.ndarray) -> Tuple[str, torch.Tensor]:
    """The port key and the tensor of the `params`-tree leaf at flax
    `path` (a tuple of names): HWIO kernels to OIHW, ConvTranspose kernels
    flipped and transposed, BatchNorm `scale` to `weight`. Any tree keyed
    like `params` goes through it: the weights, and the optimizer's
    moments of them. Raises on a leaf the map does not know."""
    mod, leaf = ".".join(path[:-1]), path[-1]
    if leaf == "kernel":
        if v.ndim != 4:
            raise ValueError(f"{'/'.join(path)}: expected a 4-D kernel, "
                             f"got {v.shape}")
        if path[-2].startswith("ConvTranspose"):
            w = v[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            w = v.transpose(3, 2, 0, 1)
        return f"{mod}.weight", torch.from_numpy(np.ascontiguousarray(w))
    if leaf in ("scale", "bias"):
        field = "weight" if leaf == "scale" else "bias"
        return f"{mod}.{field}", torch.from_numpy(v.copy())
    raise KeyError(f"no port counterpart for params leaf {'/'.join(path)}")


def port_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree keyed like `params` (flax names, numpy leaves) -> {port
    parameter name: f32 tensor}, through `port_leaf`."""
    return dict(port_leaf(path, v) for path, v in _flatten(tree).items())


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} -> port state_dict.

    Raises on a leaf the map does not know and on a BatchNorm whose
    parameters and statistics do not both exist."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    sd: Dict[str, torch.Tensor] = {}
    bn_modules = {path[:-1] for path in params if path[-1] == "scale"}
    stat_modules = {path[:-1] for path in stats}
    if bn_modules != stat_modules:
        raise KeyError(f"BatchNorm leaves missing: params without stats "
                       f"{sorted(bn_modules - stat_modules)[:4]}, stats "
                       f"without params {sorted(stat_modules - bn_modules)[:4]}")

    sd.update(port_leaf(path, v) for path, v in params.items())
    names = {"mean": "running_mean", "var": "running_var"}
    for path, v in stats.items():
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in names:
            raise KeyError(f"no port counterpart for batch_stats leaf "
                           f"{'/'.join(path)}")
        sd[f"{mod}.{names[leaf]}"] = torch.from_numpy(v.copy())
    for path in bn_modules:
        mod = ".".join(path)
        for field in ("running_mean", "running_var"):
            if f"{mod}.{field}" not in sd:
                raise KeyError(f"BatchNorm {mod} has no {field}")
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
