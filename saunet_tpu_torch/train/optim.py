"""Optimizers with the JAX package's update rules (counterpart of
saunet_tpu/train/optim.py, which builds them from optax).

Each constructor (`radam`, `plain_radam`, `adam`, `adamw`, `sgd`,
`create_optimizer`) returns a factory `tx(model) -> torch.optim.Optimizer`,
the counterpart of an optax `GradientTransformation`: `create_train_state`
calls it on the model. The learning rate is a float or a schedule
`lr(count)` of the number of updates already applied (optax's
`scale_by_schedule`). Weight decay is optax's `add_decayed_weights`: `wd * p`
is added to the GRADIENT before the moments, for the parameters the mask
selects. Moments are f32; parameters update in place (`p += update`).

RAdam is the JAX `scale_by_radam` (the reference's rule): the adaptive
branch when `n_sma >= 5`, else bias-corrected momentum; eps outside the
sqrt. `torch.optim.RAdam` differs in its threshold and its decay, so it is
not used.

`load_jax_opt_state` takes up a JAX run's optimizer: the optax state of
the three optimizers `create_optimizer` builds, as flax's msgpack stores it
(tuples as '0'/'1' dicts), becomes the port optimizer's moments and count.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.jax_weights import port_params

Schedule = Union[float, Callable[[int], float]]


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for conv kernels, False for biases and norm parameters (the
    reference's `group_weight` split)."""
    kernels = {id(m.weight) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))}
    return {n: id(p) in kernels for n, p in model.named_parameters()}


def _groups(model: nn.Module, weight_decay: float, mask) -> list:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not weight_decay:
        return [{"params": [p for _, p in named], "weight_decay": 0.0}]
    if callable(mask):
        mask = mask(model)
    decayed = [p for n, p in named if mask is None or mask[n]]
    rest = [p for n, p in named if not (mask is None or mask[n])]
    return [g for g in ({"params": decayed, "weight_decay": weight_decay},
                        {"params": rest, "weight_decay": 0.0}) if g["params"]]


class _ScheduledOptimizer(torch.optim.Optimizer):
    """Shared plumbing: the update count (saved with the state) and the
    learning rate, fixed or from a schedule of that count."""

    def __init__(self, params, learning_rate: Schedule, defaults: dict):
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = 0.0 if callable(learning_rate) else float(learning_rate)
        super().__init__(params, dict(defaults, lr=lr))
        self.state["count"] = 0

    def learning_rate(self, group: dict, count: int) -> float:
        if self.schedule is not None:
            return float(self.schedule(count))
        return group["lr"]

    @staticmethod
    def _grads(group: dict, params: list) -> list:
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
        return grads

    def _moments(self, params: list, *names: str) -> list:
        out = []
        for name in names:
            for p in params:
                if name not in self.state[p]:
                    self.state[p][name] = torch.zeros_like(
                        p, dtype=torch.float32)
            out.append([self.state[p][name] for p in params])
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        count = self.state["count"]
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params, count,
                             self.learning_rate(group, count))
        self.state["count"] = count + 1


def radam_step_size(t: int, b1: float, b2: float):
    """(step size without lr, adaptive?) of RAdam's update number t >= 1,
    in f32 and in the JAX expression's order: near the branch threshold
    `n_sma - 4` cancels, so an f64 step size differs from the reference's
    in the fourth digit."""
    f = np.float32
    t = f(t)
    beta2_t = f(b2) ** t
    n_sma_max = f(2.0 / (1.0 - b2) - 1.0)
    n_sma = n_sma_max - f(2.0) * t * beta2_t / (f(1.0) - beta2_t)
    bias1 = f(1.0) - f(b1) ** t
    if n_sma >= 5.0:
        rect = np.sqrt((f(1.0) - beta2_t) * (n_sma - f(4.0))
                       / (n_sma_max - f(4.0)) * (n_sma - f(2.0)) / n_sma
                       * n_sma_max / (n_sma_max - f(2.0)))
        return float(rect / bias1), True
    return float(f(1.0) / bias1), False


class RAdam(_ScheduledOptimizer):
    def __init__(self, params, learning_rate: Schedule = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, learning_rate,
                         dict(betas=(b1, b2), eps=eps, weight_decay=0.0))

    def _update(self, group, params, count, lr):
        b1, b2 = group["betas"]
        grads = self._grads(group, params)
        ms, vs = self._moments(params, "exp_avg", "exp_avg_sq")
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        size, adaptive = radam_step_size(count + 1, b1, b2)
        # (size * m) / (sqrt(v) + eps), then times -lr: the reference's order
        upd = torch._foreach_mul(ms, size)
        if adaptive:
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(upd, denom)
        torch._foreach_add_(params, upd, alpha=-lr)


class Adam(_ScheduledOptimizer):
    """optax.adam: m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps)."""

    def __init__(self, params, learning_rate: Schedule = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, learning_rate,
                         dict(betas=(b1, b2), eps=eps, weight_decay=0.0))

    def _update(self, group, params, count, lr):
        b1, b2 = group["betas"]
        t = count + 1
        grads = self._grads(group, params)
        ms, vs = self._moments(params, "exp_avg", "exp_avg_sq")
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(vs, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_addcdiv_(params, ms, denom,
                                value=-lr / (1.0 - b1 ** t))


class SGD(_ScheduledOptimizer):
    """optax.sgd with momentum (no nesterov): t = g + momentum * t."""

    def __init__(self, params, learning_rate: Schedule = 1e-3,
                 momentum: float = 0.9):
        super().__init__(params, learning_rate,
                         dict(momentum=momentum, weight_decay=0.0))

    def _update(self, group, params, count, lr):
        grads = self._grads(group, params)
        (trace,) = self._moments(params, "trace")
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-lr)


def _factory(cls, learning_rate, weight_decay, mask, **kw):
    def tx(model: nn.Module) -> torch.optim.Optimizer:
        return cls(_groups(model, weight_decay, mask), learning_rate, **kw)
    return tx


def radam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          weight_decay_mask=None):
    return _factory(RAdam, learning_rate, weight_decay, weight_decay_mask,
                    b1=b1, b2=b2, eps=eps)


def plain_radam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0,
                weight_decay_mask=None):
    """The reference's un-buffered RAdam: the same update as `radam`."""
    return radam(learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay,
                 weight_decay_mask=weight_decay_mask)


def adam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    return _factory(Adam, learning_rate, 0.0, None, b1=b1, b2=b2, eps=eps)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-2,
          weight_decay_mask=None):
    """The JAX package's adamw: decay added to the gradient, then Adam."""
    return _factory(Adam, learning_rate, weight_decay, weight_decay_mask,
                    b1=b1, b2=b2, eps=eps)


def sgd(learning_rate: Schedule, momentum: float = 0.9,
        weight_decay: float = 0.0, weight_decay_mask=None):
    return _factory(SGD, learning_rate, weight_decay, weight_decay_mask,
                    momentum=momentum)


def cosine_epoch_schedule(base_lr: float, num_epoch: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """LR constant per epoch: base * 0.5 * (1 + cos(pi * (epoch-1) /
    num_epoch)), epoch 1 at the base LR."""
    def schedule(step: int) -> float:
        epoch0 = step // steps_per_epoch
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch0 / num_epoch))
    return schedule


def create_optimizer(name: str, learning_rate: Schedule,
                     model: Optional[nn.Module] = None, beta1: float = 0.9,
                     weight_decay: float = 1e-4):
    """sgd (momentum `beta1`, decay on the kernels when `model` is given,
    else on every parameter), adam or radam (no decay)."""
    name = name.lower()
    if name == "sgd":
        mask = decay_mask(model) if model is not None else None
        return sgd(learning_rate, momentum=beta1, weight_decay=weight_decay,
                   weight_decay_mask=mask)
    if name == "adam":
        return adam(learning_rate)
    if name == "radam":
        return radam(learning_rate)
    raise ValueError(
        "Invalid optimizer. Please try again with optimizer sgd, adam, or "
        f"radam (got {name!r}).")


def _lr_counts(tree) -> Optional[list]:
    """The counts of an optax learning-rate state: `scale_by_schedule`'s
    {'count'}, or [] for a float's empty state; None for anything else."""
    if not isinstance(tree, Mapping) or set(tree) - {"count"}:
        return None
    return [tree["count"]] if tree else []


def _read_optax_state(opt_state) -> tuple:
    """(kind, {port moment name: params-keyed tree}, [optax counts]) of the
    optax state of `create_optimizer`'s optimizers in flax's msgpack form:

      radam, adam  {'0': {count, mu, nu}, '1': lr state}   kind 'moments'
      sgd          {'0': decay state, '1': {'0': {trace}, '1': lr state}}
                                                           kind 'trace'

    (scale_by_radam's and scale_by_adam's states hold the same fields, so
    the tree names the family, not the rule). The decay state is
    `add_decayed_weights`' empty one, or {'inner_state': {}} under a mask.
    Raises on a tree that fits none of them."""
    if isinstance(opt_state, Mapping) and set(opt_state) == {"0", "1"}:
        first, second = opt_state["0"], opt_state["1"]
        lr = _lr_counts(second)
        if (isinstance(first, Mapping)
                and set(first) == {"count", "mu", "nu"} and lr is not None):
            return ("moments", {"exp_avg": first["mu"],
                                "exp_avg_sq": first["nu"]},
                    [first["count"]] + lr)
        if (isinstance(first, Mapping) and first in ({}, {"inner_state": {}})
                and isinstance(second, Mapping) and set(second) == {"0", "1"}
                and isinstance(second["0"], Mapping)
                and set(second["0"]) == {"trace"}):
            lr = _lr_counts(second["1"])
            if lr is not None:
                return "trace", {"trace": second["0"]["trace"]}, lr
    shape = (sorted(opt_state) if isinstance(opt_state, Mapping)
             else type(opt_state).__name__)
    raise ValueError(f"the optax state {shape} fits none of radam, adam and "
                     f"sgd as create_optimizer builds them")


#: the optax state kind each port optimizer takes
_KINDS = {RAdam: "moments", Adam: "moments", SGD: "trace"}


def load_jax_opt_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                       opt_state: Mapping, step: int) -> None:
    """Set `optimizer` (built on `model`'s parameters) to a JAX run's
    optax state at `step`: each moment tree (keyed like `params`, numpy
    leaves) goes through the weights' layout map into
    `state[p]['exp_avg' | 'exp_avg_sq' | 'trace']`, f32 on the parameter's
    device, and `step` becomes the update count.

    Every optax `count` must equal `step`: RAdam's branch turns on that
    count (`radam_step_size`). Raises, before it changes anything, on a
    tree that fits no optimizer or not this one, on a count that differs,
    and on a moment missing, unknown or of another shape."""
    kind, moments, counts = _read_optax_state(opt_state)
    want = _KINDS.get(type(optimizer))
    if want != kind:
        raise ValueError(f"a {kind!r} optax state does not fit "
                         f"{type(optimizer).__name__}")
    step = int(step)
    counts = [int(np.asarray(c)) for c in counts]
    if any(c != step for c in counts):
        raise ValueError(f"optax counts {counts} differ from the step {step}")
    params = dict(model.named_parameters())
    state: Dict[torch.Tensor, dict] = {p: {} for p in params.values()}
    for name, tree in moments.items():
        ported = port_params(tree)
        extra = sorted(ported.keys() - params.keys())
        missing = sorted(params.keys() - ported.keys())
        if extra or missing:
            raise KeyError(f"{name}: moments without a parameter {extra[:4]}, "
                           f"parameters without a moment {missing[:4]}")
        for k, v in ported.items():
            p = params[k]
            if v.shape != p.shape:
                raise ValueError(f"{name} of {k}: shape {tuple(v.shape)}, "
                                 f"parameter {tuple(p.shape)}")
            state[p][name] = v.to(device=p.device, dtype=torch.float32)
    for p, moments_of_p in state.items():
        optimizer.state[p] = moments_of_p
    optimizer.state["count"] = step
