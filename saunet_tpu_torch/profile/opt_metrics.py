"""The train step's optimizer and metrics (counterpart of
tools/profile_opt_metrics.py): the fwd+bwd of the loss alone, then with
the RAdam update (train/optim.py), with the metrics (the argmax and
`pixel_acc`, train/metrics.py), with both, and the whole
`make_train_step`, each timed whole; the differences attribute the
update and the metrics, as the JAX tool's do. Eager PyTorch also times
the update (on one step's gradients) and the metrics (on one forward's
argmax) alone. The JAX tool's donated step has no counterpart: the
port's step updates its state in place.
"""
from __future__ import annotations

import torch

from ..train.metrics import pixel_acc
from . import common
from .train import STEPS, setup, step_body

TOOL = "tools/profile_opt_metrics.py"


def run(device=None, batch: int = common.PROF_BATCH, hw: int = common.PROF_HW,
        steps: int = STEPS) -> dict:
    device = common.device_of(device)
    model, state, step, _, data, _ = setup(device, batch, hw)
    launches = common.check_launches(lambda: step(state, data),
                                     {"canny_edges_cuda": 1}, device,
                                     "train step")

    def program(radam: bool, metrics: bool):
        return lambda: step_body(model, state, data, radam, metrics)[0][
            "loss"]

    t = {}
    for name, radam_on, metrics_on, jax in (
            ("grad", False, False, "grad only"),
            ("grad_radam", True, False, "grad + RAdam"),
            ("grad_metrics", False, True, "grad + metrics"),
            ("grad_radam_metrics", True, True, "grad + RAdam + metrics")):
        t[name] = (common.whole_ms(program(radam_on, metrics_on), device,
                                   steps), jax)
    t["step"] = (common.whole_ms(lambda: step(state, data), device, steps),
                 "full train step")
    # eager PyTorch can time the update and the metrics alone, which the
    # differences of whole programs resolve only to their noise
    step_body(model, state, data, radam=False, metrics=False)
    with torch.no_grad():
        logits = model(data["image"].permute(0, 3, 1, 2))[0]
    t["radam_alone"] = (common.whole_ms(state.optimizer.step, device, steps),
                        "RAdam update")
    t["metrics_alone"] = (common.whole_ms(
        lambda: pixel_acc(logits.argmax(dim=1), data["label"], 4), device,
        steps), "metrics (argmax+pixel_acc)")
    rows = [common.row(name, ms, jax) for name, (ms, jax) in t.items()]
    grad = t["grad"][0]
    for name, of, jax in (("radam", "grad_radam", "RAdam update"),
                          ("metrics", "grad_metrics",
                           "metrics (argmax+pixel_acc)"),
                          ("both", "grad_radam_metrics", "both"),
                          ("step_over_grad", "step", "step total over grad")):
        rows.append(common.row(name, t[of][0] - grad, jax))
    return common.report("opt_metrics", device, TOOL, rows, batch=batch,
                         hw=hw, steps=steps, launches=launches)
