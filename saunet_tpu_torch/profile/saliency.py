"""Saliency maps' cost (counterpart of tools/profile_saliency.py): ms a map
and maps/s of one vanilla backprop, one guided backprop, and SmoothGrad
(`sg_n` noisy copies in batches of `sg_batch`) of each, through the full
bf16 SAUNet (interpret/saliency.py), each beside the device's idle share
over one map (torch.profiler on the card; the guided map is host bound).
"""
from __future__ import annotations

import torch

from ..interpret import guided_model, smooth_grad, vanilla_gradients
from ..utils.profiling import device_idle_share
from . import common

TOOL = "tools/profile_saliency.py"
STEPS = 5
SG_N, SG_BATCH = 50, 10


def run(device=None, hw: int = common.PROF_HW, steps: int = STEPS,
        sg_n: int = SG_N, sg_batch: int = SG_BATCH) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    model = common.seeded_model(device, hw, gen)
    image = torch.rand((hw, hw, 3), generator=gen).to(device)
    target = torch.randint(0, 4, (hw, hw), generator=gen).to(device)
    noise = torch.Generator(device=device).manual_seed(common.SEED + 7)
    guided = guided_model(model)
    grads = {"vanilla": lambda img: vanilla_gradients(model, img, target),
             "guided": lambda img: vanilla_gradients(guided, img, target)}
    chunks = -(-sg_n // sg_batch)
    rows, launches = [], {}
    for name, grad_fn in grads.items():
        for label, fn, jax, canny in (
                (f"single {name} backprop", lambda g=grad_fn: g(image),
                 "single {name:8s} backprop", 1),
                (f"SmoothGrad-{sg_n} {name}",
                 lambda g=grad_fn: smooth_grad(g, noise, image, n=sg_n,
                                               batch_size=sg_batch),
                 "SmoothGrad-{N} {name:8s}", chunks)):
            launches[label] = common.check_launches(
                fn, {"canny_edges_cuda": canny}, device, f"saliency {label}")
            ms = common.whole_ms(fn, device, steps)
            idle = (device_idle_share(fn) if device.type == "cuda"
                    else None)
            rows.append(common.row(label, ms, jax, maps_per_s=1e3 / ms,
                                   device_idle_share=idle))
    return common.report("saliency", device, TOOL, rows, hw=hw, steps=steps,
                         sg_n=sg_n, sg_batch=sg_batch, launches=launches)
