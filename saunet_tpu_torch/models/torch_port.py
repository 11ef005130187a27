"""Weights of the reference's PyTorch rewrite, tools/torch_baseline.py::
TorchSAUNet, as a port state_dict (counterpart of
saunet_tpu/models/torch_port.py, which maps them onto the JAX tree).

The JAX map renames TorchSAUNet's keys to flax paths and transposes the
kernels to HWIO; the weight bridge (models/jax_weights.py) renames flax
paths to the port's module names and transposes them back. Composed, the
kernels pass through unchanged (conv OIHW, ConvTranspose (in, out, kh, kw)
with the JAX map's flip undone by the bridge's) and only the keys change:
the encoder's `enc.db<b>.<l>.net.<i>` / `enc.t<t>.<i>` become torchvision's
names under `encoder.`, the rest the flax tree's names. The renames are
copied from the JAX module, not imported. BatchNorm's
`num_batches_tracked` comes along under the new name.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

DENSENET_BLOCK_SIZES = {1: 6, 2: 12, 3: 24, 4: 16}
BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
             "num_batches_tracked")


def torch_saunet_renames() -> Dict[str, str]:
    """{TorchSAUNet key: port key}."""
    out: Dict[str, str] = {}

    def conv(src, dst, bias=True):
        out[f"{src}.weight"] = f"{dst}.weight"
        if bias:
            out[f"{src}.bias"] = f"{dst}.bias"

    def bn(src, dst):
        for f in BN_FIELDS:
            out[f"{src}.{f}"] = f"{dst}.{f}"

    # encoder: DenseLayer.net is 0 BN, 1 ReLU, 2 conv1, 3 BN, 4 ReLU,
    # 5 conv2; a transition 0 BN, 1 ReLU, 2 conv, 3 pool
    conv("enc.conv0", "encoder.conv0", bias=False)
    bn("enc.norm0", "encoder.norm0")
    bn("enc.norm5", "encoder.norm5")
    for b, n in DENSENET_BLOCK_SIZES.items():
        for l in range(n):
            src = f"enc.db{b}.{l}.net"
            dst = f"encoder.denseblock{b}.denselayer{l + 1}"
            bn(f"{src}.0", f"{dst}.norm1")
            conv(f"{src}.2", f"{dst}.conv1", bias=False)
            bn(f"{src}.3", f"{dst}.norm2")
            conv(f"{src}.5", f"{dst}.conv2", bias=False)
    for t in (1, 2, 3):
        bn(f"enc.t{t}.0", f"encoder.transition{t}.norm")
        conv(f"enc.t{t}.2", f"encoder.transition{t}.conv", bias=False)

    # shape stream; a Gate's `gate` is 0 BN(c+1), 1 conv, 2 ReLU,
    # 3 conv(->1), 4 BN(1)
    conv("d0", "d0")
    for i in (1, 2, 3):
        conv(f"res{i}.c1", f"res{i}.conv1", bias=False)
        bn(f"res{i}.b1", f"res{i}.bn1")
        conv(f"res{i}.c2", f"res{i}.conv2", bias=False)
        bn(f"res{i}.b2", f"res{i}.bn2")
        conv(f"d{i}", f"d{i}")
        conv(f"c{i + 2}", f"c{i + 2}")
        bn(f"g{i}.gate.0", f"gate{i}.gate_bn1")
        conv(f"g{i}.gate.1", f"gate{i}.gate_conv1")
        conv(f"g{i}.gate.3", f"gate{i}.gate_conv2")
        bn(f"g{i}.gate.4", f"gate{i}.gate_bn2")
        conv(f"g{i}.conv", f"gate{i}.conv", bias=False)
    conv("fuse", "fuse", bias=False)

    # edge fusion and the tail
    conv("cw", "cw", bias=False)
    conv("expand.0", "expand.Conv_0")
    bn("expand.1", "expand.BatchNorm_0")
    conv("center.0", "center.Conv_0")
    bn("center.1", "center.BatchNorm_0")

    # dual-attention decoder blocks
    for n in (5, 4, 3, 2):
        d = f"dec{n}"
        conv(f"{d}.up.0", f"{d}.mrf_up.ConvTranspose_0")
        bn(f"{d}.up.1", f"{d}.mrf_up.BatchNorm_0")
        conv(f"{d}.fuse.0", f"{d}.c3x3")
        bn(f"{d}.fuse.1", f"{d}.BatchNorm_0")
        conv(f"{d}.se.fc1", f"{d}.channelAttn.fc1")
        conv(f"{d}.se.fc2", f"{d}.channelAttn.fc2")
        conv(f"{d}.sp.down", f"{d}.spatialAttn.down", bias=False)
        bn(f"{d}.sp.bn", f"{d}.spatialAttn.BatchNorm_0")
        conv(f"{d}.sp.phi", f"{d}.spatialAttn.phi")

    # dec1: Sequential(cbr(64, 48), ConvTranspose2d(48, nf), BN, ReLU)
    conv("dec1.0.0", "dec1.conv.Conv_0")
    bn("dec1.0.1", "dec1.conv.BatchNorm_0")
    conv("dec1.1", "dec1.up.ConvTranspose_0")
    bn("dec1.2", "dec1.up.BatchNorm_0")
    conv("dec0.0", "dec0.Conv_0")
    bn("dec0.1", "dec0.BatchNorm_0")
    conv("final", "final")
    return out


def port_torch_saunet_state_dict(
        state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A TorchSAUNet state_dict as the port SAUNet's (load it with
    `load_state_dict(..., strict=True)`). Raises on a key the map does not
    know and on a key of the map the state_dict lacks."""
    renames = torch_saunet_renames()
    extra = sorted(set(state_dict) - set(renames))
    missing = sorted(set(renames) - set(state_dict))
    if extra or missing:
        raise KeyError(f"TorchSAUNet keys without a port counterpart "
                       f"{extra[:4]}, port keys without a TorchSAUNet key "
                       f"{missing[:4]}")
    return {renames[k]: v.detach().clone() for k, v in state_dict.items()}
