"""The closed-form counts against what the model computes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import saunet
from portbench.reference import model as ref_model


@pytest.mark.parametrize("hw,nf", [(32, 32), (64, 32), (32, 16)])
def test_forward_flops_match_the_flop_counter(hw, nf):
    from saunet_tpu_torch.models import build_unet

    model = build_unet(dtype="float32", num_filters=nf).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(1, 3, hw, hw))
    assert counter.get_total_flops() == saunet.forward_flops(hw, hw, nf)


def test_forward_flops_at_the_cells_size():
    # 72.15 GFLOP a slice at 256^2, 55.24 at 224^2
    assert saunet.forward_flops(256, 256) == 72_145_458_176
    assert saunet.forward_flops(224, 224) == 55_236_386_816


@pytest.mark.parametrize("n,hw", [(2, 32), (3, 64)])
def test_encoder_work_is_the_sum_over_its_stages(n, hw):
    """Operations: two a multiply-add of every convolution the encoder's
    modules run; bytes: each stage's input and output (2 bytes an element),
    its convolution weights (2 bytes each) and two f32 values a channel of
    each of its BatchNorms, read from the modules as they run."""
    with torch.device("meta"):
        model = ref_model.SAUNet()
    enc = model.encoder
    ops, nbytes = [0], [0]

    def conv_hook(m, inputs, out):
        w = m.weight
        ops[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    def stage_hook(m, inputs, out):
        nbytes[0] += 2 * (inputs[0].numel() + out.numel())
        for sub in m.modules():
            if isinstance(sub, ref_model.Conv):
                nbytes[0] += 2 * sub.weight.numel()
            elif isinstance(sub, ref_model.BN):
                nbytes[0] += 4 * 2 * sub.weight.numel()

    handles = [m.register_forward_hook(conv_hook) for m in enc.modules()
               if isinstance(m, ref_model.Conv)]
    stages = [enc.conv0, enc.norm0, enc.norm5] + [
        m for m in enc.children()
        if isinstance(m, (ref_model.DenseBlock, ref_model.Transition))]
    handles += [m.register_forward_hook(stage_hook) for m in stages]
    enc(torch.empty(n, 3, hw, hw, device="meta"))
    for h in handles:
        h.remove()
    assert (ops[0], nbytes[0]) == saunet.encoder_work(n, hw, hw)
