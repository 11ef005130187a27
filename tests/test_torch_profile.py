"""The port's profilers (saunet_tpu_torch/profile/, `cli.profile`) on the
CPU: every mode but scaling (whose gloo ranks ride in the rank fixtures of
test_torch_parallel.py and test_torch_space.py) at 32^2, batch 2, 2 steps:
its report and JSON line, its segment names, and each name's row in the
JAX tool it answers to (the row's text found in that tool's source).
The cuts change nothing: the segmented forward of each route gives
logits bitwise equal to the unsegmented one (`model.forward` for the
cuDNN route), the decoder's cumulative stages end in the forward's
logits, and the augmentation's timed stage is `augment_with_coords`'s.
Without a card the default device raises. Port only on the profilers'
side; the tests read the JAX tools as text."""
import json
import pathlib

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli import profile as cli
from saunet_tpu_torch.data import augment as A
from saunet_tpu_torch.ops.cuda import (
    fold_shape_stream_params,
    shape_stream_fused,
    warp_image_label,
)
from saunet_tpu_torch.profile import augment, common, decode, infer, train
from saunet_tpu_torch.profile.scaling import predict
from saunet_tpu_torch.train import InferState
from saunet_tpu_torch.train.state import _forward_eval
from torch_port_util import one_thread  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = ("--device", "cpu", "--hw", "32", "--batch", "2", "--steps", "2")
#: each mode's extra arguments, and the segment names (in order) of each
#: of its routes
MODES = {
    "infer": ((), {
        "k3": infer.ENCODER + infer.DECODE + ("argmax",),
        "cudnn": infer.ENCODER + infer.DECODE + ("argmax",),
        "k4": infer.ENCODER + ("stream_inputs", "k4") + infer.DECODE[1:]
        + ("argmax",)}),
    "decode": ((), {
        "module": ("shape_stream", "resizes", "edge_fusion", "decoder",
                   "head"),
        "k4": ("stream_inputs", "resizes", "k4", "edge_fusion", "decoder",
               "head")}),
    "train": (("--augment",), {"fwd": train.FORWARD}),
    "opt_metrics": ((), {}),
    "block_train": ((), {}),
    "concat": ((), {}),
    "res1": ((), {}),
    "augment": ((), {}),
    "saliency": (("--sg_n", "2", "--sg_batch", "2"), {}),
    "output_layout": ((), {}),
}


@pytest.fixture(scope="module")
def reports():
    """Each mode's report, from the CLI's own parser, once."""
    return {what: cli.run(cli.parse_args(["--what", what, *SMALL, *extra]))
            for what, (extra, _) in MODES.items()}


@pytest.mark.parametrize("what", list(MODES))
def test_mode_reports_its_rows_with_the_jax_tools_names(what, reports):
    res = reports[what]
    line = json.loads(json.dumps(res))
    assert line["profile"] == what and line["device"] == "cpu"
    assert "not device times" in line["card"]
    launches = line.get("launches")  # nothing is counted on the CPU
    assert launches is None or all(v is None for v in launches.values())
    tools = [(REPO / t).read_text() for t in res["jax_tool"].split(", ")]
    assert res["rows"]
    for r in res["rows"]:
        assert r["jax"] and any(r["jax"] in t for t in tools), r
        assert r["ms"] is None or np.isfinite(r["ms"]), r
    names = [r["name"] for r in res["rows"]]
    assert len(names) == len(set(names))
    for route, segments in MODES[what][1].items():
        got = tuple(n.split("/", 1)[1] for n in names
                    if n.startswith(route + "/"))
        assert got == segments, (route, got)
    if what in ("infer", "decode"):
        assert set(res["routes"]) == set(MODES[what][1])
        for r in res["routes"].values():
            assert r["segments_ms"] > 0 and r["whole_ms"] > 0


def test_main_prints_the_table_and_one_json_line(capsys):
    assert cli.main(["--what", "res1", *SMALL]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("== res1 (tools/profile_res1.py)")
    assert json.loads(out[-1])["profile"] == "res1"
    assert sum(line.startswith("{") for line in out) == 1


def test_output_layout_records_whether_the_structures_agree(reports):
    res = reports["output_layout"]
    assert [r["name"] for r in res["rows"]] == ["A rng-arg", "B dict",
                                                "C step+1"]
    assert res["agree"] == (res["spread_ms"] <= res["noise_ms"])


@pytest.fixture(scope="module")
def served():
    """The profilers' seeded full-width bf16 model at 32^2, its infer
    state and two images."""
    gen = torch.Generator().manual_seed(0)
    model = common.seeded_model("cpu", 32, gen)
    images = common.synthetic_batch(gen, 2, 32, "cpu")["image"]
    return model, InferState(model, "cpu"), images


def test_segmented_forward_is_the_forward_bitwise(served):
    """The cuts (forward hooks, CUDA events or the host clock, the block
    wrapper, the resizes wrapped) change nothing: each route's segmented
    logits are bitwise those of the same route unsegmented, the cuDNN
    route's those of `model.forward`."""
    model, state, images = served
    x = images.permute(0, 3, 1, 2)
    with torch.inference_mode():
        forward = model(x)[0]
        fused = _forward_eval(model, state.folded, images, True)[0]
        taps = infer.fused_taps(model, state.folded, images)
        folded_stream = fold_shape_stream_params(model)
        edge = shape_stream_fused(model.shape_stream_inputs(taps, x),
                                  folded_stream)
        k4 = model.decode(taps, x, edge_out=edge.permute(0, 3, 1, 2))[0]
        decoded = model.decode(taps, x.to(model.dtype))
    segs = common.Segments("cpu")
    assert torch.equal(infer.cudnn_pass(model, images, segs)[0], forward)
    assert "block4" in segs.ms()[0]
    segs = common.Segments("cpu")
    assert torch.equal(infer.k3_pass(model, state.folded, images, segs)[0],
                       fused)
    assert torch.equal(infer.k4_pass(model, state.folded, folded_stream,
                                     images, common.Segments("cpu"))[0], k4)
    xb = x.to(model.dtype)
    out = decode.module_pass(model, taps, xb, common.Segments("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(out, decoded))
    out = decode.k4_pass(model, taps, xb, folded_stream,
                         common.Segments("cpu"))
    assert torch.equal(out[0], k4)


def test_decoder_stages_end_in_the_forward_logits(served):
    """profile/train.py's mirror of `decode` (the cumulative objectives of
    `--decoder`): its last stage's output is the forward's logits, and
    each stage is named as profile_train.py names it."""
    model, _, images = served
    x = images.permute(0, 3, 1, 2).to(model.dtype)
    with torch.inference_mode():
        outs = train.decoder_stages(model, x, 8)
        assert torch.equal(outs[-1], model(x)[0])
    assert len(outs) == 5 + 4 + 4
    tool = (REPO / "tools/profile_train.py").read_text()
    for name in train.DECODER_STAGES + train.TAIL_STAGES:
        assert f'"{name}"' in tool, name


def test_segments_attribute_nested_regions():
    """A region `inside` a segment goes to its own name and the time after
    it back to the enclosing segment; a name begun twice is summed."""
    segs = common.Segments("cpu")
    segs.begin("a")
    with segs.inside("r"):
        pass
    segs.begin("b")
    segs.begin("a")
    segs.end()
    ms, whole = segs.ms()
    assert list(ms) == ["a", "r", "b"]
    assert sum(ms.values()) == pytest.approx(whole)


def test_gamma_zscore_is_the_augmentations():
    gen = torch.Generator().manual_seed(4)
    imgs = torch.randn((2, 24, 20), generator=gen)
    labels = torch.randint(0, 4, (2, 24, 20), generator=gen,
                           dtype=torch.int32)
    d = A.draw(gen, 2, 24, 20, True, "cpu")
    sy, sx, gamma = A.coords_from_draws(h=24, w=20, **d)
    img_w, _ = warp_image_label(imgs, labels, sy, sx)
    want = A.augment_with_coords(imgs, labels, sy, sx, gamma)["image"]
    assert torch.equal(augment.gamma_zscore(img_w, gamma), want)


def test_the_default_device_is_the_card():
    """Without a card the default device raises; scaling refuses to run
    without its link rate."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(cli.parse_args(["--what", "res1", "--hw", "32", "--batch",
                                "2", "--steps", "1"]))
    with pytest.raises(SystemExit):
        cli.parse_args(["--what", "scaling", "--device", "cpu"])


def test_scaling_prediction_scales_the_exchanges_and_rings():
    """`predict` on a made-up inventory: the row exchanges scale with the
    width and the samples a rank, the space sums with the samples, the
    rest not at all; each class crosses the link 2 (g - 1) / g times over
    its group at the given rate."""
    def rec(cls, nbytes, group):
        return {"class": cls, "bytes": nbytes, "group": group}

    data = {"hw": 64, "samples_per_rank": 1, "collectives": [
        rec("gradients", 1000, 2), rec("bn_stats", 100, 2),
        rec("loss_metrics", 10, 2)]}
    grid = {"hw": 64, "samples_per_rank": 2, "collectives": [
        rec("gradients", 1000, 4), rec("row_exchanges", 64, 2),
        rec("row_exchanges", 64, 2), rec("space_sums", 8, 2)]}
    pred = predict({"data2": data, "data2_space2": grid}, 1.0)
    d4 = pred["data=4"]["224^2 b64"]
    assert d4["classes"]["gradients"] == {"count": 1, "bytes": 1000}
    assert d4["comm_ms"] == pytest.approx(1.5 * 1110 / 1e9 * 1e3)
    g = pred["2x2"]["512^2 b8"]
    assert g["classes"]["row_exchanges"] == {"count": 2,
                                             "bytes": 128 * 8 * 4}
    assert g["classes"]["space_sums"] == {"count": 1, "bytes": 8 * 4}
    assert g["comm_ms"] == pytest.approx(
        (1.5 * 1000 + 1.0 * (128 * 32 + 32)) / 1e9 * 1e3)
