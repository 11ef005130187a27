"""The port's spans (saunet_tpu_torch/utils/profiling.py::annotate) on the
CPU at 32^2: host times, request ids and parents always, each thread its
own; a profiler range only under a torch.profiler session; the serving
path's layer boundaries; the bounded ring; the card's kernels and idle
gaps placed under the spans; `test_and_pack --trace_dir`. Port only: no
jax."""
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from saunet_tpu_torch.cli.test_and_pack import main as pack_main
from saunet_tpu_torch.data import nifti, normalize_for_eval
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.train import InferState, make_infer_step
from saunet_tpu_torch.utils import profiling
from torch_port_util import one_thread  # noqa: F401  (fixture)

CROP = 32
LAYERS = ("saunet.encoder", "saunet.stream", "saunet.canny",
          "saunet.decoder", "saunet.head")


@pytest.fixture(scope="module")
def model():
    return init_random_(build_unet(dtype="float32"),
                        torch.Generator().manual_seed(0))


def _images(n=2):
    x = torch.from_numpy(np.random.RandomState(3).rand(n, CROP, CROP)
                         .astype(np.float32))
    return normalize_for_eval(x)


def _one_step(model):
    """{name: record} of one infer step's spans, and the records."""
    profiling.clear_spans()
    make_infer_step(model)(InferState(model, "cpu"), _images())
    records = profiling.span_records()
    return {r.name: r for r in records}, records


def _inside(child, parent):
    return parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


def test_spans_without_a_profiler_open_no_range(model, monkeypatch):
    def refused(*_):
        raise AssertionError("a profiler range opened with no session")

    monkeypatch.setattr(profiling, "_profiler_range", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    spans, records = _one_step(model)
    step = spans["saunet.step"]
    assert step.parent is None
    for name in LAYERS:
        r = spans[name]
        assert (r.request, r.parent) == (step.request, "saunet.step")
        assert _inside(r, step) and r.host_ms > 0
    assert len(records) == len(LAYERS) + 1

    # a span left by an exception closes; the next outermost one opens a
    # new request
    with pytest.raises(ValueError):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                raise ValueError
    with profiling.annotate("next"):
        pass
    inner, outer, nxt = profiling.span_records()[-3:]
    assert (inner.parent, inner.request) == ("outer", outer.request)
    assert nxt.parent is None and nxt.request > outer.request

    # another thread's span is its own request, whatever this one holds
    with profiling.annotate("main"):
        worker = threading.Thread(
            target=lambda: profiling.annotate("worker").__enter__()
            .__exit__(None, None, None))
        worker.start()
        worker.join()
    by_name = {r.name: r for r in profiling.span_records()[-2:]}
    assert by_name["worker"].parent is None
    assert by_name["worker"].request != by_name["main"].request


def test_kernels_and_idle_gaps_fall_under_their_spans():
    """A made-up timeline (us): a step over an encoder and a decoder;
    kernels launched in each, one launched outside every span, one whose
    launch the profiler did not link."""
    spans = [(0, 100, "step"), (10, 40, "encoder"), (50, 90, "decoder"),
             (200, 300, "step"), (210, 240, "encoder")]
    launches = [(12, 20, 30), (30, 32, 60),   # encoder: 10 + 28 us
                (55, 70, 80),                  # decoder: 10 us
                (95, 82, 84),                  # the step's own: 2 us
                (150, 150, 160),               # outside: 10 us
                (215, 230, 250),               # second encoder: 20 us
                (None, 260, 270)]              # unlinked
    device, idle = profiling.attribute_to_spans(spans, launches)
    assert device == {"step": [0.05, 0.02], "encoder": [0.038, 0.02],
                      "decoder": [0.01]}
    # gaps (mid): 30-32 (31, encoder), 60-70 (65, decoder), 80-82 (81,
    # decoder), 84-150 (117, outside), 160-230 (195, outside), 250-260
    # (255, the step)
    assert idle == pytest.approx({"encoder": 0.002, "decoder": 0.012,
                                  None: 0.136, "step": 0.01})


def test_infer_step_spans_under_the_profiler(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans, _ = _one_step(model)
    step = spans["saunet.step"]
    for name in LAYERS:
        assert spans[name].request == step.request
        assert spans[name].parent == "saunet.step"
        assert _inside(spans[name], step)

    events = prof.events()
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    assert all(len(by_name.get(n, ())) == 1
               for n in ("saunet.step",) + LAYERS)
    stream = by_name["saunet.stream"][0]

    def under(e, ancestor):
        while e is not None:
            if e is ancestor:
                return True
            e = e.cpu_parent
        return False

    inside = {e.name for e in events if under(e.cpu_parent, stream)}
    assert {"aten::conv2d", "aten::sigmoid"} <= inside
    # the stream's ops lie inside its range, and no other layer's do
    lo, hi = stream.time_range.start, stream.time_range.end
    for e in events:
        if under(e.cpu_parent, stream):
            assert lo <= e.time_range.start <= e.time_range.end <= hi
    assert not inside & set(LAYERS)


def test_the_ring_keeps_its_bound():
    profiling.clear_spans()
    for _ in range(profiling.SPAN_RING + 5):
        with profiling.annotate("ring"):
            pass
    records = profiling.span_records()
    assert len(records) == profiling.SPAN_RING
    assert records[-1].request - records[0].request == \
        profiling.SPAN_RING - 1
    profiling.clear_spans()
    assert profiling.span_records() == []


def test_test_and_pack_trace_dir_writes_spans_and_a_trace(model, tmp_path):
    root, out, traces = (str(tmp_path / d) for d in ("data", "out", "tr"))
    rs = np.random.RandomState(0)
    for p, shape in {1: (40, 44, 2), 2: (36, 30, 3)}.items():
        pdir = os.path.join(root, "testing", f"patient{p:03d}")
        os.makedirs(pdir)
        nifti.save((rs.rand(*shape) * 300).astype(np.float32),
                   os.path.join(pdir, f"patient{p:03d}_frame01.nii.gz"),
                   pixdim=(1.3, 1.3, 10))
    ckpt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), ckpt)
    pack_main(["--id", "t", "--checkpoint", ckpt, "--data-root", root,
               "--crop_size", str(CROP), "--dtype", "float32",
               "--device", "cpu", "--save_test_path", out,
               "--result", str(tmp_path / "res"), "--no-visualize",
               "--trace_dir", traces])

    spans = json.load(open(os.path.join(out, "spans.json")))
    for name in ("saunet.serve", "saunet.copy_in", "saunet.normalize",
                 "saunet.step", "saunet.labels_out") + LAYERS:
        row = spans[name]
        assert row["count"] == 2, name
        assert 0 < row["host_ms_median"] <= row["host_ms_p95"]
        assert "device_ms_median" not in row  # the CPU has no device time
    assert spans["saunet.step"]["parent"] == "saunet.serve"
    assert spans["saunet.canny"]["parent"] == "saunet.step"
    assert "(outside the spans)" not in spans
    # the CPU runs the infer step eager, one call a volume
    assert spans["(infer step)"] == {"eager_calls": 2, "captures": 0,
                                     "replays": 0}
    assert spans["saunet.serve"]["host_ms_p95"] >= \
        spans["saunet.step"]["host_ms_median"]
    written = os.listdir(traces)
    assert written
    text = open(os.path.join(traces, written[0])).read()
    assert all(name in text for name in ("saunet.serve",) + LAYERS)
