"""The infer step's CUDA graphs (saunet_tpu_torch/train/infer_graph.py) on
the CPU: the rule that decides when the step may replay a graph, the
bookkeeping of eager call, capture and replay (with a stand-in for the
capture, which needs the card), and the step on the CPU, which is always
eager and equals the model's own forward. The card's side (capture,
replay, bit-equal outputs) is chip_smoke.py's `phase_infer_graph`. Port
only: no jax."""
import types

import numpy as np
import pytest
import torch
from torch import nn

from saunet_tpu_torch.data import normalize_for_eval
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.ops.cuda import canny_edges_cuda
from saunet_tpu_torch.train import InferState, infer_graph, make_infer_step
from torch_port_util import one_thread  # noqa: F401  (fixture)

ON_CARD = types.SimpleNamespace(is_cuda=True)  # what the rule reads of x


def _hooked(case):
    """A small model in eval mode, and the input the rule sees, set up for
    one case; returns (x, modules, handle to remove or None)."""
    net = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4)).eval()
    x, handle = ON_CARD, None
    if case == "cpu input":
        x = torch.zeros(1, 3, 8, 8)
    elif case == "a module in training mode":
        net[1].train()
    elif case == "a module's forward hook":
        handle = net[1].register_forward_hook(lambda *_: None)
    elif case == "a module's forward pre-hook":
        handle = net[0].register_forward_pre_hook(lambda *_: None)
    elif case == "a global forward hook":
        handle = nn.modules.module.register_module_forward_hook(
            lambda *_: None)
    elif case == "a global forward pre-hook":
        handle = nn.modules.module.register_module_forward_pre_hook(
            lambda *_: None)
    return x, list(net.modules()), handle


@pytest.mark.parametrize("case, graphed", [
    ("eval mode, no hook, on the card", True),
    ("cpu input", False),
    ("a module in training mode", False),
    ("a module's forward hook", False),
    ("a module's forward pre-hook", False),
    ("a global forward hook", False),
    ("a global forward pre-hook", False),
])
def test_the_rule_runs_eager_where_a_replay_would_differ(case, graphed):
    x, modules, handle = _hooked(case)
    try:
        assert infer_graph.graphable(x, modules) is graphed
    finally:
        if handle is not None:
            handle.remove()
    if handle is not None:  # the same model once the hook is gone
        assert infer_graph.graphable(ON_CARD, modules)


def test_the_key_holds_what_the_graph_fixes(monkeypatch):
    x = torch.zeros(8, 16, 16, 3)
    k = infer_graph.key(x, (False, False, False))
    assert k == infer_graph.key(torch.ones(8, 16, 16, 3),
                                (False, False, False))
    others = [infer_graph.key(torch.zeros(12, 16, 16, 3),
                              (False, False, False)),
              infer_graph.key(x.double(), (False, False, False)),
              infer_graph.key(x, (True, False, False)),
              infer_graph.key(x.permute(0, 2, 1, 3), (False, False, False))]
    for flag in ("allow_tf32", "deterministic"):
        monkeypatch.setattr(torch.backends.cudnn, flag,
                            not getattr(torch.backends.cudnn, flag))
        others.append(infer_graph.key(x, (False, False, False)))
    assert len({k, *others}) == len(others) + 1


def test_eager_then_capture_then_replays_with_true_counts(monkeypatch):
    """The card's capture replaced by a stand-in that runs the same
    forward; what `call` does around it is the card's: the first call of a
    key eager, the second captured, later ones replayed into clones, the
    kernel counter moved by what the capture gained, a key past the bound
    eager."""
    def forward(state, x):
        canny_edges_cuda.launches += 1  # as a kernel wrapper counts
        return None, x * 2, [x + 1]

    class Replayed:
        def __init__(self, static_in, static_out):
            self.static_in, self.static_out = static_in, static_out

        def replay(self):
            _, preds, (plus,) = forward(None, self.static_in)
            canny_edges_cuda.launches -= 1  # a replay calls no wrapper
            self.static_out[1].copy_(preds)
            self.static_out[2][0].copy_(plus)

    def capture(state, fwd, x):
        out = fwd(state, x)
        static_in = torch.empty_like(x)
        static_out = (None, torch.empty_like(x), [torch.empty_like(x)])
        return out, infer_graph._Graph(Replayed(static_in, static_out),
                                       static_in, static_out,
                                       [(canny_edges_cuda, 1)])

    monkeypatch.setattr(infer_graph, "_capture", capture)
    monkeypatch.setattr(canny_edges_cuda, "launches", 0)
    step = types.SimpleNamespace(eager_calls=0, captures=0, replays=0)
    state = types.SimpleNamespace(graphs={})
    key = ("a shape",)
    outs = []
    for i in range(5):
        x = torch.full((2, 3), float(i))
        outs.append(infer_graph.call(step, state, key, forward, x))
        assert canny_edges_cuda.launches == i + 1
    assert (step.eager_calls, step.captures, step.replays) == (1, 1, 3)
    for i, (probs, preds, (plus,)) in enumerate(outs):
        # each call's outputs are its own, unchanged by the calls after it
        assert probs is None
        assert torch.equal(preds, torch.full((2, 3), 2.0 * i))
        assert torch.equal(plus, torch.full((2, 3), i + 1.0))
    assert outs[3][1] is not state.graphs[key].output[1]

    for n in range(infer_graph.GRAPHS_PER_STATE):
        infer_graph.call(step, state, ("shape", n), forward, x)
    assert len(state.graphs) == infer_graph.GRAPHS_PER_STATE
    assert ("shape", infer_graph.GRAPHS_PER_STATE - 1) not in state.graphs
    assert step.eager_calls == 1 + infer_graph.GRAPHS_PER_STATE
    assert canny_edges_cuda.launches == 5 + infer_graph.GRAPHS_PER_STATE


def test_the_step_on_the_cpu_is_eager_and_equals_the_forward():
    model = build_unet(dtype="float32")
    state = InferState(model, "cpu")
    step = make_infer_step(model, with_probs=True, with_edge=True,
                           with_att=True)
    rs = np.random.RandomState(5)
    for _ in range(3):  # a graph would be replaying by the third call
        x = normalize_for_eval(torch.from_numpy(
            rs.rand(1, 32, 32).astype(np.float32)))
        probs, preds, edge, atts = step(state, x)
    with torch.inference_mode():
        seg, edge_ref, atts_ref = model(x.permute(0, 3, 1, 2),
                                        return_att=True)
    assert torch.equal(preds, seg.argmax(dim=1))
    assert torch.equal(probs, torch.softmax(seg, dim=1).permute(0, 2, 3, 1))
    assert torch.equal(edge, edge_ref.permute(0, 2, 3, 1))
    assert all(torch.equal(a, r.permute(0, 2, 3, 1))
               for a, r in zip(atts, atts_ref))
    assert (step.eager_calls, step.captures, step.replays) == (3, 0, 0)
    assert state.graphs == {}
