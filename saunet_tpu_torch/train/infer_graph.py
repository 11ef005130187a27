"""The infer step as a CUDA graph (train/state.py::make_infer_step).

An eager step issues some 500 kernel launches (bf16) to 1 100 (f32), at
tens of µs of host time each, and the card idles wherever a run of short
kernels outpaces the host. A graph captured once for a padded batch shape
replays every launch of the step with one host call, and the card runs
them back to back.

`graphable` is the one rule for when the step may replay a graph: a CUDA
input, every module in eval mode, no forward hook or pre-hook on any module
and no global one (a replay runs no Python, so it would skip a hook
silently). `call` serves one step of a graphable input. The graphs live on
the `InferState` (`state.graphs`, one memory pool and one capture stream a
state), keyed on everything that decides what the captured launches read
and compute (`key`):

  first call of a key:   eager, on the current stream.
  second call:           eager on the capture stream (the warm-up
                         torch.cuda.graph asks for; this call's outputs),
                         then the capture, under the `saunet.capture` span.
  every later call:      the batch copied into the graph's static input,
                         one replay, and clones of the static outputs (a
                         caller may keep a step's outputs across calls).

The kernel wrappers' `.launches` count calls of their Python wrappers,
which a replay does not make: each graph keeps what the counters gained
during its capture, takes that back (the captured launches did not run),
and adds it at every replay, so the counters read one step's worth a call
whatever the call ran. On a replay that is bookkeeping, not a count made
where the kernels launch: chip_smoke.py's `phase_infer_graph` profiles a
replay and finds K1's and K3's kernels by name, and whatever wraps the
wrappers (`parallel/parity.py::recording_kernel_calls`) sees the eager
call and the capture, never a replay. A key beyond `GRAPHS_PER_STATE`
runs eager.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.nn.modules import module as _module

from ..ops.cuda import KERNELS
from ..utils.profiling import annotate

#: keys a state keeps a graph of (padded batch shapes, as a step's outputs
#: and the backend settings are fixed in a run); ACDC's z buckets come to
#: about 6
GRAPHS_PER_STATE = 8


def graphable(x: torch.Tensor, modules) -> bool:
    """Whether the infer step may replay a graph for input `x` of the model
    whose modules are `modules` (a list made once): `x` on the card, every
    module in eval mode, and no forward hook or pre-hook registered on any
    of them or globally."""
    if not x.is_cuda or _module._global_forward_hooks \
            or _module._global_forward_pre_hooks:
        return False
    return not any(m.training or m._forward_hooks or m._forward_pre_hooks
                   for m in modules)


def key(x: torch.Tensor, outputs: tuple) -> tuple:
    """The graph key of input `x` for a step with `outputs` (its with_probs,
    with_edge, with_att): the input's shape, strides, dtype and device, the
    outputs, and the settings the captured convolutions and matmuls were
    chosen under (TF32, cuDNN's deterministic algorithms)."""
    return (tuple(x.shape), x.stride(), x.dtype, x.device, outputs,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


class _Graph(NamedTuple):
    """A captured step: the graph, its static input and outputs, and what
    each kernel counter gained during the capture."""
    graph: object
    input: torch.Tensor
    output: tuple
    gained: list


def _launch_counts() -> dict:
    return {k: k.launches for k in KERNELS}


def _map(fn: Callable, out):
    """`fn` over every tensor of a step's output (None kept, lists kept)."""
    if isinstance(out, (tuple, list)):
        return type(out)(_map(fn, o) for o in out)
    return None if out is None else fn(out)


def _capture(state, forward: Callable, x: torch.Tensor):
    """The second call of a key: eager on the state's capture stream (the
    warm-up, whose outputs this call returns), then the capture. Returns
    (outputs, the _Graph)."""
    if state.graph_pool is None:
        state.graph_pool = torch.cuda.graph_pool_handle()
        state.capture_stream = torch.cuda.Stream(x.device)
    side, current = state.capture_stream, torch.cuda.current_stream(x.device)
    static_in = torch.empty_like(x)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = forward(state, x)
    current.wait_stream(side)
    # the outputs were made on the side stream and are read on this one
    _map(lambda t: t.record_stream(current), out)

    graph = torch.cuda.CUDAGraph()
    with annotate("saunet.capture"):
        before = _launch_counts()
        with torch.cuda.graph(graph, pool=state.graph_pool, stream=side):
            static_out = forward(state, static_in)
        gained = []
        for k, n in before.items():
            if k.launches != n:
                gained.append((k, k.launches - n))
                k.launches = n  # captured, not run
    return out, _Graph(graph, static_in, static_out, gained)


def call(step, state, graph_key: tuple, forward: Callable,
         x: torch.Tensor):
    """One infer step of graphable `x` under `graph_key`: eager, capture or
    replay (module docstring), counted in `step.eager_calls`,
    `step.captures` or `step.replays`."""
    graphs = state.graphs
    g: Optional[_Graph] = graphs.get(graph_key)
    if g is not None:
        g.input.copy_(x)
        g.graph.replay()
        for k, n in g.gained:
            k.launches += n
        step.replays += 1
        return _map(torch.clone, g.output)
    if graph_key in graphs:
        out, graphs[graph_key] = _capture(state, forward, x)
        step.captures += 1
        return out
    if len(graphs) < GRAPHS_PER_STATE:
        graphs[graph_key] = None  # seen once
    step.eager_calls += 1
    return forward(state, x)
