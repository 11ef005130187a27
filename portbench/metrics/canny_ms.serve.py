"""Edge kernel (K1): the median ms of K1 a served volume. On the card,
K1's kernel duration as torch.profiler reads it
(utils/profiling.py::device_ms_by_kernel), at each padded volume size the
window served, on gray images made as the model makes them from phantom
slices of the cell's crop and type; timed after the window, once the
program is freed (the traced run's profiler keeps no kernel event for a
reader), with the card's clock first brought up from idle. Elsewhere
the host-clock ms of the port's `saunet.canny` span (SAUNet._canny: the
plain Canny). None where the port records no `saunet.canny` span (a
commit before the spans)."""
import statistics

import numpy as np
import torch

from portbench import phantoms
from portbench.program_spans import records

#: calls of K1 the profiler averages over, at each size, after WARM calls
#: that bring the card's clock up from idle
CALLS, WARM = 50, 2000


def read(record):
    found = record and records("saunet.canny")
    if not found:
        return None
    if record["device"] != "cuda":
        return statistics.median(r.host_ms for r in found)
    ms = {n: _k1_ms(n, record["hw"], record["dtype"])
          for n in set(record["batch_slices"])}
    return statistics.median(ms[n] for n in record["batch_slices"])


def _k1_ms(n: int, hw: int, dtype: str) -> float:
    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda
    from saunet_tpu_torch.ops.edge import image_to_gray255
    from saunet_tpu_torch.utils import profiling

    slices, _ = phantoms.make(n, hw, 0, "cuda")
    image = normalize_for_eval(torch.from_numpy(slices).cuda())
    gray = image_to_gray255(image.to(getattr(torch, dtype)))
    for _ in range(WARM):
        canny_edges_cuda(gray)
    by_kernel = profiling.device_ms_by_kernel(lambda: canny_edges_cuda(gray),
                                              calls=CALLS)
    return float(np.sum(list(by_kernel.values())))
