"""The readers of the port's own spans (metrics/canny_ms.serve.py,
metrics/step_host_ms.serve.py) read nothing where the port recorded no
span of theirs, or has no spans at all (a commit before them), and read
the span's records where there are some; on the card, K1's reader times
the kernel at the sizes served (skipped elsewhere)."""
import pytest

from portbench import harness
from saunet_tpu_torch.utils import profiling

READERS = ("canny_ms.serve", "step_host_ms.serve")
CPU = {"device": "cpu"}


@pytest.mark.parametrize("name", READERS)
def test_no_records_read_nothing(name, monkeypatch):
    reader = harness.metric_reader(name)
    profiling.clear_spans()
    with profiling.annotate("saunet.other"):
        pass
    assert reader.read(CPU) is None
    assert reader.read(None) is None
    monkeypatch.delattr(profiling, "span_records")
    with profiling.annotate("saunet.step"), \
            profiling.annotate("saunet.canny"):
        pass
    assert reader.read(CPU) is None


@pytest.mark.parametrize("name", READERS)
def test_records_are_read(name):
    profiling.clear_spans()
    for _ in range(3):
        with profiling.annotate("saunet.step"), \
                profiling.annotate("saunet.canny"):
            pass
    assert harness.metric_reader(name).read(CPU) > 0
    profiling.clear_spans()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_k1_reader_times_the_kernel(card, dtype):
    profiling.clear_spans()
    with profiling.annotate("saunet.canny"):
        pass
    reader = harness.metric_reader("canny_ms.serve")
    record = {"device": "cuda", "hw": 256, "dtype": dtype,
              "batch_slices": [8, 8, 20]}
    small = reader.read(record)
    large = reader.read(dict(record, batch_slices=[20, 20, 8]))
    # K1 at these sizes is one wave of 64-row bands: a floor near 0.05 ms,
    # barely longer at 20 slices than at 8
    assert 0 < small < 0.5 and 0.9 * small < large < 0.5
    profiling.clear_spans()
