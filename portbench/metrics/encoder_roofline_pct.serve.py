"""Kernels: the encoder's share of its roofline. Its least time on the
card's peaks (portbench/counts: the operations and bytes of the stem, the
dense blocks on K3, the transitions and norm5, for each request's padded
batch) over its measured time (the encoder span), summed over the
window's requests."""
from portbench import peaks
from portbench.counts import saunet


def read(record):
    # a share of the card's peak: only from a run on the card
    if (not record or record["dtype"] != "bfloat16"
            or record["device"] != "cuda"):
        return None
    spent = bound = 0.0
    for span, n in zip(record["spans"], record["batch_slices"]):
        if "encoder" in span:
            ops, nbytes = saunet.encoder_work(n, record["hw"], record["hw"])
            bound += peaks.bound_s(ops, nbytes)
            spent += span["encoder"] / 1e3
    return 100.0 * bound / spent if spent else None
