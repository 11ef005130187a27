"""Step: the forward FLOPs of the window's real slices (not the padding;
portbench/counts) over the window's wall time, as a share of the card's
bfloat16 peak."""
from portbench import peaks
from portbench.counts import saunet


def read(record):
    # a share of the card's peak: only from a run on the card
    if (not record or record["dtype"] != "bfloat16"
            or record["device"] != "cuda"):
        return None
    flops = sum(record["slices"]) * saunet.forward_flops(
        record["hw"], record["hw"], record["num_filters"],
        record["num_classes"])
    return 100.0 * flops / record["window_s"] / peaks.BF16_FLOPS
