"""Device: the share of the profiled requests in which no operation ran on
the card (torch.profiler's kernel intervals against the host clock)."""
from portbench.readers import idle_pct


def read(record):
    return idle_pct(record)
