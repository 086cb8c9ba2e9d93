"""search_roofline: the traced blocks' least time on the card (each
stage's input read and output written once at 3.35 TB/s, or the
dedispersion's adds at 33.5e12/s, the larger) over all the device time
the profiler gives them, the port's kernels and torch's; extras: the same
share for each port kernel by its name in the trace [%]."""

from bench.yardstick.search import search_roofline


def read(run):
    return search_roofline(run.window.trace, run.cfg)
