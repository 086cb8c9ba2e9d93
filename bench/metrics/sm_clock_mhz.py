"""sm_clock_mhz: the median of the SM clock sampled through NVML every
10 ms in the window [MHz]."""


def read(run):
    return None if run.energy is None else float(run.energy["sm_mhz"])
