"""energy_j_per_gb: the board's energy over the window, by its NVML
energy counter, over the GB (1e9 bytes) of input the window consumed."""


def read(run):
    gb = sum(u.in_bytes for u in run.window.units) / 1e9
    if run.energy is None or not gb:
        return None
    return run.energy["joules"] / gb
