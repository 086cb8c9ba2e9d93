"""board_w: the window's mean board power, the NVML energy counter's rise
between its first and last step in the window over their time [W]."""


def read(run):
    return None if run.energy is None else run.energy["watts"]
