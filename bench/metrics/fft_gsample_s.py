"""fft_gsample_s: transform points completed in the window over its
seconds [Gsample/s]; a C2R batch counts its n output points a row."""

from bench.yardstick.roofline import FFT_KINDS


def read(run):
    points = sum(u.points for u in run.window.units if u.kind in FFT_KINDS)
    if not points:
        return None
    return points / run.window.seconds / 1e9
