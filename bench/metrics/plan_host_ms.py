"""plan_host_ms: host ms a traced batch spends in its FFT plan (Python,
the dispatcher and the launches), the mean host duration of the
``fft.plan`` spans.  Extras: the same spans' device ms, the plans and
tables built in the session, and the traced sub-window's device-idle ms
by the innermost program span open on the host at the time, or
``outside`` [ms]."""

from bench.yardstick.spans import plan_host_ms, session


def read(run):
    return plan_host_ms(session(), run.window.trace)
