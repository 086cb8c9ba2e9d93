"""idle_share.search: the share of the traced sub-window of search blocks
in which no operation ran on the card, 1 - (union of the device
intervals) / (the sub-window, from the opening spin kernel's end to the
last operation's end) [%]."""

from bench.yardstick.search import KIND
from bench.yardstick.trace import idle_share


def read(run):
    return idle_share(run.window.trace, (KIND,))
