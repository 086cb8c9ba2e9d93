"""search_stage_ms: device ms a traced block of DM trials spends in the
program's ``search.block`` span (CUDA-event time), with each stage span's
ms a block (``search.dedisperse``, ``.r2c``, ``.matched_filter``,
``.power``, ``.harmonic_sum``, ``.sift``), the block's ms outside them
(``unattributed_ms``), the real-time margin (the pointing's seconds of
sky over the grid's seconds on the card at this rate), and the cells over
the sift's threshold that the window's blocks counted on the card [ms]."""

from bench.yardstick.search import search_stage_ms
from bench.yardstick.spans import session


def read(run):
    return search_stage_ms(session(), run)
