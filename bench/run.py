"""Entry point: one run of one cell of BENCHMARK.json.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output; exits non-zero, with no result, where no card is found, where the
program (``src/repro_torch``) is missing, or where the process has loaded
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The benchmark's own modules import as ``bench.*``; the program from src/.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        sys.exit(2)
    from bench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
