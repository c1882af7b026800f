"""Run one benchmark cell once: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of the
checkout (``python3 -m benchmark.run ...`` is the same)."""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
