"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See portbench/README.md and portbench/core/harness.py.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, not this folder, heads the path: the program and
# `portbench` import from there.
sys.path[0] = str(ROOT)
# Kernel caches at fixed paths inside the checkout (the program builds its
# CUDA library into build/ itself).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)

from portbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
