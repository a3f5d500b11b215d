"""Run one cell of the benchmark of the PyTorch port (``diffdock_tpu_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It prints one
JSON object as the last line of standard output and the compared numbers
with their limits as the last lines of standard error; it exits non-zero,
with no result, where the card the cell needs is missing or where JAX or
the JAX package was loaded. Every cache it or the port writes stays inside
the checkout (kernel builds and tables under ``diffdock_tpu_torch/_build``,
the reference's tables and the compiler caches under ``benchmark/_build``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / "_build"
# fixed cache directories inside the checkout, so only a checkout's first
# run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
# one process with few threads: the host dispatches the dock from one
# thread, and idle pools of CPU threads only add jitter to its timing
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
