"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  See ``benchmark/README.md``.
"""
import time

T0_WALL = time.time()       # the process's start, for the set-up time

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program inside the checkout, at a
# fixed path (the port's own library is built in build/sgmcmc_tpu_torch/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark.harness.main import main
    sys.exit(main(sys.argv[1:], T0_WALL))
