"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 h100_bench/run.py --workload eight_schools.nuts --seed 7 --seconds 30 --trace 0

Run from the root of a checkout, on a machine with the cell's CUDA
devices. Prints the numbers compared, each beside its limit, as the last
lines of standard error, and one JSON object as the last line of
standard output. Exits with a code other than 0, and prints no result,
where there is no card, where the port is missing, or where the run
loaded JAX or the JAX package.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches, at fixed paths inside the checkout
_CACHE = os.path.join(ROOT, "build", "h100_bench")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from h100_bench import harness

    try:
        import exmc_tpu_torch  # noqa: F401  (the system under test)
    except ModuleNotFoundError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        sys.exit(5)
    sys.exit(harness.main(sys.argv[1:], root=ROOT, t0=T0))
