"""Run one cell of ``BENCHMARK.json`` once, on the card of this machine.

    python3 perfbench/run.py --workload dcnv2.closed --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds ``src/repro_torch``. The last line
of standard output is the result as one JSON object; the last lines of
standard error are the compared numbers beside their limits. Exits with a
code other than 0, printing no result, without enough CUDA cards, without
the program, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    # the checkout's root (for ``perfbench``) and ``src`` (for the program)
    # in place of this file's directory, whose data folders are no modules
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    # every compiler cache inside the checkout, at a fixed path, so that
    # only a checkout's first run builds (the port's own nvcc libraries
    # already go to build/kernels/ there)
    caches = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(caches / "inductor")
    from perfbench import harness
    return harness.main(t_start=T_START, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
