"""Run one benchmark cell of alphazero_tpu_torch once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, the net's seeded weights, the executor's calibration, the
traffic's opening plies and a warm-up step of one wave) counts as ``setup_s``, from
process start to the first timed step; then the window runs for at least
``--seconds``; then the program's results are checked against the plain
reference (``perfbench/compare.py``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics from a device trace of whole steps), ``device`` and, last,
``checks`` (each number compared with its limit).  Each number compared is
also printed beside its limit as the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card, and when JAX or
the JAX package was loaded.  Kernel builds and compiler caches stay under
``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    cache = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.find_cell(args.workload)
    import torch

    chips = int(cell.spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    log(f"# info: {json.dumps(result['info'])}")
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
