"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It makes the cell's inputs (for the tenant
bank: the feature map and the input pool) on the card from the seed, warms
up (the program builds the kernels the cell's calls use into the
checkout's ``build/`` on their first call, so only a checkout's first run
compiles), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``. The numbers
compared, each beside its limit, are the last lines on standard error and
the result's last key. Without a CUDA card, with fewer cards than the
cell asks for, or with ``jax`` or ``repro`` loaded once the window has
closed, it prints no result and exits with 2 or 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths():
    """The checkout's root (for ``portbench``) and its ``src`` (for the
    program) on the path; every cache inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import torch

    from portbench import harness, spec

    chips = next(w for w in spec.load_bench(ROOT)["workloads"]
                 if w["name"] == args.workload).get("chips", 1)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"portbench: torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"imports and checks {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START)
    print(f"portbench: card {_power_limit()}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark takes the "
              "port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
