"""Run one cell of the benchmark once, on one NVIDIA card.

    python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the comparison with the reference holds beside its limit, which are
also the last lines of standard error. Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 and prints no result; if the
process holds a module of JAX or of the JAX package once the window has
closed, it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "radiodsp_sdr_rx_tpu")


def forbidden_modules() -> list:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader", "--id=0"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return done.stdout.strip() or "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run at a fixed place inside the checkout
    cache = CHECKOUT / ".rxbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    from rxbench import harness

    spec = harness.cell_spec(args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rxbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START, spec=spec)
    result["device"]["power_limit"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"rxbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for name, r in result["checks"].items():
        print(f"check {name}: {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
