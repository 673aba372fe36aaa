"""The readings that the comparison's limits are set from, on the card.

    python3 -m rxbench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2

For each of ``--seeds`` one run of the program (a short window at the
cell's own size and load, every call of its sampled pass compared as in
every run), and for each of ``--control-seeds`` one run of the control: the
configuration's reference computed one precision below it (TF32 operands in
every matrix product), put in the program's place. Prints one JSON line a run with the
numbers compared. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rxbench import harness


class ReferenceBank:
    """A reference chain behind the entry's interface."""

    def __init__(self, chain):
        self.chain = chain

    def init_state(self):
        return self.chain.init_state()

    def process_planar(self, xr, xi, state):
        dev = self.chain.device
        return self.chain.process(xr.to(dev), xi.to(dev), state)


def control_entry(tf32: bool = True):
    """(make, state_view) of the reference in the program's place."""

    def make(settings, device):
        mod = harness.load_module(harness.ROOT / "reference" / f"{settings['reference']}.py")
        return ReferenceBank(mod.make(settings, device, tf32=tf32))

    def state_view(bank, state):
        return {k: v for k, v in state.items() if torch.is_tensor(v)}

    return make, state_view


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rxbench.control needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            entry = control_entry() if kind == "control" else None
            r = harness.run_cell(args.workload, seed, args.seconds, False, spec=spec, entry=entry)
            print(json.dumps({"workload": args.workload, "run": kind, "seed": seed,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "readings": {k: v["value"] for k, v in r["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
