#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, on the card, at the
cell's own size: for each seed one run of the cell with a short window,
then one JSON line a seed. The window has to reach every sampled answer:
a view cell draws its renders among the window's first 20,000 (~14 s).

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
    python3 portbench/control.py --workload <cell> --seconds <s> --fault <fault> --seeds ...

Without ``--fault``: every number of the program's comparison, and of the
control's (the plain reference computed in bfloat16 put in the program's
place), each judged by the harness's own ``verdict``. With ``--fault``: the
program run with that fault planted under its timed path, and its verdict.
Exits non-zero where a sound run comes out not correct, or a control or a
faulty run comes out correct. The benchmark's own runs never run this."""

import argparse
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def clone_volume(vol):
    import torch

    return dataclasses.replace(vol, **{
        f.name: t.clone() for f in dataclasses.fields(vol)
        if isinstance(t := getattr(vol, f.name), torch.Tensor)})


def window_unchanged(patch=setattr) -> None:
    """Plant a fault under the timed path: from the end of set-up on (the
    window and the traced slice), every fusion step fuses into a scratch
    copy of the volume made when set-up ends, and the volume itself stays
    as set-up left it. The copy takes one pass in set-up, so that a brick
    volume's frame graph for it is captured there, not in the window.
    ``patch`` sets an attribute (a test's ``monkeypatch.setattr``)."""
    from portbench import loops
    from portbench.system import System

    setup, fuse_pass = loops.Runner.setup, System.fuse_pass

    def faulty_setup(self):
        setup(self)
        s, fr = self.system, self.frames
        s.scratch = copy.copy(s)
        s.scratch.vol = clone_volume(s.vol)
        fuse_pass(s.scratch, fr["depths"], fr["poses"], fr["rgbs"])
        loops.sync(self.device)

    def to_scratch(self, *args):
        fuse_pass(getattr(self, "scratch", self), *args)

    patch(loops.Runner, "setup", faulty_setup)
    patch(System, "fuse_pass", to_scratch)


FAULTS = {"window_unchanged": window_unchanged}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)

    import torch

    from portbench import core
    from portbench.run import run_cell, verdict

    if not torch.cuda.is_available():
        core.log("no CUDA card")
        return 2
    files = core.cell_files(args.workload)
    limits = files["limits"]["limits"]
    if args.fault:
        FAULTS[args.fault]()
    bad = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, nums, ctrl = run_cell(files, seed, args.seconds, False, "cuda", t0,
                                      control=not args.fault)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": result["correct"], "metrics": result["metrics"], "program": nums}
        if args.fault:
            bad += result["correct"]
        else:
            # the reference has no capacity to overflow
            line["control"] = ctrl
            line["control_correct"] = verdict(ctrl, limits, False)[0]
            bad += (not result["correct"]) + line["control_correct"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
