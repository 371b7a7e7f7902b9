"""Readings of the controls that set the limits' upper ends: the reference
put in the program's place with a planted change, compared with the
reference as ``check.py`` compares the program. The benchmark's own runs
never run this.

    python3 -m port_bench.control --workload <name> --seeds 1 2 3 \\
        [--faults lower keep_half frozen] [--json out.json]

* ``lower``: computed in the precision below the configuration's (MLP
  operands in float8 e4m3, tables in bfloat16);
* ``keep_half``: half of each step's rays left out, the mean over the rest;
* ``frozen``: every step returns the state unchanged.

It makes the cell's inputs from each seed as a run does and prints one line
a seed and fault with the three numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, drive, harness, scene as SC, training

FAULTS = {"lower": {"lower": True}, "keep_half": {"keep_half": True}, "frozen": {"frozen": True}}


def readings(cell: harness.Cell, seed: int, faults, dev) -> dict:
    """{fault: compared numbers} on one seed, at the cell's own size."""
    cfg = harness.run_config(cell)
    parts = drive.seeds(seed)
    scenes = [SC.render(sp, dev) for sp in drive.scene_params(cell.traffic, parts["scene"])]
    s = cell.traffic.get("scenes", 1)
    # a run's record of what it made, without the program's side
    res = drive.Result(setup_s=0, window_s=0, steps=0, units=0, cpu_s=0, finite=True,
                       build_s=0, memory_peak_bytes=0,
                       checked=training.Checked(None if s == 1 else s,
                                                cell.traffic["checked_steps"]),
                       info={"num_images": scenes[0]["images"].shape[0]},
                       inputs={"scenes": scenes, "seeds": parts})
    check.precision_for_reference()
    ref = check.reference_side(res, cfg, cell.traffic, dev)
    return {f: check.numbers(check.reference_side(res, cfg, cell.traffic, dev, **FAULTS[f]), ref)
            for f in faults}


def main(argv=None, device="cuda", root=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=list(FAULTS), choices=list(FAULTS))
    p.add_argument("--json", type=Path, default=None)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload, root)
    dev = torch.device(device)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        for fault, nums in readings(cell, seed, args.faults, dev).items():
            rows.append({"workload": cell.name, "seed": seed, "fault": fault, **nums})
            print(json.dumps(rows[-1]), flush=True)
        print(f"control: seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
