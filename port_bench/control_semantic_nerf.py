"""Readings of the controls of a cell of the ``semantic_nerf_loop`` entry
(``control.py``'s for the FruitField cells): the reference put in the
program's place with a planted change, compared with the reference as the
entry's ``compare`` compares the program. The benchmark's own runs never
run this.

    python3 -m port_bench.control_semantic_nerf --workload semantic_nerf.tpu.train \\
        --seeds 1 2 3 [--faults lower keep_half frozen] [--json out.json]

* ``lower``: every MLP matmul on float8 e4m3 operands, the precision below
  the configuration's bfloat16;
* ``keep_half``: half of each step's rays left out, the mean over the rest;
* ``frozen``: every step returns the state unchanged.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, drive, harness, scene as SC, semantic_nerf as SNB, training
from .control import FAULTS


def readings(cell: harness.Cell, seed: int, faults, dev) -> dict:
    """{fault: compared numbers} on one seed, at the cell's own size."""
    cfg = harness.run_config(cell)
    parts = drive.seeds(seed)
    (sp,) = drive.scene_params(cell.traffic, parts["scene"])
    scene = SC.render(sp, dev)
    res = drive.Result(setup_s=0, window_s=0, steps=0, units=0, cpu_s=0, finite=True,
                       build_s=0, memory_peak_bytes=0,
                       checked=training.Checked(None, cell.traffic["checked_steps"]),
                       info={"num_images": scene["images"].shape[0]},
                       inputs={"scenes": [scene], "seeds": parts})
    check.precision_for_reference()
    ref = SNB.reference_side(res, cfg, cell.traffic, dev)
    return {f: check.numbers(SNB.reference_side(res, cfg, cell.traffic, dev, **FAULTS[f]), ref)
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
