"""The port's CLI: python -m fruitnerf_tpu_torch <command> ...

Commands, each the twin of the JAX package's command of the same name:
  process-data  ingest images and fruit masks into a capture directory
                (downscaled levels, transforms.json with semantic paths)
  train         train on a capture directory (transforms.json) or the
                built-in synthetic scene
  eval          full-eval-set metrics of a trained run
  render        PNG panels of a trained run's cameras
  export        semantic point clouds of a trained run, or (--mode
                pointcloud) its depth-backprojected RGB cloud
  count         count the fruit of an exported cloud
  orchard-e2e   synthetic orchard: train -> export -> count -> GT metrics
  suggest-crop  crop-box discovery: probe the field, print the export
                --bounding-box-min/max flags
  viewer        interactive orbit viewer and crop-box picker over HTTP
  speed-probe   train-step rates of the grid recipe candidates on the card
  multi-scene   train S synthetic orchards in one batched step, then export
                and count each
"""
from __future__ import annotations

import argparse
import sys

from .scripts import count as count_cmd
from .scripts import evaluate as eval_cmd
from .scripts import export as export_cmd
from .scripts import multi_scene_campaign as multi_scene_cmd
from .scripts import orchard_e2e as orchard_cmd
from .scripts import process_data as process_cmd
from .scripts import render as render_cmd
from .scripts import speed_probe as speed_cmd
from .scripts import suggest_crop as crop_cmd
from .scripts import train as train_cmd
from .viewer import server as viewer_cmd

COMMANDS = {
    "process-data": process_cmd,
    "train": train_cmd,
    "eval": eval_cmd,
    "render": render_cmd,
    "export": export_cmd,
    "count": count_cmd,
    "orchard-e2e": orchard_cmd,
    "suggest-crop": crop_cmd,
    "viewer": viewer_cmd,
    "speed-probe": speed_cmd,
    "multi-scene": multi_scene_cmd,
}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="fruitnerf_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, mod in COMMANDS.items():
        p = sub.add_parser(name, help=(mod.__doc__ or "").strip().splitlines()[0])
        mod.add_args(p)
    args = parser.parse_args(argv)
    COMMANDS[args.command].main(args)


if __name__ == "__main__":
    main(sys.argv[1:])
