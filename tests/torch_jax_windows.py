"""The port's train step against the JAX package's over a few hundred steps,
from the same parameters and on the same draws: an investigation, not a
tier-1 test (JAX's grid kernel runs in Pallas interpret mode, about 2.5-6
min a 100 steps on a CPU).

Both packages train the full-width ``fruit_nerf`` grid preset on one small
orchard rendered by the JAX package's numpy tracer (which the port copies).
The JAX state starts from ``PRNGKey(0)``; the port starts from those
parameters (``bridge.params_from_jax``). Every step feeds the port the JAX
step's own draws (``test_torch_train_step._jax_draws``). Float32 differences
compound past about 30 steps, so the readings are window means: the train
metrics over ``--window`` steps, and at each window's end one held-out
camera rendered by both (mean accumulation, PSNR, IoU).

    JAX_PLATFORMS=cpu python tests/torch_jax_windows.py --steps 400 \\
        --json /tmp/windows.json

prints one line a window (JAX, port, port / JAX) and writes every step's
readings to ``--json``. ``--init port`` starts the port from its own
initialisation (``init_train_state`` from a generator seeded with the
config's seed), ``--draws port`` draws its steps from that generator
(``train_step``'s own draws), ``--init-seed`` seeds both
initialisations (JAX's key, the port's generator; default the config's
seed for the port and 0 for JAX), and ``--only jax|port`` runs one side:
the port alone then runs as ``orchard-e2e`` runs it.

``--save-replay FILE --from-json RUN.json`` runs no step: it writes the
bridged JAX initialisation, the JAX draws of every step and the JAX side of
an earlier run's ``--json`` (same arguments) to ``FILE``, which
``python -m fruitnerf_tpu_torch.scripts.convergence --replay FILE`` trains
on the card, without JAX, for the same comparison.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_train_step import _jax_draws  # noqa: E402

from fruitnerf_tpu import configs as jconfigs  # noqa: E402
from fruitnerf_tpu.data.builder import dataset_from_scene as jax_dataset  # noqa: E402
from fruitnerf_tpu.data.synthetic import orchard_config, render_scene  # noqa: E402
from fruitnerf_tpu.engine import trainer as jtrainer  # noqa: E402
from fruitnerf_tpu.utils import metrics as JM  # noqa: E402
from fruitnerf_tpu_torch import bridge, configs  # noqa: E402
from fruitnerf_tpu_torch.data.builder import dataset_from_scene  # noqa: E402
from fruitnerf_tpu_torch.engine import trainer  # noqa: E402
from fruitnerf_tpu_torch.utils import metrics as TM  # noqa: E402

KEYS = ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss",
        "distortion", "psnr")
EVAL_KEYS = ("accumulation", "psnr", "iou")


def preset(module, n: int, dtype, rays: int, iters: int):
    """The ``fruit_nerf`` grid preset as orchard-e2e builds it, every MLP
    (the proposals' too) in ``dtype``."""
    cfg = module.apply_overrides(module.fruit_nerf(n, compute_dtype=dtype, variant="grid"),
                                 {"sparsity_loss": 0.005, "train_rays_per_batch": rays})
    m = cfg.model
    m = dataclasses.replace(m, proposal_nets=tuple(
        dataclasses.replace(p, compute_dtype=dtype) for p in m.proposal_nets))
    return dataclasses.replace(cfg, model=m, max_iters=iters)


def jax_eval(params, data, cam: int, cfg) -> dict:
    out = jtrainer.render_camera(params, data.cameras, cam, cfg)
    gt = jnp.asarray(data.images[cam], jnp.float32) / 255.0
    mask = jnp.asarray(data.masks[cam], jnp.float32)
    return {"accumulation": float(jnp.mean(out["accumulation"])),
            "psnr": float(JM.psnr(out["rgb"], gt)),
            "iou": float(JM.binary_iou(out["semantics"][..., 0], mask))}


def port_eval(params, data, cam: int, cfg) -> dict:
    out = trainer.render_camera(params, data.cameras, cam, cfg)
    gt = data.images[cam].float() / 255.0
    mask = data.masks[cam].float()
    return {"accumulation": float(out["accumulation"].mean()),
            "psnr": float(TM.psnr(out["rgb"], gt)),
            "iou": float(TM.binary_iou(out["semantics"][..., 0], mask))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-fruits", type=int, default=30)
    p.add_argument("--num-cameras", type=int, default=40)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--rays", type=int, default=1024)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--window", type=int, default=50)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--init", choices=("jax", "port"), default="jax")
    p.add_argument("--draws", choices=("jax", "port"), default="jax")
    p.add_argument("--init-seed", type=int, default=None)
    p.add_argument("--only", choices=("jax", "port"), default=None)
    p.add_argument("--json", default=None)
    p.add_argument("--save-replay", default=None)
    p.add_argument("--from-json", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)

    scene = render_scene(orchard_config(num_fruits=args.num_fruits, num_cameras=args.num_cameras,
                                        image_size=args.image_size, seed=7))
    n = len(scene["poses"])
    jdata, tdata = jax_dataset(scene, train_fraction=0.95), dataset_from_scene(scene, "cpu", 0.95)
    held = sorted(set(range(n)) - set(np.asarray(jdata.train_indices).tolist())) or [0]
    jcfg = preset(jconfigs, n, getattr(jnp, args.dtype), args.rays, args.steps)
    tcfg = preset(configs, n, getattr(torch, args.dtype), args.rays, args.steps)
    seeds = (0, tcfg.seed) if args.init_seed is None else (args.init_seed,) * 2
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(seeds[0]), jcfg, n)
    gen = torch.Generator().manual_seed(seeds[1])
    params = (bridge.params_from_jax(jax.tree.map(np.array, jstate.params), tcfg.model, "cpu")
              if args.init == "jax" else None)
    tstate = trainer.init_train_state(tcfg, n, "cpu", generator=gen, params=params)
    step_fn = jtrainer.make_train_step(jcfg)
    key = jax.random.PRNGKey(1)
    sides = (args.only,) if args.only else ("jax", "port")
    if args.save_replay:
        assert args.init == "jax" and args.draws == "jax", "a replay starts from JAX's inputs"
        run = json.loads(Path(args.from_json).read_text())
        same = ("num_fruits", "num_cameras", "image_size", "rays", "steps", "window", "dtype")
        assert all(run["args"][k] == getattr(args, k) for k in same), "other arguments"
        draws = [dataclasses.asdict(_jax_draws(key, s, jcfg, jdata)) for s in range(args.steps)]
        torch.save({"args": {k: getattr(args, k) for k in same}, "held": held,
                    "params": params, "draws": draws,
                    "jax": {"steps": [r["jax"] for r in run["steps"]],
                            "windows": [w["jax"] for w in run["windows"]]}},
                   args.save_replay)
        return 0

    rows, windows = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        row = {"step": step}
        draws = _jax_draws(key, step, jcfg, jdata) if args.draws == "jax" else None
        if "jax" in sides:
            jstate, jm = step_fn(jstate, jdata, key)
            row["jax"] = {k: float(jm[k]) for k in KEYS}
        if "port" in sides:
            tm = trainer.train_step(tstate, tdata, tcfg, generator=gen, draws=draws)
            row["port"] = {k: float(tm[k]) for k in KEYS}
        rows.append(row)
        if (step + 1) % args.window == 0:
            cam = held[(step // args.window) % len(held)]
            evals = {}
            if "port" in sides:
                evals["port"] = port_eval(tstate.params, tdata, cam, tcfg)
            if "jax" in sides:
                evals["jax"] = jax_eval(jstate.params, jdata, cam, jcfg)
            win = rows[-args.window:]
            w = {"steps": [win[0]["step"], step], "camera": cam}
            for side in sides:
                w[side] = {k: float(np.mean([r[side][k] for r in win])) for k in KEYS}
                w[side].update({f"eval_{k}": v for k, v in evals[side].items()})
            windows.append(w)
            names = (*KEYS, *(f"eval_{e}" for e in EVAL_KEYS))
            print(f"steps {w['steps'][0]}-{step} ({time.perf_counter() - t0:.0f} s): " + "; ".join(
                f"{k} " + " / ".join(f"{w[s][k]:.5g}" for s in sides)
                + ("" if args.only or not w["jax"][k] else
                   f" ({w['port'][k] / w['jax'][k]:.3f})") for k in names), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"args": vars(args), "windows": windows,
                                               "steps": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
