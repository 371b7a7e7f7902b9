"""A checkout root of the benchmark at a size the CPU runs in seconds: the
repository's ``BENCHMARK.json`` and data files, with every configuration
and traffic mix shrunk (fewer rays, samples, levels and rows, a small
scene). The widths of the MLPs are kept."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SHRINK_CONFIG = {
    "train_rays_per_batch": 64,
    "model": {"num_nerf_samples": 8, "num_proposal_samples": [16, 8],
              "sparsity_num_points": 64},
}
SHRINK_GRID = {"num_levels": 4, "table_size": 256, "mid_table_size": 128, "fine_levels": 1,
               "max_res": 64}
SHRINK_HASH = {"num_levels": 4, "log2_hashmap_size": 10, "max_res": 128}
SHRINK_PROPOSAL_HASH = {"num_levels": 2, "log2_hashmap_size": 8}
SHRINK_TRAFFIC = {"scene": {"num_fruits": 3, "num_cameras": 6, "image_size": 24},
                  "warmup_steps": 6, "trace_steps": 5}


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def shrink_config(doc: dict) -> dict:
    cfg = doc["config"]
    _merge(cfg, json.loads(json.dumps(SHRINK_CONFIG)))
    field = cfg["model"]["field"]
    _merge(field["grid"], dict(SHRINK_GRID))
    _merge(field["hash"], dict(SHRINK_HASH))
    for net in cfg["model"]["proposal_nets"]:
        if net["kind"] == "hash":
            _merge(net["hash"], dict(SHRINK_PROPOSAL_HASH))
    return doc


def shrink_traffic(doc: dict) -> dict:
    _merge(doc, json.loads(json.dumps(SHRINK_TRAFFIC)))
    if doc.get("scenes", 1) > 1:
        doc["scenes"] = 2
        doc["config"]["train_rays_per_batch"] = 32
    return doc


def make_root(tmp: Path) -> Path:
    """A shrunk copy of the benchmark under ``tmp``; returns its root."""
    src = REPO / "port_bench"
    dst = tmp / "port_bench"
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("metrics", "limits", "entries"):
        shutil.copytree(src / sub, dst / sub)
    (dst / "configs").mkdir(parents=True)
    (dst / "traffic").mkdir()
    for f in (src / "configs").glob("*.json"):
        (dst / "configs" / f.name).write_text(json.dumps(shrink_config(json.loads(f.read_text()))))
    for f in (src / "traffic").glob("*.json"):
        (dst / "traffic" / f.name).write_text(json.dumps(shrink_traffic(json.loads(f.read_text()))))
    return tmp


def workloads() -> list[str]:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
