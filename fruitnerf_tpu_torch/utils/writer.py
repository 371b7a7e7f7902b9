"""Scalar metric writer (jsonl) — the observability analog of the reference's
nerfstudio writer/event system + rich console logging (SURVEY.md §5). The
port's copy of ``fruitnerf_tpu/utils/writer.py``."""
from __future__ import annotations

import json
import time
from pathlib import Path


class MetricWriter:
    def __init__(self, path, also_print: bool = True):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self.also_print = also_print

    def write(self, step: int, metrics: dict):
        rec = {"step": step, "ts": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.also_print:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[step {step}] {parts}", flush=True)

    def close(self):
        self._f.close()
