"""Restoring a trained run: the config and state that ``export``, ``eval``
and ``render`` read from its directory, and the capture parsed as it was
for training."""
from __future__ import annotations

from pathlib import Path

from ..configs import apply_overrides, run_preset
from .checkpoints import read_manifest, resume_from_latest, table_from_manifest
from .trainer import init_train_state


def load_run(load_dir, device):
    """A trained run -> (manifest, config, state at its latest checkpoint on
    ``device``). The manifest rebuilds the training config (preset,
    variant, config overrides), whose encoding and layout must match the
    recorded ones."""
    run_dir = Path(load_dir)
    manifest = read_manifest(run_dir)
    preset, num_images = manifest["preset"], manifest["num_images"]
    variant = manifest.get("variant", "tpu")
    config = run_preset(preset, num_images, variant)
    config = apply_overrides(config, manifest.get("config_overrides", {}))
    table_from_manifest(manifest, config.model.field)
    state, resumed = resume_from_latest(
        run_dir / "checkpoints", init_train_state(config, num_images, device)
    )
    if not resumed:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/checkpoints")
    print(f"loaded step {state.step} ({preset}, variant={variant}) on {device}")
    return manifest, config, state


def parse_capture(data_dir, manifest: dict):
    """Parse a capture at the split and downscale factor its run was trained
    at (``manifest``)."""
    from ..data.dataparser import DataParserConfig, parse_transforms

    return parse_transforms(DataParserConfig(
        data_dir=Path(data_dir), downscale_factor=manifest.get("downscale_factor"),
        train_split_fraction=manifest.get("train_split_fraction", 0.9)))
