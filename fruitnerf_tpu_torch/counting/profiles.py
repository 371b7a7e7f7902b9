"""Scene counting profiles — the complete dict-profile matrix of the
reference (clustering/config_synthetic.py: 12 rows, config_real.py: 16 rows),
with their exact published hyperparameters and ground-truth counts. Paths are
left None: point a profile at your own exported ``semantic_colormap.ply``
(profile.path or the runner's --cloud flag).

Notable reference quirks preserved:
  * plum and mango use the APPLE template scaled way down
    (config_synthetic.py: plum apple@0.35, mango apple@0.3)
  * every real row uses the apple template (config_real.py)
  * Fuji SAM rows use a larger outlier radius (0.03) than the U-Net rows

GT counts (BASELINE.md): apple 283, pear 250, plum 781, lemon 326, peach 152,
mango 1150; real trees 179/113/291; Fuji-SfM row 1455.
"""
from __future__ import annotations

from .clustering import CountingProfile


def _p(name, **kw) -> CountingProfile:
    return CountingProfile(name=name, **kw)


# --- synthetic scenes: 6 fruits x {gt, sam} masks (config_synthetic.py) -----

def _synth(name, gt_count, template, template_size, nb_points, merge,
           min_samples=100, eps=0.01, radius=0.01):
    return _p(
        name, template=template, template_size=template_size,
        remove_outliers_nb_points=nb_points, remove_outliers_radius=radius,
        down_sample=0.001, eps=eps, min_samples=min_samples,
        cluster_merge_distance=merge, minimum_size_factor=0.3,
        gt_count=gt_count,
    )


SYNTHETIC_PROFILES = {
    # Apple_GT/SAM_1024x1024_300 (config_synthetic.py:2-31)
    "apple": _synth("apple", 283, "apple", 0.7, nb_points=200, merge=0.04),
    "apple_sam": _synth("apple_sam", 283, "apple", 0.7, nb_points=150, merge=0.04),
    # Pear_GT/SAM (config_synthetic.py:33-62)
    "pear": _synth("pear", 250, "pear", 1.1, nb_points=250, merge=0.03),
    "pear_sam": _synth("pear_sam", 250, "pear", 1.1, nb_points=250, merge=0.03),
    # Plum_GT/SAM — apple template @0.35 (config_synthetic.py:64-93)
    "plum": _synth("plum", 781, "apple", 0.35, nb_points=250, merge=0.03),
    "plum_sam": _synth("plum_sam", 781, "apple", 0.35, nb_points=250, merge=0.03),
    # Lemon_GT/SAM (config_synthetic.py:95-124)
    "lemon": _synth("lemon", 326, "lemon", 1.1, nb_points=200, merge=0.06),
    "lemon_sam": _synth("lemon_sam", 326, "lemon", 1.1, nb_points=200, merge=0.06),
    # Peach_GT/SAM — min_samples 70 (config_synthetic.py:126-155)
    "peach": _synth("peach", 152, "peach", 1.2, nb_points=250, merge=0.03,
                    min_samples=70),
    "peach_sam": _synth("peach_sam", 152, "peach", 1.2, nb_points=250,
                        merge=0.03, min_samples=70),
    # Mango_GT/SAM — apple template @0.3, merge 0.01, min_samples 70
    # (config_synthetic.py:157-185)
    "mango": _synth("mango", 1150, "apple", 0.3, nb_points=250, merge=0.01,
                    min_samples=70),
    "mango_sam": _synth("mango_sam", 1150, "apple", 0.3, nb_points=250,
                        merge=0.01, min_samples=70),
}

# --- real scenes: 3 trees x {sam, unet} x {base, big} + Fuji x 4
# (config_real.py) -----------------------------------------------------------

def _tree01(name, nb_points=120):
    # Baum_01_* (config_real.py:3-62): identical hyperparameters on all rows
    return _p(
        name, template="apple", template_size=1.0,
        remove_outliers_nb_points=nb_points, remove_outliers_radius=0.015,
        down_sample=0.001, eps=0.02, min_samples=100,
        cluster_merge_distance=0.04, minimum_size_factor=0.3, gt_count=179,
    )


def _tree02(name, nb_points):
    # Baum_02_* (config_real.py:66-125): nb_points varies 65/70/50/50
    return _p(
        name, template="apple", template_size=1.9,
        remove_outliers_nb_points=nb_points, remove_outliers_radius=0.025,
        down_sample=0.001, eps=0.03, min_samples=100,
        cluster_merge_distance=0.04, minimum_size_factor=0.1, gt_count=113,
    )


def _tree03(name):
    # Baum_03_* (config_real.py:129-188): identical on all rows
    return _p(
        name, template="apple", template_size=1.8,
        remove_outliers_nb_points=100, remove_outliers_radius=0.027,
        down_sample=0.001, eps=0.025, min_samples=100,
        cluster_merge_distance=0.04, minimum_size_factor=0.3, gt_count=291,
    )


def _fuji(name, radius):
    # Fuji_* (config_real.py:192-248): radius 0.025 unet / 0.03 sam
    return _p(
        name, template="apple", template_size=1.0,
        remove_outliers_nb_points=50, remove_outliers_radius=radius,
        down_sample=0.001, eps=0.02, min_samples=100,
        cluster_merge_distance=0.04, minimum_size_factor=0.2, gt_count=1455,
    )


REAL_PROFILES = {
    "tree_01_sam": _tree01("tree_01_sam"),
    "tree_01_sam_big": _tree01("tree_01_sam_big"),
    "tree_01_unet": _tree01("tree_01_unet"),
    "tree_01_unet_big": _tree01("tree_01_unet_big"),
    "tree_02_sam": _tree02("tree_02_sam", 65),
    "tree_02_sam_big": _tree02("tree_02_sam_big", 70),
    "tree_02_unet": _tree02("tree_02_unet", 50),
    "tree_02_unet_big": _tree02("tree_02_unet_big", 50),
    "tree_03_sam": _tree03("tree_03_sam"),
    "tree_03_sam_big": _tree03("tree_03_sam_big"),
    "tree_03_unet": _tree03("tree_03_unet"),
    "tree_03_unet_big": _tree03("tree_03_unet_big"),
    "fuji_sam": _fuji("fuji_sam", 0.03),
    "fuji_sam_big": _fuji("fuji_sam_big", 0.03),
    "fuji_unet": _fuji("fuji_unet", 0.025),
    "fuji_unet_big": _fuji("fuji_unet_big", 0.025),
}

# legacy aliases from round 1 (one row per tree + fuji)
REAL_PROFILES["tree_01"] = REAL_PROFILES["tree_01_sam"]
REAL_PROFILES["tree_02"] = REAL_PROFILES["tree_02_sam"]
REAL_PROFILES["tree_03"] = REAL_PROFILES["tree_03_unet"]
REAL_PROFILES["fuji"] = REAL_PROFILES["fuji_unet"]

ALL_PROFILES = {**SYNTHETIC_PROFILES, **REAL_PROFILES}
