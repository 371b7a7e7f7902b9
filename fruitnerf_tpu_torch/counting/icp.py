"""Similarity registration: Umeyama closed form + scaled point-to-point ICP.

Replaces Open3D's ``registration_icp`` with scaling
(clustering_base.py:266-269) for template fitting during cluster splitting.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform src -> dst.

    Returns (scale s, rotation R [3,3], translation t [3]) minimizing
    ||dst - (s R src + t)||^2 (Umeyama 1991).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1.0
    rot = u @ s_mat @ vt
    if with_scale:
        var_s = (sc**2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s_mat) / max(var_s, 1e-12))
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    return scale, rot, t


def scaled_icp(
    src: np.ndarray,
    dst: np.ndarray,
    iterations: int = 20,
    with_scale: bool = True,
):
    """Fixed-iteration point-to-point ICP with per-step Umeyama similarity.

    Returns (transformed_src, (s, R, t) accumulated).
    """
    tree = cKDTree(dst)
    cur = src.copy()
    s_tot, r_tot, t_tot = 1.0, np.eye(3), np.zeros(3)
    for _ in range(iterations):
        _, idx = tree.query(cur, workers=-1)
        matched = dst[idx]
        s, r, t = umeyama(cur, matched, with_scale)
        cur = (s * (r @ cur.T)).T + t
        s_tot = s * s_tot
        r_tot = r @ r_tot
        t_tot = s * (r @ t_tot) + t
    return cur, (s_tot, r_tot, t_tot)
