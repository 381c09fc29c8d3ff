"""Skeleton sequence visualization: per-frame 3D plots, GIFs, strips.

Parity with reference ``utils/visualization.py:17-233``: per-dataset bone
lists over the FULL skeletons (h36m 32 joints / cmu 38 / 3dpw 24), input
frames black, predicted frames blue, GIF + strip PNG output, and a
prediction-vs-ground-truth overlay.  Matplotlib/imageio are imported lazily
so headless compute environments don't pay for them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["Visualizer", "BONES", "plot_expmap_multi"]

# Ax3DPoseMulti's 16-bone H36M subset with left/right indicators
# (reference utils/visualization.py:376-379)
_MULTI_I = np.array([1, 2, 3, 1, 7, 8, 1, 13, 14, 15, 14, 18, 19, 14, 26,
                     27]) - 1
_MULTI_J = np.array([2, 3, 4, 7, 8, 9, 13, 14, 15, 16, 18, 19, 20, 26, 27,
                     28]) - 1
_MULTI_LR = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1], bool)

# bone lists in full-skeleton joint indices (reference
# utils/visualization.py:19-56)
BONES = {
    "h36m": [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 6), (6, 7), (7, 8),
             (8, 9), (9, 10), (0, 11), (11, 12), (12, 13), (13, 14),
             (14, 15), (12, 16), (16, 17), (17, 18), (18, 19), (19, 20),
             (20, 21), (19, 22), (22, 23), (12, 24), (24, 25), (25, 26),
             (26, 27), (27, 28), (28, 29), (27, 30), (30, 31)],
    "cmu": [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (0, 7), (7, 8),
            (8, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14),
            (14, 15), (15, 16), (16, 17), (17, 18), (18, 19), (15, 20),
            (20, 21), (21, 22), (22, 23), (23, 24), (24, 25), (25, 26),
            (23, 27), (27, 28), (15, 29), (29, 30), (30, 31), (31, 32),
            (32, 33), (33, 34), (34, 35), (32, 36), (36, 37)],
    "3dpw": [(0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8),
             (6, 9), (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15),
             (13, 16), (14, 17), (16, 18), (17, 19), (18, 20), (19, 21),
             (20, 22), (21, 23)],
}


def _plotting():
    """(imageio.v2, matplotlib.pyplot) for the visualize modes; a clear
    error when either package is missing (they are not needed anywhere
    else)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import imageio.v2 as imageio
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "the visualize modes need matplotlib and imageio, which are "
            f"not installed ({e})") from e
    return imageio, plt


class Visualizer:
    """Render flat (T, V*3) sequences into frame PNGs, a GIF and a strip."""

    def __init__(self, dataset: str = "h36m"):
        key = {"pw3d": "3dpw"}.get(dataset, dataset)
        if key not in BONES:
            key = "h36m"
        self.bones = BONES[key]

    def _plot_frame(self, ax, frame: np.ndarray, color: str):
        pts = frame.reshape(-1, 3)
        for a, b in self.bones:
            if a < len(pts) and b < len(pts):
                ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                        [pts[a, 2], pts[b, 2]], lw=2, color=color)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, c=color)

    def _setup_ax(self, ax, seq: np.ndarray):
        pts = seq.reshape(-1, 3)
        c = pts.mean(0)
        r = max(np.abs(pts - c).max(), 1e-6)
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(c[2] - r, c[2] + r)
        ax.axis("off")

    def plot_single(self, seq: np.ndarray, save_dir: str, title: str,
                    input_n: int = 10, stride: int = 1) -> Optional[str]:
        """Frame-by-frame render -> GIF + horizontal strip PNG.

        Input frames black, predicted frames blue (reference
        utils/visualization.py:73-146)."""
        imageio, plt = _plotting()
        os.makedirs(save_dir, exist_ok=True)
        t = seq.shape[0]
        frames = []
        for i in range(0, t, stride):
            fig = plt.figure(figsize=(3, 3))
            ax = fig.add_subplot(111, projection="3d")
            self._setup_ax(ax, seq)
            self._plot_frame(ax, seq[i], "k" if i < input_n else "b")
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            frames.append(buf.copy())
            plt.close(fig)
        gif = os.path.join(save_dir, f"{title}.gif")
        imageio.mimsave(gif, frames, duration=0.08)
        strip = np.concatenate(frames[:: max(t // 10, 1)], axis=1)
        imageio.imwrite(os.path.join(save_dir, f"{title}.png"), strip)
        return gif

    def plot_multi(self, pred: np.ndarray, target: np.ndarray, save_dir: str,
                   title: str) -> Optional[str]:
        """Prediction (blue) vs ground truth (red) overlay GIF (reference
        utils/visualization.py:148-233)."""
        imageio, plt = _plotting()
        os.makedirs(save_dir, exist_ok=True)
        frames = []
        for i in range(pred.shape[0]):
            fig = plt.figure(figsize=(3, 3))
            ax = fig.add_subplot(111, projection="3d")
            self._setup_ax(ax, target)
            self._plot_frame(ax, target[i], "r")
            self._plot_frame(ax, pred[i], "b")
            fig.canvas.draw()
            frames.append(
                np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
            plt.close(fig)
        gif = os.path.join(save_dir, f"{title}.gif")
        imageio.mimsave(gif, frames, duration=0.08)
        return gif


def plot_expmap_multi(expmap_gt: np.ndarray, expmap_pred: np.ndarray,
                      save_dir: str, title: str) -> Optional[str]:
    """GT-vs-prediction overlay animation from EXPMAP (angle-space)
    sequences — headless port of the reference's interactive
    ``Ax3DPoseMulti`` / ``plot_predictions_multi``
    (utils/visualization.py:363-509): each frame runs forward kinematics,
    draws GT in greys (dashed) and the prediction in the reference's
    purple/green left/right colours over the 16-bone subset, with
    root-centred fixed-radius limits; frames are written to a GIF instead
    of plt.pause animation (training hosts are headless).

    ``expmap_gt`` / ``expmap_pred``: (T, 99) H36M expmap channel vectors.
    """
    imageio, plt = _plotting()
    from ..data.kinematics import expmap_to_xyz

    xyz_gt = expmap_to_xyz(np.asarray(expmap_gt, np.float32))
    xyz_pred = expmap_to_xyz(np.asarray(expmap_pred, np.float32))
    os.makedirs(save_dir, exist_ok=True)
    frames = []
    r = 1000.0                      # fixed radius (reference :480)
    for i in range(xyz_pred.shape[0]):
        fig = plt.figure(figsize=(3, 3))
        ax = fig.add_subplot(111, projection="3d")
        root = xyz_gt[i, 0]
        ax.set_xlim(root[0] - r, root[0] + r)
        ax.set_ylim(root[1] - r, root[1] + r)
        ax.set_zlim(root[2] - r, root[2] + r)
        ax.axis("off")
        for pts, (lc, rc), style in (
                (xyz_gt[i], ("#8e8e8e", "#383838"), "--"),
                (xyz_pred[i], ("#9b59b6", "#2ecc71"), "-")):
            for bi in range(len(_MULTI_I)):
                a, b = _MULTI_I[bi], _MULTI_J[bi]
                ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                        [pts[a, 2], pts[b, 2]], lw=2, linestyle=style,
                        color=lc if _MULTI_LR[bi] else rc)
        ax.set_title(f"{title} frame:{i + 1}", loc="left", fontsize=7)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
        plt.close(fig)
    gif = os.path.join(save_dir, f"{title}.gif")
    imageio.mimsave(gif, frames, duration=0.05)
    return gif
