"""Visualization & diagnostics (copy of slide_slam_tpu/viz.py).

Replaces the reference's RViz marker pipeline (viz/vizTools.cpp: trajectory
lines, bottom-anchored label-colored cylinders, cuboid wireframes, centroid
landmarks) with matplotlib renderings of the same content, plus a live text
status line. matplotlib is imported inside the functions (the package
imports without it), and the nodes hand over host arrays
(`compact_map()`, `trajectory_of()`): no tensor reaches matplotlib.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

LABEL_COLORS = {
    1: "tab:gray",     # ground / chair (indoor)
    2: "tab:purple",   # table
    5: "tab:blue",     # car
    8: "tab:green",    # tree
    9: "tab:orange",   # lightpole
}


def _color(label: int) -> str:
    return LABEL_COLORS.get(int(label), "tab:red")


def plot_map(ax, compact_map: np.ndarray, alpha=0.8):
    """Vector7d rows -> scatter with class colors + dimension glyphs."""
    for row in np.asarray(compact_map):
        label, x, y, z, d1, d2, d3 = row
        c = _color(label)
        if d2 == 0 and d3 == 0:       # cylinder: circle of radius d1
            circ = __import__("matplotlib.patches", fromlist=["Circle"]).Circle(
                (x, y), max(d1, 0.1), color=c, alpha=alpha, fill=False, lw=1.2)
            ax.add_patch(circ)
        else:                          # cuboid/ellipsoid: box footprint
            rect = __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
                (x - d1 / 2, y - d2 / 2), d1, d2, color=c, alpha=alpha,
                fill=False, lw=1.0)
            ax.add_patch(rect)
        ax.plot([x], [y], ".", color=c, ms=2)


def plot_trajectory(ax, traj: np.ndarray, color="k", label=None, lw=1.5):
    t = traj[:, 4:7] if traj.shape[1] == 7 else traj
    ax.plot(t[:, 0], t[:, 1], "-", color=color, lw=lw, label=label)
    if len(t):
        ax.plot(t[0, 0], t[0, 1], "^", color=color, ms=8)
        ax.plot(t[-1, 0], t[-1, 1], "s", color=color, ms=6)


def render_mission(nodes, truths: Optional[Dict[int, np.ndarray]] = None,
                   out_path: str = "mission.png"):
    """One figure per robot: optimized trajectory + merged map (+truth)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(nodes)
    fig, axes = plt.subplots(1, n, figsize=(7 * n, 7), squeeze=False)
    colors = ["tab:blue", "tab:red", "tab:green", "tab:orange", "tab:purple"]
    for i, node in enumerate(nodes):
        ax = axes[0][i]
        plot_map(ax, node.compact_map())
        for rid in range(node.cfg.number_of_robots):
            traj = node.trajectory_of(rid)
            if len(traj):
                plot_trajectory(ax, traj, color=colors[rid % len(colors)],
                                label=f"robot {rid}")
        if truths and node.robot_id in truths:
            plot_trajectory(ax, truths[node.robot_id], color="k", lw=0.8,
                            label="truth")
        ax.set_title(f"robot {node.robot_id}: "
                     f"{sum(node.landmark_counts().values())} landmarks, "
                     f"{len(node.key_poses)} keyframes")
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def render_matched_maps(reference_map: np.ndarray, query_map: np.ndarray,
                        tf4: np.ndarray, ref_pairs: Optional[np.ndarray] = None,
                        det_pairs: Optional[np.ndarray] = None,
                        path: Optional[str] = None):
    """Place-recognition match visualization (the reference publishes the
    matched-pair marker arrays from PlaceRecognition,
    place_recognition.cpp:970-1110): the reference map, the query map
    transformed by the recovered TF overlaid on it, and lines joining the
    matched (reference, detection) pairs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    plot_map(ax, reference_map, alpha=0.8)
    qry = np.asarray(query_map, np.float64).copy()
    R, t = np.asarray(tf4)[:3, :3], np.asarray(tf4)[:3, 3]
    qry[:, 1:4] = qry[:, 1:4] @ R.T + t
    for row in qry:
        ax.plot(row[1], row[2], "x", color=_color(row[0]), ms=6, mew=2)
    if ref_pairs is not None and det_pairs is not None:
        det = np.asarray(det_pairs, np.float64).copy()
        det[:, 1:4] = det[:, 1:4] @ R.T + t
        for r, d in zip(np.asarray(ref_pairs), det):
            ax.plot([r[1], d[1]], [r[2], d[2]], "-", color="0.4", lw=0.8)
    ax.set_aspect("equal")
    ax.set_title("place recognition match (o = reference, x = query @ TF)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def runtime_summary(node) -> str:
    """Status text mirroring the runtime-analysis fields."""
    def avg(xs):
        return float(np.mean(xs)) if xs else 0.0
    return (f"robot {node.robot_id}: kf={len(node.key_poses)} "
            f"da={1000*avg(node.data_association_time):.1f}ms "
            f"solve={1000*avg(node.fg_time):.1f}ms "
            f"intraLC {node.num_success_intra}/{node.num_attempts_intra} "
            f"interLC {node.num_success_inter}/{node.num_attempts_inter} "
            f"relF={node.num_rel_factors} "
            f"lm={node.landmark_counts()}")
