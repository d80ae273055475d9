"""Dataset-wide plots (the JAX package's ``viz/dataset_plots.py``).

Per-trace analysis figures (top view with a height colormap and collider
rectangles, 3D trajectory, height profile with its mean and sigma band,
speed profile, height histogram, stats panel), an all-traces overview grid
and an agent-vs-human comparison figure with a printed analysis. numpy and
matplotlib only: no tensor work, so no ``--device``.

    python -m room_slam_torch.viz.dataset_plots --data_dir DIR \
        [--out_dir plots] [--compare] [--per_trace]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from room_slam_torch.config import BENCH_ID_TO_LABEL
from room_slam_torch.data import formats
from room_slam_torch.viz import pyplot, rectangle

if TYPE_CHECKING:
    from matplotlib.figure import Figure


def _speed(arr: np.ndarray) -> np.ndarray:
    """Instantaneous speed per point [N] from (x, y, z, t)."""
    if arr.shape[0] < 2:
        return np.zeros(arr.shape[0])
    d = np.diff(arr[:, :3], axis=0)
    dt = np.clip(np.diff(arr[:, 3]), 1e-3, None)
    v = np.linalg.norm(d, axis=1) / dt
    return np.concatenate([[0.0], v])


def _draw_colliders(ax, boxes: np.ndarray, labels: np.ndarray) -> None:
    for b, l in zip(boxes, labels):
        ax.add_patch(rectangle(
            (b[0] - b[3] / 2, b[2] - b[5] / 2), b[3], b[5],
            ec="red", fc="red", alpha=0.2, lw=1.5))
        ax.text(b[0], b[2], BENCH_ID_TO_LABEL.get(int(l), "?"),
                color="red", fontsize=7, ha="center", va="center")


def plot_trace_analysis(
    arr: np.ndarray,
    name: str,
    boxes: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
) -> "Figure":
    """Six-panel per-trace analysis."""
    fig = pyplot().figure(figsize=(18, 10))
    t = arr[:, 3] - arr[0, 3] if arr.shape[0] else arr[:, 3]
    speed = _speed(arr)

    ax = fig.add_subplot(2, 3, 1)
    sc = ax.scatter(arr[:, 0], arr[:, 2], c=arr[:, 1], s=1, cmap="viridis")
    if boxes is not None:
        _draw_colliders(ax, boxes, labels)
    fig.colorbar(sc, ax=ax, label="height y [m]")
    ax.set_title("Top view (X-Z), height colormap")
    ax.set_aspect("equal")

    ax = fig.add_subplot(2, 3, 2, projection="3d")
    ax.plot(arr[:, 0], arr[:, 2], arr[:, 1], lw=0.4, alpha=0.7)
    ax.set_title("3D trajectory")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")

    ax = fig.add_subplot(2, 3, 3)
    ax.plot(t, arr[:, 1], lw=0.5)
    mu, sd = arr[:, 1].mean(), arr[:, 1].std()
    ax.axhline(mu, color="orange", label=f"mean {mu:.3f}")
    ax.axhspan(mu - sd, mu + sd, color="orange", alpha=0.2,
               label=f"±sigma {sd:.3f}")
    ax.set_title("Height profile")
    ax.set_xlabel("t [s]")
    ax.legend(fontsize=7)

    ax = fig.add_subplot(2, 3, 4)
    ax.plot(t, speed, lw=0.4)
    ax.set_ylim(0, np.percentile(speed, 99.5) * 1.2 + 1e-3)
    ax.set_title("Speed profile")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("m/s")

    ax = fig.add_subplot(2, 3, 5)
    ax.hist(arr[:, 1], bins=50, color="teal", alpha=0.8)
    ax.set_title("Height distribution")

    ax = fig.add_subplot(2, 3, 6)
    ax.axis("off")
    stats = (
        f"{name}\n\n"
        f"points: {arr.shape[0]}\n"
        f"duration: {t[-1] - t[0]:.1f} s\n"
        f"x range: [{arr[:, 0].min():.2f}, {arr[:, 0].max():.2f}]\n"
        f"z range: [{arr[:, 2].min():.2f}, {arr[:, 2].max():.2f}]\n"
        f"height: {mu:.3f} ± {sd:.3f}\n"
        f"mean speed: {speed.mean():.3f} m/s\n"
        f"path length: "
        f"{np.linalg.norm(np.diff(arr[:, :3], axis=0), axis=1).sum():.1f} m"
    )
    ax.text(0.02, 0.95, stats, va="top", family="monospace", fontsize=10)
    fig.suptitle(f"Trace analysis — {name}")
    fig.tight_layout()
    return fig


def plot_overview(traces: Dict[str, np.ndarray],
                  boxes: Optional[np.ndarray] = None,
                  labels: Optional[np.ndarray] = None) -> "Figure":
    """All-traces top-view grid."""
    plt = pyplot()
    n = len(traces)
    cols = min(4, max(n, 1))
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 5 * rows),
                             squeeze=False)
    for ax, (name, arr) in zip(axes.flat, traces.items()):
        ax.plot(arr[:, 0], arr[:, 2], lw=0.4, alpha=0.8)
        if boxes is not None:
            _draw_colliders(ax, boxes, labels)
        ax.set_title(name, fontsize=8)
        ax.set_aspect("equal")
    for ax in axes.flat[n:]:
        ax.axis("off")
    fig.suptitle("All traces — top view")
    fig.tight_layout()
    return fig


def plot_agent_vs_human(traces: Dict[str, np.ndarray]) -> "Figure":
    """Agent-vs-human comparison: traces grouped by file name prefix
    (``agent*`` / ``human*``), their top views, heights, durations and
    speeds; prints the analysis."""
    plt = pyplot()
    agent = {k: v for k, v in traces.items() if k.startswith("agent")}
    human = {k: v for k, v in traces.items() if k.startswith("human")}

    fig, axes = plt.subplots(3, 4, figsize=(22, 14))

    for ax, group, title, color in (
            (axes[0, 0], agent, "Agent top views", "tab:blue"),
            (axes[0, 1], human, "Human top views", "tab:orange")):
        for arr in group.values():
            ax.plot(arr[:, 0], arr[:, 2], lw=0.4, alpha=0.7, color=color)
        ax.set_title(title)
        ax.set_aspect("equal")

    ax = axes[0, 2]
    for name, group, color in (("agent", agent, "tab:blue"),
                               ("human", human, "tab:orange")):
        ys = np.concatenate([a[:, 1] for a in group.values()]) if group \
            else np.zeros(1)
        ax.hist(ys, bins=60, alpha=0.6, label=name, color=color,
                density=True)
    ax.set_title("Height histogram")
    ax.legend()

    ax = axes[0, 3]
    for i, (name, group, color) in enumerate(
            (("agent", agent, "tab:blue"), ("human", human, "tab:orange"))):
        for j, arr in enumerate(group.values()):
            ax.errorbar([i + j * 0.05], [arr[:, 1].mean()],
                        yerr=[arr[:, 1].std()], fmt="o", color=color)
    ax.set_xticks([0, 1], ["agent", "human"])
    ax.set_title("Height mean ± sigma per trace")

    for col, (gname, group, color) in enumerate(
            (("agent", agent, "tab:blue"), ("human", human, "tab:orange"))):
        ax = axes[1, col]
        for arr in group.values():
            t = arr[:, 3] - arr[0, 3]
            ax.plot(t, arr[:, 1], lw=0.4, alpha=0.7, color=color)
        ax.set_title(f"{gname} height profiles")
        ax.set_xlabel("t [s]")

    ax = axes[1, 2]
    for name, group, color in (("agent", agent, "tab:blue"),
                               ("human", human, "tab:orange")):
        for arr in group.values():
            dur = arr[-1, 3] - arr[0, 3] if arr.shape[0] else 0
            ax.scatter(dur, arr.shape[0], color=color, label=name)
    handles, labels_ = ax.get_legend_handles_labels()
    uniq = dict(zip(labels_, handles))
    ax.legend(uniq.values(), uniq.keys())
    ax.set_xlabel("duration [s]")
    ax.set_ylabel("points")
    ax.set_title("Duration vs points (sampling rate)")

    ax = axes[1, 3]
    for name, group, color in (("agent", agent, "tab:blue"),
                               ("human", human, "tab:orange")):
        sp = np.concatenate([_speed(a) for a in group.values()]) if group \
            else np.zeros(1)
        ax.hist(np.clip(sp, 0, 5), bins=60, alpha=0.6, label=name,
                color=color, density=True)
    ax.set_title("Speed histogram")
    ax.legend()

    ax3d = fig.add_subplot(3, 4, 9, projection="3d")
    for group, color in ((agent, "tab:blue"), (human, "tab:orange")):
        for arr in group.values():
            ax3d.plot(arr[:, 0], arr[:, 2], arr[:, 1], lw=0.3, alpha=0.6,
                      color=color)
    axes[2, 0].axis("off")
    ax3d.set_title("3D trajectories")

    ax = axes[2, 1]
    ax.axis("off")
    lines = ["group    traces  pts(total)  height(mean±sd)  speed(mean)"]
    for name, group in (("agent", agent), ("human", human)):
        if not group:
            continue
        ys = np.concatenate([a[:, 1] for a in group.values()])
        sp = np.concatenate([_speed(a) for a in group.values()])
        lines.append(
            f"{name:8s} {len(group):6d}  {sum(a.shape[0] for a in group.values()):10d}"
            f"  {ys.mean():+.3f}±{ys.std():.3f}     {sp.mean():.3f} m/s")
    ax.text(0.0, 0.9, "\n".join(lines), family="monospace", fontsize=9,
            va="top")
    axes[2, 2].axis("off")
    axes[2, 3].axis("off")

    print("\n=== Agent vs Human analysis ===")
    for name, group in (("agent", agent), ("human", human)):
        if not group:
            continue
        ys = np.concatenate([a[:, 1] for a in group.values()])
        print(f"{name}: {len(group)} traces, height "
              f"{ys.mean():+.3f} ± {ys.std():.3f} "
              f"({'constant sensor height' if ys.std() < 0.02 else 'natural head bob'})")

    fig.suptitle("Agent vs Human traces")
    fig.tight_layout()
    return fig


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, default="plots")
    p.add_argument("--compare", action="store_true",
                   help="also render the agent-vs-human comparison")
    p.add_argument("--per_trace", action="store_true",
                   help="render the 6-panel analysis for every trace")
    args = p.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pairs = formats.find_data_pairs(args.data_dir)
    if not pairs:
        raise SystemExit(f"no trace/collider pairs in {args.data_dir}")

    traces = {t.stem: formats.sort_by_time(formats.load_trace_json(t))
              for t, _ in pairs}
    boxes, labels = formats.load_colliders_json(pairs[0][1])

    plt = pyplot()
    fig = plot_overview(traces, boxes, labels)
    fig.savefig(out / "overview.png", dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {out / 'overview.png'}")

    if args.per_trace:
        for name, arr in traces.items():
            fig = plot_trace_analysis(arr, name, boxes, labels)
            fig.savefig(out / f"analysis_{name}.png", dpi=110,
                        bbox_inches="tight")
            plt.close(fig)
            print(f"saved {out / f'analysis_{name}.png'}")

    if args.compare:
        fig = plot_agent_vs_human(traces)
        fig.savefig(out / "agent_vs_human.png", dpi=110,
                    bbox_inches="tight")
        plt.close(fig)
        print(f"saved {out / 'agent_vs_human.png'}")


if __name__ == "__main__":
    main()
