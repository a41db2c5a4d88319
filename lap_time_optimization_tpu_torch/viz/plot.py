"""Static track/path figures of the racing-line pipeline — port of
`lap_time_optimization_tpu/viz/plot.py` (reference src/plot.py).

The same three figures (solid path, corner mask, velocity gradient) with
the same visual constants, so the images compare side by side.  The
inputs are numpy arrays (or anything `np.asarray` takes: CPU tensors are
copied off the device by the caller).  matplotlib is imported inside the
plotting functions only: a machine without it can import this module and
run everything but the plots.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

# The reference's visual constants: boundary colour/linewidth
# src/plot.py:12-13,26-29; save resolution src/plot.py:16; path colour
# src/plot.py:30; corner colormap + [0, 1.5] normalisation src/plot.py:55-57;
# velocity colormap "inferno" on the 10-40 m/s band src/plot.py:78-80;
# colorbar geometry src/plot.py:83-85.
STYLE = {
    "boundary": dict(color="tab:gray", linestyle="solid", linewidth=1),
    "racing_line": dict(color="tab:green", linestyle="solid"),
    "control_marker": dict(color="tab:green", marker="."),
    "cone_markers": (dict(color="tab:blue", marker="."), dict(color="tab:orange", marker=".")),
    "corner_mask": dict(cmap="Greens", vmin=0.0, vmax=1.5, linewidth=4),
    "velocity": dict(cmap="inferno", vmin=10.0, vmax=40.0, linewidth=2),
    "colorbar": dict(orientation="horizontal", label="Velocity (m/s)", pad=0.05, aspect=30),
    "dpi": 500,
}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rc("font", family="serif")
    return plt


@contextmanager
def track_figure(dest, left, right, *, boundary_zorder=None):
    """Yield an axes with both track boundaries drawn, then save and close:
    grey boundaries, equal aspect, no axes, tight box at the parity DPI."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    try:
        extra = {} if boundary_zorder is None else {"zorder": boundary_zorder}
        for boundary in (left, right):
            xy = np.asarray(boundary)
            ax.plot(xy[0], xy[1], **STYLE["boundary"], **extra)
        yield ax
        ax.set_aspect("equal", adjustable="box")
        ax.set_axis_off()
        fig.savefig(dest, bbox_inches="tight", dpi=STYLE["dpi"])
    finally:
        plt.close(fig)


def gradient_polyline(ax, samples, values, style_key):
    """A polyline (2, n) whose segments are coloured by `values` on the
    colormap of `STYLE[style_key]`."""
    from matplotlib.collections import LineCollection

    plt = _pyplot()
    pts = np.asarray(samples).T[:, None, :]
    spec = STYLE[style_key]
    lc = LineCollection(
        np.concatenate([pts[:-1], pts[1:]], axis=1),
        array=np.asarray(values, dtype=float),
        cmap=spec["cmap"],
        norm=plt.Normalize(spec["vmin"], spec["vmax"]),
        linewidth=spec["linewidth"],
        zorder=2,
    )
    ax.add_collection(lc)
    return lc


def plot_path(dest, left, right, samples, control=None, show_cones=False):
    """Boundaries + solid racing line, optionally with control points/cones."""
    samples = np.asarray(samples)
    with track_figure(dest, left, right, boundary_zorder=1) as ax:
        ax.plot(samples[0], samples[1], zorder=2, **STYLE["racing_line"])
        if control is not None:
            control = np.asarray(control)
            ax.scatter(control[0], control[1], **STYLE["control_marker"])
        if show_cones:
            for xy, marker in zip((left, right), STYLE["cone_markers"]):
                xy = np.asarray(xy)
                ax.scatter(xy[0], xy[1], **marker)


def plot_corners(dest, left, right, samples, is_corner):
    """Path coloured by the boolean corner mask (straights pale, corners green)."""
    with track_figure(dest, left, right) as ax:
        gradient_polyline(ax, samples, is_corner, "corner_mask")


def plot_trajectory(dest, left, right, samples, velocities):
    """Path coloured by speed on the fixed 10-40 m/s inferno scale + colorbar."""
    with track_figure(dest, left, right, boundary_zorder=1) as ax:
        lc = gradient_polyline(ax, samples, velocities, "velocity")
        ax.figure.colorbar(lc, **STYLE["colorbar"])
