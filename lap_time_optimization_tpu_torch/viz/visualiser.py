"""Simulation replay: curvilinear states → Cartesian car positions, and plots.

Port of `lap_time_optimization_tpu/viz/visualiser.py` (reference
src/visualiser.py:9-74): the car's position is the path point at s plus
n along the normal, the body-frame velocity is rotated into the track
frame, and every 10th step gets a velocity arrow.  The reconstruction is
vectorised over all steps through `MPCTrack.position`; the plots are numpy
and matplotlib on the host, whatever device the track's tables are on.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lap_time_optimization_tpu_torch.mpc.track import MPCTrack


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _lookup(track: MPCTrack, fn, s: np.ndarray):
    """A track lookup at host arc lengths, returned on the host."""
    ref = track.s_grid
    out = fn(torch.as_tensor(s, dtype=ref.dtype, device=ref.device))
    return tuple(map(_host, out)) if isinstance(out, tuple) else _host(out)


def vehicle_positions(track: MPCTrack, states: np.ndarray):
    """states (n, 8) → (positions (n, 2), velocities (n, 2)) in the world
    frame (reference src/visualiser.py:37-67)."""
    states = np.asarray(states)
    s, n, mu, vx, vy = (states[:, i] for i in range(5))
    pts, tangents = _lookup(track, track.position, s)
    tan = tangents.T
    normal = np.stack([-tan[:, 1], tan[:, 0]], axis=1)
    positions = pts.T + n[:, None] * normal
    v_long = vx * np.cos(mu) - vy * np.sin(mu)
    v_lat = vx * np.sin(mu) + vy * np.cos(mu)
    velocities = v_long[:, None] * tan + v_lat[:, None] * normal
    return positions, velocities


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_replay(dest: str, track: MPCTrack, sim_results_path: str, quiver_every: int = 10):
    """Track, optimal path, simulated car positions and velocity arrows."""
    plt = _pyplot()
    with open(sim_results_path) as f:
        data = json.load(f)
    states = np.asarray(data["x"])[:, :, 0]
    positions, velocities = vehicle_positions(track, states)

    fig, ax = plt.subplots(figsize=(16, 9))
    fig.suptitle("Visualiser")
    ax.plot(*_host(track.path_xy), "g")
    ax.plot(*_host(track.left_xy), "black")
    ax.plot(*_host(track.right_xy), "black")
    for i in range(0, len(positions), quiver_every):
        ax.quiver(
            positions[i, 0], positions[i, 1], velocities[i, 0], velocities[i, 1],
            angles="xy", scale_units="xy", scale=1, color="blue",
        )
    ax.scatter(positions[:, 0], positions[:, 1], s=4)
    ax.set_aspect("equal", adjustable="box")
    fig.savefig(dest, bbox_inches="tight", dpi=200)
    plt.close(fig)
    return positions, velocities


def plot_internal(dest: str, track: MPCTrack, sim_results_path: str, dt: float = 0.1):
    """The states, inputs, slip angles and lateral forces over time (the
    reference's 9-panel results figure, src/mpc/simulator.py:22-57, and
    src/show_results.py:20-46), with k(s) on the s panel's twin axis."""
    plt = _pyplot()
    with open(sim_results_path) as f:
        data = json.load(f)
    states = np.asarray(data["x"])[:, :, 0]
    controls = np.asarray(data["u"])[:, :, 0]
    alphas = np.asarray(data["alpha"])
    fys = np.asarray(data["Fy"])
    t = np.arange(len(states)) * dt
    k = _lookup(track, track.curvature, states[:, 0])
    vref = _lookup(track, track.v_ref, states[:, 0])

    fig, axs = plt.subplots(3, 3, figsize=(16, 10))
    panels = [
        ("track position s [m]", [(states[:, 0], "s")]),
        ("lateral deviation n [m]", [(states[:, 1], "n")]),
        ("heading error mu [rad]", [(states[:, 2], "mu")]),
        ("velocities [m/s]", [(states[:, 3], "vx"), (states[:, 4], "vy"), (0.6 * vref, "0.6 vref")]),
        ("yaw rate r [rad/s]", [(states[:, 5], "r")]),
        ("steering / throttle", [(states[:, 6], "steering"), (states[:, 7], "throttle")]),
        ("inputs", [(controls[:, 0], "d steering"), (controls[:, 1], "d throttle")]),
        ("slip angles [rad]", [(alphas[:, 0], "front"), (alphas[:, 1], "rear")]),
        ("lateral forces [N]", [(fys[:, 0], "front"), (fys[:, 1], "rear")]),
    ]
    for ax, (title, series) in zip(axs.flat, panels):
        for y, label in series:
            ax.plot(t, y, label=label)
        ax.set_title(title)
        ax.set_xlabel("t [s]")
        if len(series) > 1:
            ax.legend(fontsize=8)
    ax2 = axs.flat[0].twinx()
    ax2.plot(t, k, color="tab:gray", alpha=0.5)
    ax2.set_ylabel("k(s)", color="tab:gray")
    fig.tight_layout()
    fig.savefig(dest, bbox_inches="tight", dpi=200)
    plt.close(fig)
