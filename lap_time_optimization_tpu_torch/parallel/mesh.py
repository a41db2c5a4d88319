"""Mesh scale-out of the batched racing-line search on `torch.distributed`.

Port of `lap_time_optimization_tpu/parallel/mesh.py`.  A mesh is a
`DeviceMesh` with two axes (`make_mesh`, `distributed.global_mesh`):

* **dp**: the candidate batch; each rank evaluates its block of rows;
* **sp**: the sample axis of each candidate's velocity profile, genuinely
  block-sharded with explicit collectives in `search_step_dp_sp`
  (`sp_velocity`).  Elsewhere the sp ranks of one dp row repeat its work,
  as a computation replicated over sp does under the JAX package's meshes.

SPMD in the style of `shard_map`, with plain tensors and no DTensor: a
candidate batch is replicated on every rank, each rank evaluates its dp
block (`shard_batch`), one `all_gather` over dp gives every rank all the
lap times, and every rank draws the next batch from its own `torch.Generator`
seeded alike, so the batch stays replicated.  The collectives are the ones
`scaling.py` measures.  `mesh=None` is one process with no process group.

`solver` picks the velocity profile as in `optim/global_search.py`:
"scan" (sequential oracle) and "assoc" (log-depth) on the dense spline fit,
as the JAX package's `"scan"`/`"assoc"`; "fused", JAX's "pallas", runs
kernel 3 (`ops/velocity_batch.solve_profile_batch`) on the tridiag fit and
refuses a mesh of more than one rank, as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from lap_time_optimization_tpu_torch.ops import spline, velocity, velocity_batch
from lap_time_optimization_tpu_torch.parallel import distributed
from lap_time_optimization_tpu_torch.parallel.sp_velocity import _profile_sp_local

SOLVERS = ("scan", "assoc", "fused")


def make_mesh(n_devices: int | None = None, sp: int = 2, device: str = "cuda"):
    """('dp', 'sp') mesh over the first n_devices ranks of the default group
    (all of them by default); sp falls back to 1 where it does not divide
    them.  Every rank must call it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return distributed.mesh_over(min(n_devices or world, world), sp, device)


def shard_batch(mesh, alphas_batch: torch.Tensor) -> torch.Tensor:
    """This rank's dp block of a candidate batch (B, d) replicated on every
    rank; the dp axis must divide B."""
    return distributed.shard_rows(mesh, alphas_batch)


def _lap_times(track, vehicle, alphas: torch.Tensor, solver: str) -> torch.Tensor:
    """Lap times (C,) of alphas (C, size), unsharded."""
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")
    fused = solver == "fused"
    sp_ = track.path_spline(alphas, spline.FIT_METHOD_CLOSED_BATCHED if fused else None)
    s = spline.uniform_samples(sp_.length, track.ns)
    k = spline.curvature(sp_, s[..., :-1], signed=False)
    if fused:
        v = velocity_batch.solve_profile_batch(vehicle, s[..., :-1], k, sp_.length, track.closed)
    elif solver == "assoc":
        v = velocity.solve_profile_parallel(vehicle, s[..., :-1], k, sp_.length, track.closed)
    else:
        v = velocity.solve_profile(vehicle, s[..., :-1], k, sp_.length, track.closed)
    return velocity.lap_time(s, v)


@torch.no_grad()
def batch_lap_times(track, vehicle, alphas_batch: torch.Tensor, solver: str = "scan",
                    mesh=None) -> torch.Tensor:
    """Lap time (B,) of each candidate of alphas_batch (B, track.size), the
    batch dp-sharded over `mesh`: every rank returns all B."""
    if solver == "fused" and mesh is not None and mesh.size() > 1:
        raise ValueError(
            f"solver='fused' is the single-device production path; under a {mesh.size()}-rank "
            "mesh use solver='scan'/'assoc' (dp/sp shardable) or a search per device")
    return distributed.gather_rows(mesh, _lap_times(track, vehicle, shard_batch(mesh, alphas_batch), solver))


def _evolve(alphas, times, gen, sigma, elite: int):
    """Elite selection and Gaussian resampling, identical on every rank:
    (new batch with the incumbent in slot 0, best time, best alphas).  A
    batch smaller than `elite` draws its parents from all of its rows."""
    B, d = alphas.shape
    elite = min(elite, B)
    order = torch.argsort(times, stable=True)
    elites = alphas[order[:elite]]
    parents = elites[torch.randint(0, elite, (B,), generator=gen, device=alphas.device)]
    noise = torch.randn((B, d), generator=gen, dtype=alphas.dtype, device=alphas.device) * sigma
    new_batch = torch.clamp(parents + noise, 0.0, 1.0)
    new_batch[0] = elites[0]  # elitism
    return new_batch, times[order[0]], elites[0]


def search_step(track, vehicle, alphas_batch: torch.Tensor, gen: torch.Generator, sigma,
                elite: int = 8, solver: str = "scan", mesh=None):
    """One evolution-strategy round: evaluate the batch (dp-sharded), pick
    the `elite` best, and resample the batch as elites + Gaussian
    exploration (σ = sigma), clipped to [0, 1], the incumbent kept in slot 0.
    `gen` draws the parents and the noise (seeded alike on every rank).
    Returns (new batch, best time, best alphas)."""
    times = batch_lap_times(track, vehicle, alphas_batch, solver, mesh)
    return _evolve(alphas_batch, times, gen, sigma, elite)


def _device_of(module) -> torch.device:
    return next(iter(module.buffers())).device


def evolutionary_search(track, vehicle, mesh=None, batch: int = 512, rounds: int = 20,
                        sigma: float = 0.08, elite: int = 8, seed: int = 0, solver: str = "scan",
                        device: str = "cuda"):
    """Mesh-sharded global racing-line search over the full alphas.
    Returns (best alphas, best time per round).  Runs on the mesh's device
    (without a mesh, `device`: "cuda" unless the caller asks for "cpu"); a
    track or vehicle on another device raises."""
    kind = mesh.device_type if mesh is not None else torch.device(device).type
    for name, module in (("track", track), ("vehicle", vehicle)):
        if _device_of(module).type != kind:
            raise ValueError(f"the {name} lies on {_device_of(module)}, the search runs on {kind}")
    dev = track.left.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    alphas = torch.rand((batch, track.size), generator=gen, dtype=track.left.dtype, device=dev)
    best_hist, best_alphas = [], None
    for _ in range(rounds):
        alphas, t_best, best_alphas = search_step(track, vehicle, alphas, gen, sigma, elite, solver, mesh)
        best_hist.append(float(t_best))
        sigma = sigma * 0.9
    return best_alphas, np.asarray(best_hist)


# ------------------------------------------------------------- 2-axis dp × sp
@torch.no_grad()
def search_step_dp_sp(track, vehicle, alphas_batch: torch.Tensor, gen: torch.Generator, sigma,
                      mesh, elite: int = 8, sweeps: int = 24):
    """One evolution-strategy round sharded over both mesh axes at once: the
    batch over 'dp', and each candidate's profile sample axis block-sharded
    over 'sp' (`sp_velocity`: a ring halo and an all_gather of block
    summaries per sweep).  Matches `search_step(..., solver="scan")` up to
    the sweeps' fixpoint tolerance (rtol ~1e-9 at sweeps=24): the same
    dense fit, generator stream and elitism."""
    local = shard_batch(mesh, alphas_batch)  # raises unless dp divides the batch
    sp_group, _, _ = distributed.axis(mesh, "sp")
    sp_ = track.path_spline(local)
    s = spline.uniform_samples(sp_.length, track.ns)
    k = spline.curvature(sp_, s[..., :-1], signed=False)
    v = _profile_sp_local(vehicle, s[..., :-1], k, sp_.length, track.closed, sweeps, sp_group)
    times = distributed.gather_rows(mesh, velocity.lap_time(s, v))
    return _evolve(alphas_batch, times, gen, sigma, elite)
