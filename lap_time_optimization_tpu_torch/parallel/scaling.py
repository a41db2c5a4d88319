"""Weak scaling of the batched search over the ranks of a process group.

Port of `lap_time_optimization_tpu/parallel/scaling.py`: the same
`mesh.search_step` timed on sub-meshes of the first 1, 2, 4, … ranks of
the world, the batch growing with the ranks (batch_per_device per rank), so
perfect scaling keeps the time per round constant.  Each entry reports
candidate evaluations per second, seconds per round and the efficiency
against linear scaling from the first entry.

Every rank of the world calls `measure`; ranks outside a sub-mesh wait at
a barrier while it runs, and every rank returns rank 0's results.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from lap_time_optimization_tpu_torch.parallel import mesh as pmesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(track, vehicle, device_counts=(1, 2, 4, 8), batch_per_device: int = 64,
            rounds: int = 3, seed: int = 0, solver: str = "scan") -> dict:
    """{n_ranks: {"evals_per_s", "sec_per_round", "efficiency"}} for weak
    scaling on the track's device, over the counts the world holds.  Needs
    an initialised process group (`distributed.initialize`)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    device = track.left.device
    results, base_rate = {}, None
    for nd in device_counts:
        if nd > world:
            continue
        mesh = pmesh.make_mesh(nd, sp=1, device=device.type)
        if rank < nd:
            B = batch_per_device * nd
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            alphas = torch.rand((B, track.size), generator=gen, dtype=track.left.dtype, device=device)
            a = pmesh.search_step(track, vehicle, alphas, gen, 0.1, solver=solver, mesh=mesh)[0]  # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(rounds):
                a = pmesh.search_step(track, vehicle, a, gen, 0.1, solver=solver, mesh=mesh)[0]
            _sync(device)
            dt = (time.perf_counter() - t0) / rounds
            rate = B / dt
            if base_rate is None:
                base_rate = rate / nd  # per-rank baseline from the first entry
            results[nd] = {"evals_per_s": rate, "sec_per_round": dt,
                           "efficiency": rate / (base_rate * nd)}
        dist.barrier()
    shared = [results]
    dist.broadcast_object_list(shared, src=0)
    return shared[0]


def report(results: dict) -> str:
    lines = ["devices  evals/s   sec/round  efficiency"]
    for nd, r in sorted(results.items()):
        lines.append(f"{nd:7d}  {r['evals_per_s']:8.1f}  {r['sec_per_round']:9.4f}  {r['efficiency']:.2%}")
    return "\n".join(lines)
