"""Process-group start-up, meshes, and the collectives of the sharded paths.

Port of `lap_time_optimization_tpu/parallel/distributed.py` onto
`torch.distributed`.  A run of N processes (one per GPU, e.g. started by
`torchrun --nproc-per-node N`) calls `initialize()`, which reads torchrun's
environment (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`), and then builds a ('dp', 'sp') `DeviceMesh` over all ranks
with `global_mesh`.  The backend follows the device, explicitly: NCCL for
"cuda", gloo for "cpu"; a CUDA mesh never runs on gloo.  Importing this
module starts nothing.

The sharded paths are SPMD in the style of `shard_map`: every rank runs
the same program on its own rows with plain tensors, and the collectives
below move what crosses ranks.  `mesh=None` stands for one process with no
process group: the axis has one rank and nothing is communicated.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "sp")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process-group backend of a device type: NCCL for "cuda", gloo
    for "cpu"."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return _BACKENDS[kind]


def local_init_method() -> str:
    """`tcp://localhost:<port>` on a port that was free when asked: the
    address of a process group whose ranks all run on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device: str = "cuda") -> None:
    """Start the default process group when running multi-process.

    Does nothing with one process and no address (the single-device case),
    as the JAX package's `initialize` does.  Arguments default to torchrun's
    environment: `WORLD_SIZE`, `RANK`, and `init_method="env://"`, which
    reads `MASTER_ADDR`/`MASTER_PORT`.  With device="cuda" the process takes
    GPU `LOCAL_RANK` (default: its rank) modulo the GPUs it sees."""
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend} for {device!r}")
        return
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' needs a CUDA device (NCCL); pass device='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank)


def mesh_over(n: int, sp: int, device) -> DeviceMesh:
    """A ('dp', 'sp') mesh over ranks 0..n-1 of the default group, sp ranks
    per dp row (sp falls back to 1 where it does not divide n, as the JAX
    package's meshes do).  Every rank of the group must call it; a rank
    outside the mesh gets one it is not in."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize(...) first "
                           "(for one process: initialize(local_init_method(), 1, 0, device))")
    kind = torch.device(device).type
    if dist.get_backend() != backend_for(kind):
        raise RuntimeError(f"a {kind} mesh needs the {backend_for(kind)} backend; "
                           f"the process group runs {dist.get_backend()}")
    sp = sp if sp > 0 and n % sp == 0 else 1
    return DeviceMesh(kind, torch.arange(n).reshape(n // sp, sp), mesh_dim_names=AXES)


def global_mesh(sp: int = 1, device: str = "cuda") -> DeviceMesh:
    """('dp', 'sp') mesh over every rank of the default group."""
    return mesh_over(dist.get_world_size() if dist.is_initialized() else 1, sp, device)


# ------------------------------------------------------------- collectives
def axis(mesh: DeviceMesh | None, name: str):
    """(process group, size, this rank's index) of mesh axis `name`;
    (None, 1, 0) without a mesh.  Raises on a rank outside the mesh."""
    if mesh is None:
        return None, 1, 0
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in rank order; x[None] without a
    group."""
    if group is None:
        return x[None]
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The x of the previous rank of the group's ring (rank j receives rank
    j-1's, rank 0 the last rank's), by one send and one receive per rank;
    x itself on a ring of one."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x.clone()
    j = dist.get_rank(group)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (j + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (j - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def shard_rows(mesh: DeviceMesh | None, x: torch.Tensor, pad: bool = False) -> torch.Tensor:
    """This rank's block of x's rows on the mesh's 'dp' axis.  The dp axis
    must divide the rows, unless `pad`: then the last row is repeated up
    to the next multiple first (`gather_rows(..., n)` trims it again)."""
    _, n_dp, i = axis(mesh, "dp")
    rows = x.shape[0]
    if rows % n_dp:
        if not pad:
            raise ValueError(f"the dp axis {n_dp} must divide the batch {rows}")
        x = torch.cat([x, x[-1:].expand((n_dp - rows % n_dp,) + x.shape[1:])])
    m = x.shape[0] // n_dp
    return x[i * m:(i + 1) * m]


def gather_rows(mesh: DeviceMesh | None, x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Every dp rank's block of rows, concatenated in rank order (the
    inverse of `shard_rows`), trimmed to the first n rows."""
    group, _, _ = axis(mesh, "dp")
    out = all_gather(x, group)
    out = out.reshape((-1,) + x.shape[1:])
    return out if n is None else out[:n]
