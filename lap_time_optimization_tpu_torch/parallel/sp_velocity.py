"""Sequence-parallel velocity profile: the sample axis block-sharded over the
mesh's 'sp' ranks with explicit collectives.

Port of `lap_time_optimization_tpu/parallel/sp_velocity.py`.  The
quasi-static profile is a cyclic min-plus recurrence over the N samples of
a lap (`ops/velocity.py`).  Each directional pass runs `sweeps`
frozen-coefficient sweeps; in each sweep every rank holds one contiguous
block of the (rolled) samples, and

* the ring halo, each block's last v (and e = v²) from the previous rank,
  arrives by one send/receive around the sp ring (rank 0 receives the last
  rank's, which closes the lap into global element 0);
* each rank scans its block (`ops/velocity._minplus_scan` and the running
  sum of the gains), and one `all_gather` of the per-block summaries (c, B)
  gives every rank the composed maps of the blocks before it, hence its
  incoming value.

So a sweep costs two collectives instead of N serial steps.  The fixpoint
is the sequential solver's (the same Jacobi sweeps as
`solve_profile_parallel`); padding is transparent (local limit √1e30, zero
gain), and masked links (an open track's seam) get the gain 1e30, which
restarts the chain from the local limit.

The functions take a leading candidate axis: collectives cannot run
inside `torch.func.vmap`, so where the JAX package maps one candidate's
profile under `vmap`, here one call sweeps all of a rank's candidates.
"""

from __future__ import annotations

import torch

from lap_time_optimization_tpu_torch.ops import velocity
from lap_time_optimization_tpu_torch.parallel.distributed import all_gather, axis, ring_shift

_BIG = 1e30


def _block_sweep(vehicle, e, e_loc, k_prev, ds, chain_ok, valid0, accelerating: bool, group):
    """One frozen-coefficient sweep over this rank's blocks (C, blk) of C
    candidates; `valid0` (C,) says whether the closing link into global
    element 0 (the previous rank of rank 0 is the last one) may constrain
    it.  Returns the new e (C, blk)."""
    j = 0 if group is None else torch.distributed.get_rank(group)
    v = torch.sqrt(e)
    halo = ring_shift(torch.stack([v[:, -1], e[:, -1]], dim=-1), group)  # (C, 2)
    v_prev = torch.cat([halo[:, :1], v[:, :-1]], dim=-1)
    b = 2.0 * (velocity._force(vehicle, v_prev, k_prev, accelerating) / vehicle.mass) * ds
    b = torch.where(chain_ok > 0.5, b, torch.full_like(b, _BIG))
    c = e_loc
    if j == 0:  # the lap closes into global element 0
        link0 = torch.where(valid0, halo[:, 1] + b[:, 0], torch.full_like(b[:, 0], _BIG))
        c = torch.cat([torch.minimum(c[:, :1], link0[:, None]), c[:, 1:]], dim=-1)
    c_scan = velocity._minplus_scan(c, b)
    b_scan = torch.cumsum(b, dim=-1)
    summaries = all_gather(torch.stack([c_scan[:, -1], b_scan[:, -1]], dim=-1), group)  # (n_sp, C, 2)
    # the composed maps of the blocks before this one, applied to +inf
    # (element 0's own link is folded into c above)
    x_in = torch.full_like(c[:, 0], _BIG)
    for i in range(j):
        x_in = torch.minimum(summaries[i, :, 0], x_in + summaries[i, :, 1])
    return torch.minimum(e_loc, torch.minimum(c_scan, x_in[:, None] + b_scan))


def _run_pass_local(vehicle, v_loc, k_prev, ds, chain_ok, valid0, accelerating: bool,
                    sweeps: int, group):
    """One directional pass over full rows (C, n), replicated on the sp
    ranks: pad to the sp multiple, take this rank's block, run the sweeps,
    and gather the blocks back.  Returns v (C, n)."""
    n_sp = 1 if group is None else torch.distributed.get_world_size(group)
    j = 0 if group is None else torch.distributed.get_rank(group)
    C, n = v_loc.shape
    pad = -n % n_sp
    tail = lambda value: v_loc.new_full((C, pad), value)
    v_loc = torch.cat([v_loc, tail(_BIG ** 0.5)], dim=-1)
    k_prev = torch.cat([k_prev, tail(0.0)], dim=-1)
    ds = torch.cat([ds, tail(0.0)], dim=-1)
    chain_ok = torch.cat([chain_ok, tail(1.0)], dim=-1)
    blk = (n + pad) // n_sp
    block = lambda a: a[:, j * blk:(j + 1) * blk]
    e_loc = block(v_loc * v_loc)
    k_b, ds_b, ok_b = block(k_prev), block(ds), block(chain_ok)
    e = e_loc
    for _ in range(sweeps):
        e = _block_sweep(vehicle, e, e_loc, k_b, ds_b, ok_b, valid0, accelerating, group)
    e_all = all_gather(e, group)  # (n_sp, C, blk)
    return torch.sqrt(e_all.permute(1, 0, 2).reshape(C, n_sp * blk)[:, :n])


def _profile_sp_local(vehicle, s, k_abs, s_max, closed: bool, sweeps: int, group):
    """`solve_profile_sp` on (C, n) rows with the sp group given: the same
    roll to each row's minimum, transparent padding and two directional
    passes as the JAX package's `_profile_sp_local`."""
    v_local = velocity.local_limit(vehicle, k_abs)
    i0, fwd, bwd = velocity._rolled_streams(s, k_abs, v_local, s_max, closed)
    dtype = s.dtype
    no_link = torch.zeros_like(i0, dtype=torch.bool)
    v_acc = _run_pass_local(vehicle, *fwd[:3], fwd[3].to(dtype), no_link, True, sweeps, group)
    v_acc = velocity._roll_rows(v_acc, i0)
    valid0_b = torch.ones_like(no_link) if closed else i0 != 0
    v_dec = _run_pass_local(vehicle, *bwd[:3], bwd[3].to(dtype), valid0_b, False, sweeps, group)
    v_dec = velocity._roll_rows(torch.flip(v_dec, dims=(-1,)), i0)
    return torch.minimum(v_acc, v_dec)


@torch.no_grad()
def solve_profile_sp(vehicle, s, k_abs, s_max, mesh, closed: bool = True, sweeps: int = 16):
    """The profile with the sample axis sharded over `mesh`'s 'sp' ranks.
    s, k_abs: (N,) or (B, N) samples, replicated on those ranks; s_max: the
    lap length(s) (ignored when open).  Every rank of the axis returns the
    whole profile, of k_abs's shape.  `mesh=None` runs the same sweeps on
    one process."""
    group, _, _ = axis(mesh, "sp")
    s2, k2, s_max, single = velocity._rows(s, k_abs, s_max)
    v = _profile_sp_local(vehicle, s2, k2, s_max, closed, sweeps, group)
    return v[0] if single else v
