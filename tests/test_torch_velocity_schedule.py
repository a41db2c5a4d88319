"""Kernel 3's schedule, modelled in plain PyTorch, against its twin.

`csrc/velocity.cu` runs each sweep over ONE lap, from a point where the
recurrence resets whatever its carry (the first argmin of the lateral limit
on a closed lap, NaN counting as the minimum; the seam on an open one), cut
into P segments that run in parallel from an upper-bound guess (the lateral
limit of the position before each segment) and are repaired in rounds: a
segment whose carry changed re-runs from it until its first value that
equals the stored one bit for bit.  `schedule` below does the same on
(B, N) tensors with the twin's arithmetic, so in float64 it must equal
`ops/velocity_batch.solve_profile_batch_reference` (two laps per sweep) bit
for bit, NaN positions equal.  It also counts, per candidate, the fix-up
rounds and the steps on the serial path (pass 1's longest segment plus,
per round, the longest re-run); `-s` prints them:

    python -m pytest tests/test_torch_velocity_schedule.py -q -s

Inputs: the racing-line searches' candidate geometries (1024 seeded lines
on buckmore at width 0.99 through the batched tridiag fit, as
`chip_smoke.py` makes them), tbr18 and MX5, closed and open; and hard rows
(NaN curvature samples, a NaN distance, a row all NaN, constant curvature
where every sample ties, the minimum at sample 0 and at N-1) at N = 17,
300 and 846, closed and open.  The MX5 cases on the searches' lines are in
tests/test_torch_velocity_schedule_mx5.py.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, velocity_batch
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SEGMENTS = (1, 4, 16)


def _same(a, b):
    """Bit for bit, any NaN equal to any NaN (the kernel's stop rule)."""
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return (a.view(bits) == b.view(bits)) | (torch.isnan(a) & torch.isnan(b))


def _step_fn(vehicle, dtype, accelerating):
    """The twin's step (`solve_profile_batch_reference.limit`), op for op."""
    params, engine, pacejka = velocity_batch.pack_vehicle(vehicle, dtype, "cpu")
    mass, f_cap, eng_const, eng_quad, _ = params.unbind()
    inv_mass = 1.0 / mass

    def traction(v, k):
        f_lat = mass * v * v * k
        slack = f_cap * f_cap - f_lat * f_lat
        return torch.where(slack > 0.0, torch.sqrt(torch.clamp(slack, min=1e-12)), torch.zeros_like(slack))

    def engine_force(v):
        if pacejka:
            return eng_const - eng_quad * v * v
        f = engine[3, 0].expand_as(v)
        for i in range(velocity_batch.MAX_ENGINE_KNOTS - 1):
            f = f + engine[1, i] * torch.minimum(torch.clamp(v - engine[0, i], min=0.0), engine[2, i])
        return f

    def step(v_prev, v_here, k_p, ds_j):
        force = traction(v_prev, k_p)
        if accelerating:
            force = torch.minimum(engine_force(v_prev), force)
        vlim = torch.sqrt(v_prev * v_prev + 2.0 * force * inv_mass * torch.clamp(ds_j, min=0.0))
        grow = (ds_j >= 0.0) & (v_here > v_prev)
        return torch.where(grow, torch.minimum(v_here, vlim), v_here)

    return step


class _Sweep:
    """One sweep of B candidates in chain order, cut into P segments."""

    def __init__(self, step, v_here, k_prev, ds, P):
        self.step, self.vh, self.kp, self.ds = step, v_here, k_prev, ds
        B, N = v_here.shape
        L = -(-N // P)
        self.N, self.L = N, L
        self.c0 = torch.arange(P) * L
        self.n = (N - self.c0).clamp(0, L)  # positions per segment, 0 if empty
        self.prev = (self.c0 - 1) % N  # the position before each segment
        self.out = torch.empty_like(v_here)
        self.guess = v_here[:, self.prev]  # v <= v_loc: an upper bound
        self.used = self.guess.clone()
        self.q = torch.arange(P)

    def run(self, v, lanes, fix):
        """Run the segments of `lanes` (B, P) from carries v (B, P); with
        `fix`, each stops at its first value equal to the stored one.
        Returns the steps each lane took (B, P)."""
        running = lanes & (self.n > 0)
        steps = torch.zeros(running.shape, dtype=torch.int64)
        v = v.clone()
        for t in range(self.L):
            segs = torch.nonzero(self.n > t).flatten()
            mask = running[:, segs]
            if not bool(mask.any()):
                break
            cc = self.c0[segs] + t
            vn = self.step(v[:, segs], self.vh[:, cc], self.kp[:, cc], self.ds[:, cc])
            steps[:, segs] += mask
            if fix:
                mask = mask & ~_same(vn, self.out[:, cc])
                running[:, segs] = mask
            self.out[:, cc] = torch.where(mask, vn, self.out[:, cc])
            v[:, segs] = vn
        return steps

    def redo(self):
        """Lanes whose carry (the end of the previous segment) changed."""
        carry = self.out[:, self.prev]
        redo = (self.q > 0) & (self.n > 0) & ~_same(carry, self.used)
        self.used = torch.where(redo, carry, self.used)
        return redo, carry


def schedule(vehicle, s, k_abs, s_max, closed, P):
    """Kernel 3's schedule on CPU tensors: (v (B, N), fix-up rounds (B,),
    serial steps (B,))."""
    B, N = k_abs.shape
    dtype = k_abs.dtype
    s = torch.as_tensor(s, dtype=dtype).reshape(-1, N).expand(B, N)
    s_max = torch.as_tensor(s_max, dtype=dtype).reshape(-1).expand(B)
    mu_g = velocity_batch.pack_vehicle(vehicle, dtype, "cpu")[0][4]
    v_loc = torch.sqrt(mu_g / torch.maximum(k_abs, torch.full_like(k_abs, 1e-12)))
    d = s - torch.roll(s, 1, dims=1)
    if closed:
        ds = torch.remainder(d, s_max[:, None])
        start_a = start_d = torch.argmin(v_loc, dim=1)
    else:
        ds = torch.cat([torch.full_like(d[:, :1], -1.0), d[:, 1:]], dim=1)
        start_a, start_d = torch.zeros(B, dtype=torch.int64), torch.full((B,), N - 1)
    c = torch.arange(N)
    idx_a, idx_d = (start_a[:, None] + c) % N, (start_d[:, None] - c) % N
    nb_a, nb_d = (idx_a - 1) % N, (idx_d + 1) % N  # k_prev's sample; the braking ds's
    g = lambda x, i: x.gather(1, i)
    sweeps = [_Sweep(_step_fn(vehicle, dtype, True), g(v_loc, idx_a), g(k_abs, nb_a), g(ds, idx_a), P),
              _Sweep(_step_fn(vehicle, dtype, False), g(v_loc, idx_d), g(k_abs, nb_d), g(ds, nb_d), P)]
    all_lanes = torch.ones((B, P), dtype=torch.bool)
    chain = torch.stack([sw.run(sw.guess, all_lanes, False) for sw in sweeps]).amax(dim=(0, 2))
    rounds = torch.zeros(B, dtype=torch.int64)
    while True:
        redos = [sw.redo() for sw in sweeps]
        if not any(bool(r.any()) for r, _ in redos):
            break
        steps = torch.stack([sw.run(carry, r, True) for sw, (r, carry) in zip(sweeps, redos)])
        rounds += torch.stack([r for r, _ in redos]).any(dim=2).any(dim=0)
        chain += steps.amax(dim=(0, 2))
    v_acc = torch.empty_like(v_loc).scatter_(1, idx_a, sweeps[0].out)
    v_dec = torch.empty_like(v_loc).scatter_(1, idx_d, sweeps[1].out)
    return torch.minimum(v_acc, v_dec), rounds, chain


def _assert_bit_equal(got, ref):
    assert got.shape == ref.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert bool(_same(got, ref).all())


# ------------------------------------------------------------------- inputs
@pytest.fixture(scope="module")
def geometry():
    """The searches' 1024 candidate lines (chip_smoke.py's seed), float64."""
    track = Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.99).to("cpu", torch.float64)
    alphas = np.random.default_rng(7).uniform(0.0, global_search.ALPHA_HI, (1024, track.n_decongested))
    with torch.no_grad():
        s, k, length = global_search._geometry(track, torch.as_tensor(alphas),
                                               spline.FIT_METHOD_CLOSED_BATCHED)
    return s[:, :-1], k, length


_TWIN = {}


def _twin(key, vehicle, s, k, s_max, closed):
    if key not in _TWIN:
        _TWIN[key] = velocity_batch.solve_profile_batch_reference(vehicle, s, k, s_max, closed)
    return _TWIN[key]


def hard_rows(s, k, length, N):
    """(s, k, s_max) of 8 rows of N samples from 8 real lines: two as they
    are, NaN curvature at three samples, a NaN distance, all NaN, constant
    curvature (every sample ties), and a line rolled so that its minimum
    lateral limit is at sample 0 and at N-1.  (tests/test_torch_velocity_cuda.py
    takes the same rows on the card.)"""
    s, k, length = s[:8, :N].clone(), k[:8, :N].clone(), length[:8].clone()
    k[2, [1, N // 2, N - 1]] = float("nan")
    s[3, N // 3] = float("nan")
    k[4] = float("nan")
    k[5] = 0.0123
    for row, at in ((6, 0), (7, N - 1)):
        k[row] = torch.roll(k[row], at - int(torch.argmax(k[row])))
    return s, k, length


def check_search_geometries(name, closed, P, geometry):
    """The schedule against the twin on the searches' lines for one vehicle
    (tbr18 here, MX5 in tests/test_torch_velocity_schedule_mx5.py, so that
    `--dist loadfile` runs the two on different workers)."""
    s, k, length = geometry
    if not closed:  # the open lap: the first 300 samples
        s, k = s[:, :300], k[:, :300].contiguous()
    veh = load_vehicle(name)
    got, rounds, chain = schedule(veh, s, k, length, closed, P)
    _assert_bit_equal(got, _twin((name, closed), veh, s, k, length, closed))
    assert int(rounds.max()) <= P - 1
    print(f"\n{name} {'closed' if closed else 'open'} B={k.shape[0]} N={k.shape[1]} P={P}: "
          f"fix-up rounds per candidate mean {rounds.double().mean():.3f}, max {int(rounds.max())}; "
          f"serial steps mean {chain.double().mean():.1f}, max {int(chain.max())} "
          f"(pass 1: {-(-k.shape[1] // P)}; two laps: {2 * k.shape[1]}) (CPU count)")


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("P", SEGMENTS)
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
@pytest.mark.parametrize("name", ["tbr18"])
def test_schedule_equals_twin_on_search_geometries(name, closed, P, geometry):
    check_search_geometries(name, closed, P, geometry)


@pytest.mark.parametrize("P", (1, 3, 4, 7, 16))
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
@pytest.mark.parametrize("N", (17, 300, 846))
def test_schedule_equals_twin_on_hard_rows(N, closed, P, geometry):
    s, k, length = hard_rows(*geometry, N)
    veh = load_vehicle("tbr18")
    v_loc = velocity_batch.pack_vehicle(veh, k.dtype, "cpu")[0][4] / k.clamp(min=1e-12)
    assert torch.argmin(v_loc[6]) == 0 and torch.argmin(v_loc[7]) == N - 1
    got, rounds, _ = schedule(veh, s, k, length, closed, P)
    ref = _twin(("hard", N, closed), veh, s, k, length, closed)
    _assert_bit_equal(got, ref)
    assert bool(torch.isnan(ref[4]).all()) and bool(torch.isnan(ref[2]).any())
    assert int(rounds.max()) <= P - 1


def test_wrapper_block_shape():
    """Warps per block spread the searches' batches over the SMs: 4 at
    B=1024 (256 blocks), 1 at B=128 and 256; past the SM count 1."""
    assert velocity_batch.warps_for(1024, 132) == 4
    assert velocity_batch.warps_for(528, 132) == 4
    assert velocity_batch.warps_for(300, 132) == 2
    assert [velocity_batch.warps_for(B, 132) for B in (1, 128, 256)] == [1, 1, 1]


def test_wrapper_rejects_bad_schedule(geometry):
    s, k, length = (x[:2] for x in geometry)
    veh = load_vehicle("tbr18")
    for kw in ({"segments": 0}, {"segments": velocity_batch.MAX_SEGMENTS + 1}, {"warps": 0},
               {"warps": velocity_batch.MAX_WARPS + 1}):
        with pytest.raises(ValueError, match="segments|warps"):
            velocity_batch._launch(veh, s, k, length, True, **kw)
