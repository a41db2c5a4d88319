"""Closed-loop NMPC driver: solve → clip → plant step → warm-start shift.

Port of `lap_time_optimization_tpu/mpc/runner.py`: the single stream
(`closed_loop`), the same in chunks with a checkpoint (`closed_loop_chunked`),
a fleet of independent loops on one device (`closed_loop_batch`) and the
fleet sharded over a mesh's 'dp' ranks (`closed_loop_fleet`).  Each
control cycle warm-starts the AL-iLQR from the shifted previous solution,
applies the first input, clipped to the actuator rate and box limits, and
integrates the plant (plant == model, like the reference's do_mpc simulator
over the same ODE).  The cycle code takes any leading instance shape: the
batched loop runs it on (B, ...) with `solver.solve_batch`.

On the card a cycle is three kernels: the concatenation of z0, the solve
kernel and the tail kernel (`ops.cycle_tail`: the clip, the plant step, the
warm-start shift and the cycle's outputs in one launch), which the eager and
the graphed loops both run.  A Gauss-Newton loop there is the counterpart
of the JAX runner's single `lax.scan` and `_const_jit`: its cycles run as
captured CUDA graphs of `GRAPH_CYCLES` cycles each (`_Program`), replayed
from the host with no sync.  A program reads its carry from, and writes it
back in place to, fixed tensors and has its cycles' outputs written into
fixed (..., G, ·) buffers, which one copy per field moves into the caller's
`SimResult` after each replay; a tail of fewer cycles gets a program of its
own length.  Programs are cached by everything their graph depends on
(`_program_key`: both model flags, the whole `SolverConfig`, dtype, device,
the leading shape, G and the identity and version of every buffer of the
model and the OCP parameters), so a model that differs only in its flags
never replays another's graph (the JAX key's fault R1).  A capture that
fails raises: there is no fallback.  The graph replays the kernels the
eager loop launches, so the trajectory is the eager loop's bit for bit,
whatever G.  The eager loop (`_advance`) is the plain version: the CPU runs
it, and on the card exact-Hessian loops run it (`hessian_mode="exact"`:
its plain `torch.func` solve is ~11 s of launch-bound eager ops per solve,
far too many graph nodes).  The presolve (two solves) is eager everywhere.
Nothing syncs with the host but checkpoints, `applied_violation` and
`to_sim_results`.

With the span recorder of `utils/profiling` on, a loop records its call
(`runner.request`), the presolve (`runner.presolve`), each program run
with its output copies (`runner.replay`) and each capture
(`runner.capture`, with `.warmup`, `.record` and `.instantiate` inside);
off, each span site costs one check.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models.bicycle import NU, NX
from lap_time_optimization_tpu_torch.mpc import solver as solver_mod
from lap_time_optimization_tpu_torch.mpc.solver import n_con
from lap_time_optimization_tpu_torch.ops import cycle_tail, ilqr
from lap_time_optimization_tpu_torch.parallel.distributed import gather_rows, shard_rows
from lap_time_optimization_tpu_torch.utils import checkpoint, profiling

#: Reference initial state [s, n, mu, vx, vy, r, steer, throttle]
#: (src/mpc.py:107-110)
X0_REFERENCE = np.array([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1])


class SimResult(NamedTuple):
    # closed_loop_batch puts the instance axis B first on every field
    xs: torch.Tensor  # (steps+1, NX) states (x[0] = x0)
    us: torch.Tensor  # (steps+1, NU) applied inputs (u[0] = 0)
    costs: torch.Tensor  # (steps,) OCP cost per solve
    violations: torch.Tensor  # (steps,) max constraint violation per solve
    sdot: torch.Tensor  # (steps,) track progress rate per step


def _solve(x):
    """The solve of a loop from states x: `solver.solve` for one OCP (x
    (NX,)), `solver.solve_batch` for a fleet (x (B, NX))."""
    return solver_mod.solve_batch if x.dim() > 1 else solver_mod.solve


def _presolve(model, p, cfg, x0, pack=None):
    """Burn in the t=0 warm start (do_mpc's set_initial_guess analogue,
    reference src/mpc.py:118) and return the initial carry.  `pack`: the
    solve's constants (`ops.ilqr.pack`), built by the calling loop.  A
    device span, `runner.presolve`."""
    with profiling.span("runner.presolve", device=x0.device):
        lead = x0.shape[:-1]
        N = cfg.horizon
        us_warm = x0.new_zeros(lead + (N, NU))
        lam_warm = x0.new_zeros(lead + (N + 1, n_con(model)))
        u_prev = x0.new_zeros(lead + (NU,))
        z0_init = torch.cat([x0, u_prev], dim=-1)
        for _ in range(2):
            warm = _solve(x0)(model, p, cfg, z0_init, us_warm, lam_warm, pack)
            us_warm, lam_warm = warm.us, warm.lam
    return (x0, us_warm, lam_warm, u_prev)


def _step_fn(model, p, cfg, carry, pack=None, rows=None):
    """One control cycle: solve, clip the applied input, integrate the plant,
    shift the warm start.  Returns (carry, (x_next, u0, cost, violation, sdot)).
    A fleet's cycle is one `solver.solve_batch` for all B instances, then the
    clip and the plant step on (B, ...).  All after the solve is the tail
    (`ops.cycle_tail.tail`): one kernel on the card, the plain code on the
    CPU.  With `rows`, views into the outputs (the xs and us rows, the cost,
    violation and sdot entries), the tail writes the cycle's outputs there
    and returns them as the outputs."""
    x, us_warm, lam_warm, u_prev = carry
    z0 = torch.cat([x, u_prev], dim=-1)
    res = _solve(x)(model, p, cfg, z0, us_warm, lam_warm, pack)
    return cycle_tail.tail(model, p, cfg, x, res, pack, rows)


def _empty_result(x0, steps) -> SimResult:
    """Preallocated outputs on x0's device, x[0] = x0 and u[0] = 0."""
    lead = x0.shape[:-1]
    xs = x0.new_empty(lead + (steps + 1, NX))
    xs[..., 0, :] = x0
    scalars = (x0.new_empty(lead + (steps,)) for _ in range(3))
    return SimResult(xs, x0.new_zeros(lead + (steps + 1, NU)), *scalars)


def _advance(model, p, cfg, carry, out: SimResult, start, stop, pack=None):
    """Control cycles start..stop-1, written into `out`; returns the carry."""
    for t in range(start, stop):
        carry, (x_next, u0, cost, viol, sdot) = _step_fn(model, p, cfg, carry, pack)
        out.xs[..., t + 1, :] = x_next
        out.us[..., t + 1, :] = u0
        out.costs[..., t] = cost
        out.violations[..., t] = viol
        out.sdot[..., t] = sdot
    return carry


#: Control cycles per captured CUDA graph of a loop on the card (G).  On an
#: H100 the rate is the same at G = 10, 25, 50 and 100 within the spread of
#: its readings, and the capture's time grows with G (0.2 s at 10, 0.9-1.4 s
#: at 50; PERF.md §6), so G is the smallest measured.
GRAPH_CYCLES = 10
#: Programs by `_program_key`, oldest first, at most `_MAX_PROGRAMS`, as the
#: JAX runner bounds its `_const_jit` cache (an eviction only costs a capture).
_PROGRAMS: dict = {}
_MAX_PROGRAMS = 32


class _Program:
    """`cycles` control cycles of one loop over fixed tensors: the carry
    (x, us_warm, lam_warm, u_prev), read at the start and written back in
    place at the end (the counterpart of a scan's carry), and the outputs, a
    `SimResult` of (..., cycles, ·) buffers, which each cycle's tail writes
    its row of.  The body runs `_step_fn` in `_advance`'s order, so it gives
    `_advance`'s bits.  `capture` records the body as one CUDA graph, which
    `run` then replays; uncaptured, `run` runs the body (the CPU tests hold
    it to `_advance`).  The program holds its model, OCP parameters and pack
    (`ops.ilqr.pack`, built once), so the ids in its key stay theirs while
    it lives."""

    def __init__(self, model, p, cfg, lead: tuple, cycles: int, dtype, device):
        self.model, self.p, self.cfg, self.cycles = model, p, cfg, cycles
        self.pack = ilqr.pack(model, p, cfg)
        new = lambda *shape: torch.zeros(lead + shape, dtype=dtype, device=device)
        N = cfg.horizon
        self.carry = (new(NX), new(N, NU), new(N + 1, n_con(model)), new(NU))
        self.outs = SimResult(new(cycles, NX), new(cycles, NU), new(cycles), new(cycles), new(cycles))
        self.graph = None
        self.counts = {}  # what one replay counts (`utils.profiling.counts`): the launches it runs
        self.pool_bytes = 0  # the bytes the capture's pool reserved

    def body(self):
        carry, outs = self.carry, self.outs
        for g in range(self.cycles):
            rows = (outs.xs[..., g, :], outs.us[..., g, :], outs.costs[..., g], outs.violations[..., g],
                    outs.sdot[..., g])
            carry, _ = _step_fn(self.model, self.p, self.cfg, carry, self.pack, rows)
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)

    def capture(self):
        """PyTorch's recipe, as `ops.optimize.GraphedValueAndGrad` follows it:
        one warm-up cycle on a side stream (the kernel library's build and
        module load, lazy handles; its result is dropped and the carry left
        as it was), then the body once under `torch.cuda.graph`.  What both
        count (`utils.profiling.count`) moves under "runner.capture." + its
        name, so a loop's counts hold its cycles alone; the body's counts are
        what a replay adds (`counts`).  A capture that succeeds counts as
        "runner.graph_captures".  A host span, `runner.capture` (attribute
        `pool_bytes`), with the children `.warmup`, `.record` (the body under
        capture) and `.instantiate` (ending the capture).  A failure
        raises."""
        device = self.carry[0].device
        before = profiling.counts()
        try:
            with profiling.span("runner.capture") as attrs, torch.cuda.device(device):
                with profiling.span("runner.capture.warmup"):
                    main = torch.cuda.current_stream(device)
                    side = torch.cuda.Stream(device=device)
                    side.wait_stream(main)
                    with torch.cuda.stream(side):
                        _step_fn(self.model, self.p, self.cfg, self.carry, self.pack)
                    main.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with contextlib.ExitStack() as ending:
                    with torch.cuda.graph(graph):
                        with profiling.span("runner.capture.record"):
                            reserved = torch.cuda.memory_reserved(device)
                            recorded = profiling.counts()
                            self.body()
                            self.counts = profiling.counts() - recorded
                        # closed by `ending` once the graph's context has ended the capture
                        ending.enter_context(profiling.span("runner.capture.instantiate"))
                self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
                if attrs is not None:
                    attrs["pool_bytes"] = self.pool_bytes
        finally:
            during = profiling.counts() - before
            profiling.set_counts(before)
            for name, n in during.items():
                profiling.count("runner.capture." + name, n)
        self.graph = graph
        profiling.count("runner.graph_captures")

    def run(self):
        if self.graph is None:
            self.body()
        else:
            self.graph.replay()
            for name, n in self.counts.items():
                profiling.count(name, n)


def _program_key(model, p, cfg, x0, cycles: int) -> tuple:
    """Everything a program's graph depends on: the model's flags (both
    `enable_*` and the track's `closed`), the whole frozen `SolverConfig`,
    the dtype, device and leading shape of the loop's states, the cycle
    count, and the identity and `_version` of every buffer of the model and
    of the OCP parameters, so that an in-place edit to any of them captures
    anew."""
    buffers = tuple((id(t), t._version) for t in (*model.buffers(), *p.buffers()))
    return (model.enable_traction_ellipse, model.enable_torque_vectoring, model.track.closed, cfg,
            x0.dtype, x0.device, tuple(x0.shape[:-1]), cycles, buffers)


def _program(model, p, cfg, x0, cycles: int) -> _Program:
    """The program of `cycles` cycles for loops from states like x0: cached,
    else built and, on a CUDA device, captured."""
    key = _program_key(model, p, cfg, x0, cycles)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _Program(model, p, cfg, tuple(x0.shape[:-1]), cycles, x0.dtype, x0.device)
        if x0.device.type == "cuda":
            prog.capture()
        if len(_PROGRAMS) >= _MAX_PROGRAMS:
            del _PROGRAMS[next(iter(_PROGRAMS))]
        _PROGRAMS[key] = prog
    return prog


def _advance_programs(model, p, cfg, carry, out: SimResult, start, stop, cycles: int):
    """`_advance` by programs of `cycles` cycles (a last run of fewer cycles
    gets a program of its own length): the carry is copied into a program's
    carry tensors where the program changes, each run's outputs go into `out`
    with one copy per field, and the carry comes back as new tensors.  Each
    run and its copies are a device span, `runner.replay` (attribute
    `cycles`)."""
    prog = None
    for t in range(start, stop, cycles):
        n = min(cycles, stop - t)
        nxt = _program(model, p, cfg, carry[0], n)
        if nxt is not prog:
            for dst, src in zip(nxt.carry, carry):
                dst.copy_(src)
            prog = nxt
        with profiling.span("runner.replay", device=out.xs.device, cycles=n):
            prog.run()
            out.xs[..., t + 1:t + n + 1, :].copy_(prog.outs.xs)
            out.us[..., t + 1:t + n + 1, :].copy_(prog.outs.us)
            out.costs[..., t:t + n].copy_(prog.outs.costs)
            out.violations[..., t:t + n].copy_(prog.outs.violations)
            out.sdot[..., t:t + n].copy_(prog.outs.sdot)
        carry = prog.carry
    return tuple(c.clone() for c in carry)


def _cycles(x0, cfg) -> int:
    """G of a loop from x0: `GRAPH_CYCLES` for a Gauss-Newton loop on a CUDA
    device, else 0, the eager loop."""
    graphed = x0.device.type == "cuda" and cfg.hessian_mode == "gauss_newton"
    return GRAPH_CYCLES if graphed else 0


def _run(model, p, cfg, carry, out: SimResult, start, stop, cycles: int, pack):
    """Cycles start..stop-1 into `out`, by programs of `cycles` cycles, or
    eagerly (`_advance`) where `cycles` is 0; returns the carry."""
    if cycles:
        return _advance_programs(model, p, cfg, carry, out, start, stop, cycles)
    return _advance(model, p, cfg, carry, out, start, stop, pack)


def _request(loop):
    """`loop(model, p, cfg, x0, steps, ...)` inside the span of its whole
    call, `runner.request`: a device span that the loop's other spans name
    as their request (attributes `batch` and `cycles`)."""

    @functools.wraps(loop)
    def spanned(model, p, cfg, x0, steps, *args, **kwargs):
        batch = x0.shape[0] if x0.dim() > 1 else 1
        with profiling.span("runner.request", device=x0.device, request=True, batch=batch, cycles=steps):
            return loop(model, p, cfg, x0, steps, *args, **kwargs)
    return spanned


@_request
def _loop(model, p, cfg, x0: torch.Tensor, steps: int, cycles: int) -> SimResult:
    """`closed_loop` (x0 (NX,)) or `closed_loop_batch` (x0 (B, NX)) by
    programs of `cycles` cycles, or eagerly where `cycles` is 0: the `cuda`
    tests and chip_smoke.py hold the graphed loops to the eager loop on the
    card through it, and the CPU tests run the programs uncaptured."""
    out = _empty_result(x0, steps)
    pk = ilqr.pack(model, p, cfg)
    _run(model, p, cfg, _presolve(model, p, cfg, x0, pk), out, 0, steps, cycles, pk)
    return out


def closed_loop(model, p, cfg, x0: torch.Tensor, steps: int) -> SimResult:
    """Run `steps` control cycles from x0 on x0's device: the presolve, then
    `steps` × (solve → clip → plant → shift), on the card as replays of
    captured graphs of `GRAPH_CYCLES` cycles.  The solve's constants are
    packed once for the run (once per program on the card)."""
    return _loop(model, p, cfg, x0, steps, _cycles(x0, cfg))


def closed_loop_batch(model, p, cfg, x0_batch: torch.Tensor, steps: int) -> SimResult:
    """A fleet of B independent closed loops (cars, scenarios, parameter
    variations) from x0_batch (B, NX): every control cycle solves all B OCPs
    with one `solver.solve_batch`, on the card in graphs as `closed_loop`.
    Outputs carry the instance axis first: xs (B, steps+1, NX), us (B,
    steps+1, NU), costs/violations/sdot (B, steps).  Instance b follows
    `closed_loop` from x0_batch[b]."""
    return _loop(model, p, cfg, x0_batch, steps, _cycles(x0_batch, cfg))


def closed_loop_fleet(model, p, cfg, x0_batch: torch.Tensor, steps: int, mesh) -> SimResult:
    """`closed_loop_batch` with the fleet sharded over `mesh`'s 'dp' ranks
    (`parallel.distributed`): every rank runs the loops of its block of
    x0_batch (B, NX), replicated on every rank, with one solve per control
    cycle (graphed on the card), and one `all_gather` per output field at
    the end, outside the graphs, gives every rank the whole fleet, in the
    layout of `closed_loop_batch`.  The loops are independent, so nothing
    crosses ranks while they run.  A fleet that the dp axis does not divide
    is padded by repeating its last initial state, and the padded rows are
    dropped, as the JAX package does."""
    b = x0_batch.shape[0]
    local = closed_loop_batch(model, p, cfg, shard_rows(mesh, x0_batch, pad=True), steps)
    return SimResult(*(gather_rows(mesh, field, b) for field in local))


def _sim_fingerprint(model, p, cfg, x0) -> str:
    """Digest of everything that determines a simulation's trajectory besides
    (steps, chunk): the model's flags, every model/track/OCP buffer (name,
    dtype, shape, bytes), the full solver config and x0.  A checkpoint written
    under anything else is ignored instead of spliced into this run."""
    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    flags = (model.enable_traction_ellipse, model.enable_torque_vectoring, model.track.closed)
    h.update(repr(flags).encode())
    for prefix, module in (("model.", model), ("p.", p)):
        for name, t in module.state_dict().items():
            a = t.detach().cpu().numpy()
            h.update(f"{prefix}{name} {a.dtype} {a.shape}".encode() + a.tobytes())
    h.update(x0.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def closed_loop_chunked(model, p, cfg, x0: torch.Tensor, steps: int, chunk: int = 100,
                        checkpoint_path: str | None = None) -> SimResult:
    """`closed_loop` in chunks of `chunk` control cycles, with a checkpoint.

    The carry (plant state, warm-start inputs and multipliers, last input)
    crosses chunk boundaries unchanged, so the trajectory is identical to
    `closed_loop`'s.  With `checkpoint_path`, the carry and the outputs so
    far are saved as npz after every chunk but the last; a run restarted
    with the same arguments resumes at the last complete chunk and gives the
    same trajectory.  A checkpoint written for other steps, chunk, x0 or
    `_sim_fingerprint` is ignored.  On the card each chunk replays graphs of
    `GRAPH_CYCLES` cycles, which need not divide `chunk`, and a resumed carry
    is copied into the programs' carry."""
    return _closed_loop_chunked(model, p, cfg, x0, steps, chunk, checkpoint_path, _cycles(x0, cfg))


@_request
def _closed_loop_chunked(model, p, cfg, x0, steps, chunk, checkpoint_path, cycles: int) -> SimResult:
    """`closed_loop_chunked` by programs of `cycles` cycles, or eagerly where
    `cycles` is 0 (see `_loop`)."""
    out = _empty_result(x0, steps)
    if steps <= 0:
        return out
    done, carry = 0, None
    fingerprint = _sim_fingerprint(model, p, cfg, x0) if checkpoint_path is not None else ""
    if checkpoint_path is not None and checkpoint.exists(checkpoint_path):
        state = checkpoint.load(checkpoint_path)
        if (int(state["steps"]) == steps and int(state["chunk"]) == chunk
                and str(state["fingerprint"]) == fingerprint):
            done = int(state["done"])
            t = lambda name: torch.as_tensor(state[name], dtype=x0.dtype, device=x0.device)
            carry = tuple(t(f"carry{i}") for i in range(4))
            for name, a in zip(SimResult._fields, out):
                a[: state[name].shape[0]] = t(name)
    pk = ilqr.pack(model, p, cfg)
    if carry is None:
        carry = _presolve(model, p, cfg, x0, pk)
    while done < steps:
        stop = min(done + chunk, steps)
        carry = _run(model, p, cfg, carry, out, done, stop, cycles, pk)
        done = stop
        if checkpoint_path is not None and done < steps:
            host = lambda a: a.detach().cpu().numpy()
            checkpoint.save(
                checkpoint_path, steps=steps, chunk=chunk, done=done, fingerprint=fingerprint,
                xs=host(out.xs[: done + 1]), us=host(out.us[: done + 1]),
                costs=host(out.costs[:done]), violations=host(out.violations[:done]),
                sdot=host(out.sdot[:done]),
                **{f"carry{i}": host(c) for i, c in enumerate(carry)},
            )
    return out


def applied_violation(model, p, result: SimResult, pairing: str = "jax") -> float:
    """Max constraint violation of the APPLIED closed-loop states/inputs
    against the TRUE (margin-0) band, over every step (and every instance of
    a batch).

    `pairing="jax"` pairs xs[1:] with us[1:] and a zero u_prev, as the JAX
    package does: each input meets the state it produced.  `"applied"`
    pairs each input with the state it was applied from, us[1:] with
    xs[:-1], and with the u_prev the controller saw, us[:-1] (the loop's
    zero u_prev at the first cycle)."""
    if pairing == "jax":
        xs = result.xs[..., 1:, :]
        u_prev = xs.new_zeros(xs.shape[:-1] + (NU,))
    elif pairing == "applied":
        xs, u_prev = result.xs[..., :-1, :], result.us[..., :-1, :]
    else:
        raise ValueError(f"pairing {pairing!r} is not 'jax' or 'applied'")
    z = torch.cat([xs, u_prev], dim=-1)
    return float(torch.max(solver_mod.constraints(model, p, z, result.us[..., 1:, :])))


def tire_logs(model, xs: torch.Tensor):
    """Per-step slip angles and lateral forces (reference src/mpc.py:148-151)."""
    af, ar = model.slip_angles(xs[:, 3], xs[:, 4], xs[:, 5], xs[:, 6])
    fyf, fyr = model.lateral_forces(af, ar)
    return torch.stack([af, ar], dim=1), torch.stack([fyf, fyr], dim=1)


def to_sim_results(model, result: SimResult) -> dict:
    """Serialise with the reference `sim_results.json` schema
    (src/mpc.py:156-159): x/y of shape (steps+1, 8, 1), u (steps+1, 2, 1),
    Fy and alpha (steps+1, 2).  y == x (state-feedback estimator)."""
    xs = result.xs.detach().cpu().double().numpy()
    us = result.us.detach().cpu().double().numpy()
    alphas, fys = tire_logs(model, result.xs)
    alphas = alphas.detach().cpu().double().numpy().copy()
    fys = fys.detach().cpu().double().numpy().copy()
    # zero the t=0 log rows like the reference (src/mpc.py:134-135)
    alphas[0] = 0.0
    fys[0] = 0.0
    x_col = xs[:, :, None]
    u_col = us[:, :, None]
    return {
        "x": x_col.tolist(),
        "y": x_col.tolist(),
        "u": u_col.tolist(),
        "Fy": fys.tolist(),
        "alpha": alphas.tolist(),
    }
