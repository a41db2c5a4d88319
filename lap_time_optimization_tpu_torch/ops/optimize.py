"""Bounded L-BFGS with a batched ladder line search — port of part of
`lap_time_optimization_tpu/ops/optimize.py`.

The reference drives its racing-line searches through scipy's L-BFGS-B with
finite-difference gradients; here lap time is differentiable, so L-BFGS
runs on autograd gradients.  Box constraints [lo, hi] use a sigmoid
reparameterisation, which keeps iterates strictly feasible.

Everything runs over a leading INSTANCE axis, with the semantics of the JAX
package's `vmap` over a `while_loop`: each instance runs its own L-BFGS with
its own iteration count, gradient norm and memory; an instance that has
finished is frozen by `torch.where` while the others go on, and `n_iter` is
per instance.  The objective `fun` maps (K, d) → (K,) with every row
independent, so one autograd pass over its sum gives every instance's
gradient.

Ported here: `MinimizeResult`, `bounded_transform`, `_two_loop`,
`lbfgs_ladder_stepper` and `bounded_stepper(linesearch="ladder")`.  The zoom
line-search stepper comes with the racing-line methods; the host-chunked
segmenting of the JAX package (`minimize_bounded_chunked`) exists for a TPU
runtime's program deadline and is not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    n_iter: torch.Tensor
    grad_norm: torch.Tensor


def bounded_transform(lo, hi):
    """Return (to_params, to_theta) maps for the box [lo, hi]."""

    def to_params(theta):
        return lo + (hi - lo) * torch.sigmoid(theta)

    def to_theta(x):
        p = torch.clamp((x - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
        return torch.log(p) - torch.log1p(-p)

    return to_params, to_theta


def _value_and_grad(fun, x: torch.Tensor):
    """f(x) (K,) and its gradient (K, d), row by row."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _two_loop(grad, mem_s, mem_y, mem_rho, count, gamma):
    """Classic L-BFGS two-loop recursion over rolling (K, m, d) buffers.

    `mem_rho[:, j] = 1/(s_jᵀy_j)` with 0 marking empty or cautious-skipped
    slots (their terms vanish).  Iterates most-recent→oldest backward and
    oldest→most-recent forward, via offsets from each instance's rolling
    write index `count`."""
    m = mem_rho.shape[-1]
    pick = lambda t, j: torch.gather(t, 1, j[:, None, None].expand(-1, 1, t.shape[-1]))[:, 0]
    q = grad
    alpha = torch.zeros_like(mem_rho)
    for i in range(m):
        j = (count - 1 - i) % m  # most recent first
        rho_j = torch.gather(mem_rho, 1, j[:, None])[:, 0]
        a = rho_j * torch.sum(pick(mem_s, j) * q, dim=-1)
        q = q - a[:, None] * pick(mem_y, j)
        alpha = alpha.scatter(1, j[:, None], a[:, None])
    r = gamma[:, None] * q
    for i in range(m):
        j = (count - m + i) % m  # oldest first
        rho_j = torch.gather(mem_rho, 1, j[:, None])[:, 0]
        b = rho_j * torch.sum(pick(mem_y, j) * r, dim=-1)
        a_j = torch.gather(alpha, 1, j[:, None])[:, 0]
        r = r + (a_j - b)[:, None] * pick(mem_s, j)
    return r


def lbfgs_ladder_stepper(
    fun: Callable[[torch.Tensor], torch.Tensor],
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    n_rungs: int = 13,
    armijo_c: float = 1e-4,
):
    """L-BFGS with a batched best-of-ladder line search; returns `(init, run)`.

    Each iteration evaluates every step size of a geometric ladder
    η ∈ {2, 1, ½, …, 2^{2-L}} in ONE (K·L, d) objective batch, then one
    value+grad at the accepted point.  Acceptance: the best-decrease rung
    satisfying Armijo f(x+ηd) ≤ f(x) + c·η·∇fᵀd, else the best strictly
    improving rung.  The ladder is self-centring: on acceptance the window
    re-centres at 4× the accepted step; on rejection it shifts down by its
    span and the iteration retries, and the iterate freezes (grad_norm set
    to 0) only once the centre underflows 1e-12 ("dead end").  The memory
    update is cautious: a pair with sᵀy ≤ 1e-10·|s||y| is skipped and slot
    `idx` is left untouched.  A non-descent direction falls back to
    steepest descent scaled by γ; the first step is trust-regioned to the
    unit ball.  Ties among rungs pick the lowest index (`torch.argmin`), and
    NaN trial values count as +inf.

    `init(x0)` takes x0 (K, d) and returns the carry
    (x, mem, it, gnorm, f, g); `run(carry, n_steps)` advances every instance
    that is still active (it < min(it0 + n_steps, max_iter) and gnorm > tol)
    until none is."""
    def init(x0):
        K, d = x0.shape
        dtype, device = x0.dtype, x0.device
        mem = dict(
            s=torch.zeros((K, memory_size, d), dtype=dtype, device=device),
            y=torch.zeros((K, memory_size, d), dtype=dtype, device=device),
            rho=torch.zeros((K, memory_size), dtype=dtype, device=device),
            gamma=torch.ones((K,), dtype=dtype, device=device),
            count=torch.zeros((K,), dtype=torch.long, device=device),
            center=torch.ones((K,), dtype=dtype, device=device),  # self-centring ladder scale
        )
        f0, g0 = _value_and_grad(fun, x0)
        it = torch.zeros((K,), dtype=torch.long, device=device)
        return (x0, mem, it, torch.linalg.norm(g0, dim=-1), f0, g0)

    def step(c):
        x, mem, it, _, f, g = c
        K, d = x.shape
        dtype = x.dtype
        gamma = mem["gamma"]
        ladder = (2.0 ** (1.0 - torch.arange(n_rungs, device=x.device, dtype=torch.float64))).to(dtype)
        span = 2.0 ** (n_rungs - 2)  # top-rung / bottom-rung ratio
        direction = -_two_loop(g, mem["s"], mem["y"], mem["rho"], mem["count"], gamma)
        slope = torch.sum(g * direction, dim=-1)
        bad = slope >= 0.0  # fall back to scaled steepest descent
        direction = torch.where(bad[:, None], -gamma[:, None] * g, direction)
        slope = torch.where(bad, -gamma * torch.sum(g * g, dim=-1), slope)
        first = mem["count"] == 0  # trust-region the unit ball on the first step
        dn = torch.linalg.norm(direction, dim=-1)
        scale0 = torch.where(first & (dn > 1.0), 1.0 / dn, torch.ones_like(dn))
        etas = ladder[None, :] * scale0[:, None] * mem["center"][:, None]  # (K, L)
        trial = x[:, None, :] + etas[:, :, None] * direction[:, None, :]
        with torch.no_grad():
            f_trial = fun(trial.reshape(K * n_rungs, d)).reshape(K, n_rungs)
        f_trial = torch.where(torch.isnan(f_trial), torch.full_like(f_trial, torch.inf), f_trial)
        armijo_ok = f_trial <= f[:, None] + armijo_c * etas * slope[:, None]
        best_ok = torch.argmin(torch.where(armijo_ok, f_trial, torch.full_like(f_trial, torch.inf)), dim=-1)
        j = torch.where(armijo_ok.any(dim=-1), best_ok, torch.argmin(f_trial, dim=-1))
        f_j = torch.gather(f_trial, 1, j[:, None])[:, 0]
        eta_j = torch.gather(etas, 1, j[:, None])[:, 0]
        improved = f_j < f
        eta = torch.where(improved, eta_j, torch.zeros_like(eta_j))
        x_new = x + eta[:, None] * direction
        f_new = torch.where(improved, f_j, f)
        _, g_new = _value_and_grad(fun, x_new)
        center = torch.where(improved, torch.clamp(4.0 * eta_j / scale0, 2.0 ** -24, 1e3),
                             mem["center"] / span)
        # cautious memory update: a skipped pair leaves slot idx untouched
        s = x_new - x
        y = g_new - g
        sy = torch.sum(s * y, dim=-1)
        ok = (sy > 1e-10 * torch.linalg.norm(s, dim=-1) * torch.linalg.norm(y, dim=-1)) & improved
        idx = mem["count"] % memory_size
        slot = torch.nn.functional.one_hot(idx, memory_size).bool() & ok[:, None]  # (K, m)
        mem_new = dict(
            s=torch.where(slot[:, :, None], s[:, None, :], mem["s"]),
            y=torch.where(slot[:, :, None], y[:, None, :], mem["y"]),
            rho=torch.where(slot, (1.0 / torch.where(sy == 0, torch.ones_like(sy), sy))[:, None],
                            mem["rho"]),
            gamma=torch.where(ok, sy / torch.sum(y * y, dim=-1), gamma),
            count=mem["count"] + ok.long(),
            center=center,
        )
        # converged only when repeated rejections pushed the window to
        # underflow: no descent exists at any representable step
        dead_end = (~improved) & (center < 1e-12)
        gnorm = torch.where(dead_end, torch.zeros_like(sy), torch.linalg.norm(g_new, dim=-1))
        return (x_new, mem_new, it + 1, gnorm, f_new, g_new)

    def run(carry, n_steps: int):
        stop_at = torch.clamp(carry[2] + n_steps, max=max_iter)
        while True:
            active = (carry[2] < stop_at) & (carry[3] > tol)
            if not bool(active.any()):
                return carry
            new = step(carry)
            carry = _select(active, new, carry)

    return init, run


def _select(active: torch.Tensor, new, old):
    """`torch.where(active, new, old)` over a carry's tensors and dicts, the
    instance axis first."""
    if isinstance(new, dict):
        return {k: _select(active, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_select(active, a, b) for a, b in zip(new, old))
    mask = active.reshape(active.shape + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def bounded_stepper(
    fun: Callable[[torch.Tensor], torch.Tensor],
    lo: float = 0.0,
    hi: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    dtype=torch.float32,
    linesearch: str = "ladder",
):
    """Bounded minimisation as `(init, run, finalize)` over a leading
    instance axis: `init(x0)` with x0 (K, d) in [lo, hi] → carry;
    `run(carry, n_steps)` → carry; `finalize(carry)` → `MinimizeResult` in
    the bounded coordinates, with f(x) taken from the carry (the ladder
    keeps f at every accepted step)."""
    if linesearch != "ladder":
        raise NotImplementedError(f"linesearch={linesearch!r}: only the ladder is ported")
    lo = torch.as_tensor(lo, dtype=dtype)
    hi = torch.as_tensor(hi, dtype=dtype)
    to_params, to_theta = bounded_transform(lo, hi)
    init0, run = lbfgs_ladder_stepper(lambda theta: fun(to_params(theta)), max_iter=max_iter,
                                      tol=tol, memory_size=memory_size)

    def init(x0):
        return init0(to_theta(x0))

    def finalize(carry) -> MinimizeResult:
        return MinimizeResult(x=to_params(carry[0]), fun=carry[4], n_iter=carry[2],
                              grad_norm=carry[3])

    return init, run, finalize
