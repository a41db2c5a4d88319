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

Two steppers with one `(init, run)` contract:

* `lbfgs_stepper` — the JAX package's `optax.lbfgs(memory_size=15)` with its
  defaults, written out by hand: the `scale_by_lbfgs` preconditioner (first
  step capped to the unit ball), the zoom line search of
  `scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')` (interval search, cubic/quadratic/bisection
  zoom, the Hager–Zhang approximate decrease test and the safe-step
  fallback) and `value_and_grad_from_state`'s reuse of the search's last
  value and gradient.  Branch for branch as optax 0.2.6.  The racing-line
  methods' default.
* `lbfgs_ladder_stepper` — the batched best-of-ladder search of the global
  searches.

On a CUDA device the zoom stepper replays its value-and-gradient as one CUDA
graph per instance shape (`GraphedValueAndGrad`): the objectives are
thousands of small eager kernels (the lap-time objective's 48-sweep "assoc"
profile and its backward), whose launches would otherwise set the time.  The
objective must then run without a host sync, and a replay computes what the
eager call computes, bit for bit.

The host-chunked segmenting of the JAX package (`minimize_bounded_chunked`)
exists for a TPU runtime's program deadline and is not ported: chunks do not
change the iterates.
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


class GraphedValueAndGrad:
    """`_value_and_grad(fun, x)` captured as one CUDA graph per shape, dtype
    and device of x, and replayed with x copied into the captured input; on
    the CPU the eager call.  The capture follows PyTorch's recipe: warm-up
    calls on a side stream, then one call under `torch.cuda.graph`.  Both
    run the dense linear solves (the spline fits) on cuSOLVER: PyTorch's
    default picks MAGMA for batched solves, whose calls cannot be captured
    (the capture is invalidated)."""

    WARMUP = 2

    def __init__(self, fun):
        self.fun = fun
        self.graphs = {}

    def __call__(self, x: torch.Tensor):
        if not x.is_cuda:
            return _value_and_grad(self.fun, x)
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self.graphs:
            self.graphs[key] = self._capture(x)
        graph, x_in, f_out, g_out = self.graphs[key]
        x_in.copy_(x)
        graph.replay()
        return f_out.clone(), g_out.clone()

    def _capture(self, x: torch.Tensor):
        x_in = x.detach().clone()
        main = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(device=x.device)
        linalg = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    _value_and_grad(self.fun, x_in)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                f_out, g_out = _value_and_grad(self.fun, x_in)
        finally:
            torch.backends.cuda.preferred_linalg_library(linalg)
        return graph, x_in, f_out, g_out


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


# ------------------------------------------------------------------ zoom L-BFGS
# optax.scale_by_zoom_linesearch's defaults (linesearch.py:1331 in optax 0.2.6)
ZOOM_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0


def _lbfgs_precondition(grad, x, st, memory_size: int):
    """optax `scale_by_lbfgs(scale_init_precond=True)`, row by row: store
    the newest (Δx, Δg, 1/Δgᵀ Δx) pair at slot (count−1) mod m (zeros at
    count 0), scale the identity by Δgᵀ Δx / |Δg|² (min(1, 1/|g|) at
    count 0), and apply the two-loop product to grad.  Returns (P g, state)."""
    m = memory_size
    count = st["count"]
    dtype = grad.dtype
    zero = torch.zeros((), dtype=dtype, device=grad.device)
    first = (count == 0)[:, None]
    dp = torch.where(first, zero, x - st["params"])
    du = torch.where(first, zero, grad - st["updates"])
    vd = _vdot(du, dp)
    weight = torch.where(vd == 0.0, zero, 1.0 / vd)
    slot = torch.nn.functional.one_hot((count - 1) % m, m).bool()  # (K, m)
    dparams = torch.where(slot[:, :, None], dp[:, None, :], st["dparams"])
    dupdates = torch.where(slot[:, :, None], du[:, None, :], st["dupdates"])
    weights = torch.where(slot, weight[:, None], st["weights"])
    den = _vdot(du, du)
    scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
    capped = torch.minimum(torch.ones_like(den), 1.0 / torch.sqrt(_vdot(grad, grad)))
    scale = torch.where(count > 0, scale, capped)

    pick = lambda t, j: torch.gather(t, 1, j[:, None, None].expand(-1, 1, t.shape[-1]))[:, 0]
    rho = lambda j: torch.gather(weights, 1, j[:, None])[:, 0]
    vec = grad
    alphas = [None] * m
    for i in reversed(range(m)):  # newest pair first
        j = (count + i) % m
        alphas[i] = rho(j) * _vdot(pick(dparams, j), vec)
        vec = vec - alphas[i][:, None] * pick(dupdates, j)
    vec = scale[:, None] * vec
    for i in range(m):  # oldest pair first
        j = (count + i) % m
        beta = rho(j) * _vdot(pick(dupdates, j), vec)
        vec = vec + (alphas[i] - beta)[:, None] * pick(dparams, j)
    return vec, dict(count=count + 1, params=x, updates=grad, dparams=dparams,
                     dupdates=dupdates, weights=weights)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa) with slope fpa at a, (b, fb)
    and (c, fc) (optax `_cubicmin`); NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    t = db * dc
    denom = t * t * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc * dc * r1 + (-(db * db)) * r2) / denom
    B = ((-(dc * dc * dc)) * r1 + db * db * db * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa) with slope fpa at a
    and (b, fb) (optax `_quadmin`)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(step, value, slope, value0, slope0):
    """Armijo, or Hager–Zhang's approximate decrease near a minimiser, as
    optax: max(min(approx, armijo), 0) with NaN → inf."""
    armijo = value - value0 - SLOPE_RTOL * step * slope0
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope0
    approx = torch.maximum(approx, value - value0 - APPROX_DEC_RTOL * torch.abs(value0))
    err = torch.clamp_min(torch.minimum(approx, armijo), 0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, torch.inf), err)


def _curvature_error(slope, slope0):
    err = torch.clamp_min(torch.abs(slope) - CURV_RTOL * torch.abs(slope0), 0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, torch.inf), err)


def _zoom_linesearch(value_and_grad, x, u, value0, grad0, active):
    """optax's zoom line search along u from x, for every row of `active`,
    each with its own state machine (`lax.cond(interval_found, zoom,
    search)` per row, then the safe step on failure).  Every step makes one
    objective call over all rows, a row no longer searching at its own
    point.  Returns (stepsize, value, grad) at the accepted step; inactive
    rows return step 0."""
    where = torch.where
    slope0 = _vdot(u, grad0)
    zero = torch.zeros_like(value0)
    s = dict(count=torch.zeros_like(value0, dtype=torch.long), step=zero, value=value0,
             grad=grad0, slope=slope0, dec=torch.full_like(value0, torch.inf),
             found=torch.zeros_like(active), done=~active, failed=torch.zeros_like(active),
             low=zero, v_low=value0, s_low=slope0, high=zero, v_high=value0, s_high=slope0,
             ref=zero, v_ref=value0, safe=zero, v_safe=value0, g_safe=grad0)
    while True:
        live = ~(s["done"] | s["failed"])
        if not bool(live.any()):
            return s["step"], s["value"], s["grad"]
        count, found = s["count"], s["found"]
        low, high, v_low, v_high = s["low"], s["high"], s["v_low"], s["v_high"]
        # the interval search's next point, and the zoom's
        grown = where(count == 0, torch.ones_like(zero), INCREASE_FACTOR * s["step"])
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mid_c = _cubicmin(low, v_low, s["s_low"], high, v_high, s["ref"], s["v_ref"])
        use_c = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, v_low, s["s_low"], high, v_high)
        use_q = ~use_c & (mid_q > left + 0.1 * delta) & (mid_q < right - 0.1 * delta)
        middle = where(use_c, mid_c, s["ref"])
        middle = where(use_q, mid_q, middle)
        middle = where(~use_c & ~use_q, (low + high) / 2.0, middle)
        t = where(found, middle, grown)

        # every row is evaluated (the objective's rows may carry their own
        # data, as the compromise's ε): a finished row at its own point
        value, grad = value_and_grad(x + torch.where(live, t, zero)[:, None] * u)
        slope = _vdot(grad, u)
        dec = _decrease_error(t, value, slope, value0, slope0)
        err = torch.maximum(dec, _curvature_error(slope, slope0))
        ok = dec <= 0.0
        last = count + 1 >= ZOOM_STEPS
        # interval search (Nocedal & Wright, Algorithm 3.5)
        hi_new = (dec > 0.0) | ((value >= s["value"]) & (count > 0))
        lo_new = (slope >= 0.0) & ~hi_new
        prev = (s["step"], s["value"], s["slope"])
        cur = (t, value, slope)
        srch_lo = [where(lo_new, c, p) for c, p in zip(cur, prev)]
        srch_hi = [where(lo_new, p, c) for c, p in zip(cur, prev)]
        srch_done = err <= 0.0
        srch = dict(found=hi_new | lo_new | srch_done, done=srch_done, failed=last & ~srch_done,
                    low=srch_lo[0], v_low=srch_lo[1], s_low=srch_lo[2],
                    high=srch_hi[0], v_high=srch_hi[1], s_high=srch_hi[2],
                    ref=srch_lo[0], v_ref=srch_lo[1],
                    safe=where(ok, t, s["safe"]), v_safe=where(ok, value, s["v_safe"]),
                    g_safe=where(ok[:, None], grad, s["g_safe"]))
        # zoom (Nocedal & Wright, Algorithm 3.6)
        better = ok & (value < s["v_safe"])
        safe = where(better, t, s["safe"])
        to_mid = (dec > 0.0) | (value >= v_low)
        to_low = (slope * (high - low) >= 0.0) & ~to_mid
        olds = ((high, v_high, s["s_high"]), (low, v_low, s["s_low"]))
        new_hi = [where(to_low, lo_, where(to_mid, c, hi_)) for c, hi_, lo_ in zip(cur, *olds)]
        new_lo = [where(~to_mid, c, lo_) for c, lo_ in zip(cur, olds[1])]
        moved = to_mid | to_low
        zoom_done = err <= 0.0
        zoom = dict(found=found, done=zoom_done,
                    failed=(last | ((delta <= STEPSIZE_PRECISION) & (safe > 0.0))) & ~zoom_done,
                    low=new_lo[0], v_low=new_lo[1], s_low=new_lo[2],
                    high=new_hi[0], v_high=new_hi[1], s_high=new_hi[2],
                    ref=where(moved, high, low), v_ref=where(moved, v_high, v_low),
                    safe=safe, v_safe=where(better, value, s["v_safe"]),
                    g_safe=where(better[:, None], grad, s["g_safe"]))
        new = {k: where(found if v.dim() == 1 else found[:, None], v, srch[k]) for k, v in zoom.items()}
        new.update(count=count + 1, step=t, value=value, grad=grad, slope=slope, dec=dec)
        # on failure: the best step with sufficient decrease, else (if the
        # step left the domain) none, else the last step tried
        use_safe = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new["step"] = where(use_safe, new["safe"], t)
        new["value"] = where(use_safe, new["v_safe"], value)
        new["grad"] = where(use_safe[:, None], new["g_safe"], grad)
        s = _select(live, new, s)


def lbfgs_stepper(
    fun: Callable[[torch.Tensor], torch.Tensor],
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
):
    """The JAX package's `lbfgs_stepper` (optax L-BFGS with its zoom line
    search) over a leading instance axis; returns `(init, run)`.

    `init(x0)` takes x0 (K, d) and returns the carry (x, state, it, gnorm);
    `run(carry, n_steps)` advances every instance that is still active
    (it < min(it0 + n_steps, max_iter) and gnorm > tol), all active
    instances one iteration at a time, as `vmap` of the JAX `while_loop`
    does.  An iteration takes f(x) and ∇f(x) from the previous line search
    when that value is finite (else it evaluates them), preconditions, and
    runs the zoom search along −P∇f; gnorm is |∇f| at the iteration's start
    point, as in JAX.  Values and gradients come from
    `GraphedValueAndGrad` (a CUDA graph on the card, eager on the CPU)."""
    value_and_grad = GraphedValueAndGrad(fun)

    def init(x0):
        K, d = x0.shape
        zeros = lambda *shape: torch.zeros(shape, dtype=x0.dtype, device=x0.device)
        state = dict(count=torch.zeros((K,), dtype=torch.long, device=x0.device),
                     params=zeros(K, d), updates=zeros(K, d), dparams=zeros(K, memory_size, d),
                     dupdates=zeros(K, memory_size, d), weights=zeros(K, memory_size),
                     value=torch.full((K,), torch.inf, dtype=x0.dtype, device=x0.device),
                     grad=zeros(K, d))
        it = torch.zeros((K,), dtype=torch.long, device=x0.device)
        return (x0, state, it, torch.full((K,), torch.inf, dtype=x0.dtype, device=x0.device))

    def step(carry, active):
        x, st, it, _ = carry
        value, grad = st["value"], st["grad"]
        stale = active & ~torch.isfinite(value)
        if bool(stale.any()):
            f, g = value_and_grad(x)
            value = torch.where(stale, f, value)
            grad = torch.where(stale[:, None], g, grad)
        lbfgs = {k: st[k] for k in ("count", "params", "updates", "dparams", "dupdates", "weights")}
        direction, lbfgs = _lbfgs_precondition(grad, x, lbfgs, memory_size)
        u = -direction
        lr, v_new, g_new = _zoom_linesearch(value_and_grad, x, u, value, grad, active)
        gnorm = torch.sqrt(_vdot(grad, grad))
        return (x + lr[:, None] * u, dict(lbfgs, value=v_new, grad=g_new), it + 1, gnorm)

    def run(carry, n_steps: int):
        stop_at = torch.clamp(carry[2] + n_steps, max=max_iter)
        while True:
            active = (carry[2] < stop_at) & (carry[3] > tol)
            if not bool(active.any()):
                return carry
            carry = _select(active, step(carry, active), carry)

    return init, run


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
    linesearch: str = "zoom",
):
    """Bounded minimisation as `(init, run, finalize)` over a leading
    instance axis: `init(x0)` with x0 (K, d) in [lo, hi] → carry;
    `run(carry, n_steps)` → carry; `finalize(carry)` → `MinimizeResult` in
    the bounded coordinates.  `linesearch`: "zoom" (`lbfgs_stepper`; f(x)
    evaluated anew at the end, as in JAX) or "ladder"
    (`lbfgs_ladder_stepper`; f(x) taken from the carry)."""
    steppers = {"zoom": lbfgs_stepper, "ladder": lbfgs_ladder_stepper}
    if linesearch not in steppers:
        raise ValueError(f"linesearch={linesearch!r} is not one of {tuple(steppers)}")
    lo = torch.as_tensor(lo, dtype=dtype)
    hi = torch.as_tensor(hi, dtype=dtype)
    to_params, to_theta = bounded_transform(lo, hi)
    init0, run = steppers[linesearch](lambda theta: fun(to_params(theta)), max_iter=max_iter,
                                      tol=tol, memory_size=memory_size)

    def init(x0):
        return init0(to_theta(x0))

    def finalize(carry) -> MinimizeResult:
        x = to_params(carry[0])
        if linesearch == "ladder":
            f = carry[4]
        else:
            with torch.no_grad():
                f = fun(x)
        return MinimizeResult(x=x, fun=f, n_iter=carry[2], grad_norm=carry[3])

    return init, run, finalize


def minimize_lbfgs(fun, x0: torch.Tensor, max_iter: int = 200, tol: float = 1e-6,
                   memory_size: int = 15, linesearch: str = "zoom") -> MinimizeResult:
    """Unconstrained L-BFGS of every row of x0 (K, d) to tolerance or
    `max_iter`; `linesearch` "zoom" or "ladder"."""
    stepper = lbfgs_ladder_stepper if linesearch == "ladder" else lbfgs_stepper
    init, run = stepper(fun, max_iter=max_iter, tol=tol, memory_size=memory_size)
    carry = run(init(x0), max_iter)
    with torch.no_grad():
        f = fun(carry[0])
    return MinimizeResult(x=carry[0], fun=f, n_iter=carry[2], grad_norm=carry[3])


def minimize_bounded(fun, x0: torch.Tensor, lo: float = 0.0, hi: float = 1.0,
                     max_iter: int = 200, tol: float = 1e-6, memory_size: int = 15,
                     linesearch: str = "zoom") -> MinimizeResult:
    """Minimise fun(x) subject to lo ≤ x ≤ hi elementwise, for every row of
    x0 (K, d): the port's `scipy.optimize.minimize(method='L-BFGS-B')`
    stand-in, as in the JAX package."""
    init, run, fin = bounded_stepper(fun, lo=lo, hi=hi, max_iter=max_iter, tol=tol,
                                     memory_size=memory_size, dtype=x0.dtype,
                                     linesearch=linesearch)
    return fin(run(init(x0), max_iter))
