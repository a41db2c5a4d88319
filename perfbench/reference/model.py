"""Plain NumPy reference of the NMPC's plant and OCP pieces.

The curvilinear dynamic bicycle model with simplified Pacejka tyres
(states [s, n, mu, vx, vy, r, steer, throttle], inputs [steer rate,
throttle rate]), its explicit RK4 step and the step's Jacobian carried
through every RK4 stage, the track lookups (piecewise linear on a uniform
arc grid, wrapped over the lap), the stage and terminal costs, the
constraint rows and their Jacobians: the equations of the reference's
`src/mpc/model.py` and `src/mpc/controller.py` as the measured program
states them, written here again over arrays with any leading shape.

`Precision` fixes the arithmetic: float64, float32, or float32 whose
matrix products round both operands to TF32 (10 explicit mantissa bits),
as a tensor-core product does.
"""

from __future__ import annotations

import numpy as np

NX, NU = 8, 2
NZ = NX + NU
N_CON = 14
GRAV = 9.81
S, N, MU, VX, VY, R, DELTA, THROTTLE = range(8)


def round_tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest-even at TF32's 10 mantissa bits."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


class Precision:
    """`name` in ("float64", "float32", "tf32"): the dtype of every array
    and scalar, and how `mm` multiplies matrices."""

    def __init__(self, name: str):
        if name not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = np.float64 if name == "float64" else np.float32

    def mm(self, a, b):
        if self.name == "tf32":
            return np.matmul(round_tf32(a), round_tf32(b))
        return np.matmul(a, b)

    def mv(self, a, v):
        """a (..., m, n) times v (..., n)."""
        return self.mm(a, v[..., None])[..., 0]

    def arr(self, a):
        return np.asarray(a, dtype=self.dtype)


class Model:
    """Vehicle, OCP weights and limits, and the track tables, every number
    cast once to the precision's dtype."""

    VEHICLE = ("mass", "rotational_inertia", "length_f", "length_r", "width",
               "B_f", "C_f", "D_f", "B_r", "C_r", "D_r", "Cr_0", "Cr_2", "C_m")
    OCP = ("q_n", "q_mu", "q_B", "r_delta", "r_throttle", "vref_scale", "mu_max",
           "steer_max", "throttle_max", "dsteer_max", "dthrottle_max", "lateral_margin")

    def __init__(self, vehicle: dict, ocp: dict, tables, prec: Precision):
        self.prec = prec
        c = lambda v: prec.dtype(v)
        for name in self.VEHICLE:
            setattr(self, name, c(vehicle[name]))
        for name in self.OCP:
            setattr(self, name, c(ocp[name]))
        self.tables = np.stack([prec.arr(t) for t in (tables.k, tables.nl, tables.nr, tables.vref)])
        self.s_max = c(tables.s_max)
        self.n = self.tables.shape[1]
        self.inv_ds = c(self.n - 1) / self.s_max
        wheelbase = self.length_f + self.length_r
        self.Fn_f = self.length_r * self.mass * c(GRAV) / wheelbase
        self.Fn_r = self.length_f * self.mass * c(GRAV) / wheelbase
        self.kin = self.length_r / wheelbase
        self.arm = prec.arr([self.length_f, -self.length_r])
        self.Fy_scale = prec.arr([-self.Fn_f * self.D_f, -self.Fn_r * self.D_r])
        self.C_fr, self.B_fr = prec.arr([self.C_f, self.C_r]), prec.arr([self.B_f, self.B_r])
        self.half_len = c(0.5) * wheelbase
        self.half_wid = c(0.5) * self.width
        self.sq = {k: np.sqrt(getattr(self, k)) for k in ("q_n", "q_mu", "q_B", "r_delta", "r_throttle")}

    # ----------------------------------------------------------- lookups
    def _cell(self, s, rows):
        with np.errstate(invalid="ignore"):
            t = np.mod(s, self.s_max) * self.inv_ds
            i = np.minimum(np.maximum(np.floor(t).astype(np.int64), 0), self.n - 2)
        tab = self.tables[rows]
        return tab[..., i], tab[..., i + 1], t - i.astype(t.dtype)

    def lookup(self, s, rows=slice(None)):
        """The tables `rows` of (k, nl, nr, vref) at s: (rows, *s.shape).
        The cell's fraction lies in [0, 1] as it is (s is wrapped into the
        lap and the cell index kept in [0, n - 2]), so it needs no clip."""
        with np.errstate(invalid="ignore"):  # a diverged rung's NaN state looks up cell 0, as in the program
            t = np.mod(s, self.s_max) * self.inv_ds
            i = np.minimum(np.maximum(t.astype(np.int64), 0), self.n - 2)
        tab = self.tables[rows]
        frac = t - i.astype(t.dtype)
        return tab[..., i] * (1.0 - frac) + tab[..., i + 1] * frac

    def lookup_slope(self, s, rows=slice(None)):
        """`lookup` and the slopes d/ds (half the cell's slope exactly on a
        grid point, none past the table's ends)."""
        lo, hi, frac = self._cell(s, rows)
        fc = np.minimum(np.maximum(frac, 0.0), 1.0)
        gain = ((frac > 0.0) & (frac < 1.0)).astype(frac.dtype) + \
            self.prec.dtype(0.5) * ((frac == 0.0) | (frac == 1.0)).astype(frac.dtype)
        return lo * (1.0 - fc) + hi * fc, (hi - lo) * self.inv_ds * gain

    # ----------------------------------------------------------- dynamics
    def _forces(self, vx, vy, r, delta):
        yf, yr = vy + self.length_f * r, vy - self.length_r * r
        af = np.arctan2(yf, vx) - delta
        ar = np.arctan2(yr, vx)
        bf, br = self.B_f * af, self.B_r * ar
        Fy_f = -self.Fn_f * self.D_f * np.sin(self.C_f * np.arctan(bf))
        Fy_r = -self.Fn_r * self.D_r * np.sin(self.C_r * np.arctan(br))
        return yf, yr, bf, br, Fy_f, Fy_r

    def rhs(self, x, u):
        n, vx, vy, r = x[..., N], x[..., VX], x[..., VY], x[..., R]
        k = self.lookup(x[..., S], 0)
        cs, sn = np.cos(x[..., MU::4]), np.sin(x[..., MU::4])  # mu and steer
        y = vy[..., None] + self.arm * r[..., None]  # vy + lf r, vy - lr r
        alpha = np.arctan2(y, vx[..., None])
        alpha[..., 0] -= x[..., DELTA]
        Fy = self.Fy_scale * np.sin(self.C_fr * np.arctan(self.B_fr * alpha))
        Fy_f, Fy_r = Fy[..., 0], Fy[..., 1]
        sdot = (vx * cs[..., 0] - vy * sn[..., 0]) / (1.0 - n * k)
        Fx = self.C_m * x[..., THROTTLE] - self.Cr_0 - self.Cr_2 * vx * vx
        out = np.empty(x.shape, dtype=x.dtype)
        out[..., 0] = sdot
        out[..., 1] = vx * sn[..., 0] + vy * cs[..., 0]
        out[..., 2] = r - k * sdot
        out[..., 3] = (Fx - Fy_f * sn[..., 1] + self.mass * vy * r) / self.mass
        out[..., 4] = (Fy_r + Fy_f * cs[..., 1] - self.mass * vx * r) / self.mass
        out[..., 5] = (Fy_f * self.length_f * cs[..., 1] - Fy_r * self.length_r) / self.rotational_inertia
        out[..., 6:] = u
        return out

    def rhs_and_jacobian(self, x, u):
        """The RHS and its Jacobian over [x, u], (..., 8) and (..., 8, 10)."""
        s, n, mu, vx, vy, r, delta, thr = (x[..., i] for i in range(NX))
        m, lf, lr, Iz = self.mass, self.length_f, self.length_r, self.rotational_inertia
        k, dk = self.lookup_slope(s, 0)
        cos_mu, sin_mu = np.cos(mu), np.sin(mu)
        den = 1.0 - n * k
        num = vx * cos_mu - vy * sin_mu
        sdot = num / den
        sd = (sdot * n * dk / den, sdot * k / den, (-vx * sin_mu - vy * cos_mu) / den,
              cos_mu / den, -sin_mu / den)
        yf, yr, bf, br, Fy_f, Fy_r = self._forces(vx, vy, r, delta)
        gf = -self.Fn_f * self.D_f * np.cos(self.C_f * np.arctan(bf)) * self.C_f * self.B_f / (1.0 + bf * bf)
        gr = -self.Fn_r * self.D_r * np.cos(self.C_r * np.arctan(br)) * self.C_r * self.B_r / (1.0 + br * br)
        qf, qr = gf / (vx * vx + yf * yf), gr / (vx * vx + yr * yr)
        ff = (-yf * qf, vx * qf, lf * vx * qf, -gf)  # dFy_f / d(vx, vy, r, delta)
        fr = (-yr * qr, vx * qr, -lr * vx * qr)  # dFy_r / d(vx, vy, r)
        Fx = self.C_m * thr - self.Cr_0 - self.Cr_2 * vx * vx
        cos_d, sin_d = np.cos(delta), np.sin(delta)
        f = np.empty(x.shape, dtype=x.dtype)
        f[..., 0] = sdot
        f[..., 1] = vx * sin_mu + vy * cos_mu
        f[..., 2] = r - k * sdot
        f[..., 3] = (Fx - Fy_f * sin_d + m * vy * r) / m
        f[..., 4] = (Fy_r + Fy_f * cos_d - m * vx * r) / m
        f[..., 5] = (Fy_f * lf * cos_d - Fy_r * lr) / Iz
        f[..., 6] = u[..., 0]
        f[..., 7] = u[..., 1]
        J = np.zeros(x.shape + (NZ,), dtype=x.dtype)
        for j in range(5):
            J[..., 0, j] = sd[j]
        J[..., 1, 2], J[..., 1, 3], J[..., 1, 4] = num, sin_mu, cos_mu
        J[..., 2, 0] = -(dk * sdot + k * sd[0])
        for j in range(1, 5):
            J[..., 2, j] = -k * sd[j]
        J[..., 2, 5] = 1.0
        J[..., 3, 3] = (-2.0 * self.Cr_2 * vx - ff[0] * sin_d) / m
        J[..., 3, 4] = (-ff[1] * sin_d + m * r) / m
        J[..., 3, 5] = (-ff[2] * sin_d + m * vy) / m
        J[..., 3, 6] = (-ff[3] * sin_d - Fy_f * cos_d) / m
        J[..., 3, 7] = self.C_m / m
        J[..., 4, 3] = (fr[0] + ff[0] * cos_d - m * r) / m
        J[..., 4, 4] = (fr[1] + ff[1] * cos_d) / m
        J[..., 4, 5] = (fr[2] + ff[2] * cos_d - m * vx) / m
        J[..., 4, 6] = (ff[3] * cos_d - Fy_f * sin_d) / m
        J[..., 5, 3] = (ff[0] * lf * cos_d - fr[0] * lr) / Iz
        J[..., 5, 4] = (ff[1] * lf * cos_d - fr[1] * lr) / Iz
        J[..., 5, 5] = (ff[2] * lf * cos_d - fr[2] * lr) / Iz
        J[..., 5, 6] = (ff[3] * lf * cos_d - Fy_f * lf * sin_d) / Iz
        J[..., 6, 8] = 1.0
        J[..., 7, 9] = 1.0
        return f, J

    def step(self, x, u, h, substeps: int):
        """`substeps` explicit RK4 increments of size h."""
        h = self.prec.dtype(h)
        for _ in range(substeps):
            k1 = self.rhs(x, u)
            k2 = self.rhs(x + 0.5 * h * k1, u)
            k3 = self.rhs(x + 0.5 * h * k2, u)
            k4 = self.rhs(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    def step_and_jacobian(self, x, u, h, substeps: int):
        """`step` and its Jacobian over [x, u], (..., 8, 10), with the
        tangents carried through every RK4 stage."""
        h = self.prec.dtype(h)
        dX = np.broadcast_to(np.eye(NX, NZ, dtype=x.dtype), x.shape[:-1] + (NX, NZ))
        E = np.zeros((NX, NZ), dtype=x.dtype)
        E[DELTA, NX] = E[THROTTLE, NX + 1] = 1.0

        def stage(xs, dXs):
            f, J = self.rhs_and_jacobian(xs, u)
            return f, self.prec.mm(J[..., :NX], dXs) + E

        for _ in range(substeps):
            k1, d1 = stage(x, dX)
            k2, d2 = stage(x + 0.5 * h * k1, dX + 0.5 * h * d1)
            k3, d3 = stage(x + 0.5 * h * k2, dX + 0.5 * h * d2)
            k4, d4 = stage(x + h * k3, dX + h * d3)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            dX = dX + (h / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
        return x, dX

    # ------------------------------------------------------ costs and rows
    def stage_cost(self, z, u):
        x = z[..., :NX]
        vref = self.lookup(x[..., S], 3)
        mterm = self.q_n * x[..., N] ** 2 + self.q_mu * x[..., MU] ** 2 + x[..., VY] ** 2
        b = np.arctan(x[..., VY] / np.maximum(x[..., VX], self.prec.dtype(1e-3))) - \
            np.arctan(x[..., DELTA] * self.kin)
        lterm = mterm + (x[..., VX] - self.vref_scale * vref) ** 2 + self.q_B * b**2
        du = u - z[..., NX:]
        return lterm + (self.r_delta * du[..., 0] ** 2 + self.r_throttle * du[..., 1] ** 2)

    def terminal_cost(self, z):
        x = z[..., :NX]
        return self.q_n * x[..., N] ** 2 + self.q_mu * x[..., MU] ** 2 + x[..., VY] ** 2

    def constraints(self, z, u, margin):
        """The 14 stage inequalities g <= 0 with the lateral band shrunk by
        `margin` (0: the true band)."""
        x = z[..., :NX]
        nl, nr = self.lookup(x[..., S], slice(1, 3))
        mu = x[..., MU]
        lon = self.half_len * np.sin(np.abs(mu))
        lat = self.half_wid * np.cos(mu)
        g = np.empty(x.shape[:-1] + (N_CON,), dtype=x.dtype)
        g[..., 0] = x[..., N] - lon + lat - nl + margin
        g[..., 1] = -x[..., N] + lon + lat - nr + margin
        g[..., 2] = -x[..., S]
        g[..., 3] = mu - self.mu_max
        g[..., 4] = -mu - self.mu_max
        g[..., 5] = -x[..., VX]
        g[..., 6] = x[..., DELTA] - self.steer_max
        g[..., 7] = -x[..., DELTA] - self.steer_max
        g[..., 8] = x[..., THROTTLE] - self.throttle_max
        g[..., 9] = -x[..., THROTTLE] - self.throttle_max
        g[..., 10] = u[..., 0] - self.dsteer_max
        g[..., 11] = -u[..., 0] - self.dsteer_max
        g[..., 12] = u[..., 1] - self.dthrottle_max
        g[..., 13] = -u[..., 1] - self.dthrottle_max
        return g

    def terminal_constraints(self, z, fill):
        """The state rows at u = 0 with the tightened band; the input rows
        (10-13) are `fill`."""
        g = self.constraints(z, np.zeros(z.shape[:-1] + (NU,), dtype=z.dtype), self.lateral_margin)
        g[..., 10:] = fill
        return g

    def stage_jacobians(self, z, u):
        """Residuals r (..., 7) with sum(r^2) the stage cost, tightened rows
        g (..., 14), and their Jacobians over [z, u]: (..., 7, 12), (..., 14, 12)."""
        x = z[..., :NX]
        s, mu, vx, vy, delta = x[..., S], x[..., MU], x[..., VX], x[..., VY], x[..., DELTA]
        lead = x.shape[:-1]
        dt = x.dtype
        (_, _, _, vref), (_, dnl, dnr, dvref) = self.lookup_slope(s)
        floor = self.prec.dtype(1e-3)
        vx_safe = np.maximum(vx, floor)
        du = u - z[..., NX:]
        r = np.empty(lead + (7,), dtype=dt)
        r[..., 0] = self.sq["q_n"] * x[..., N]
        r[..., 1] = self.sq["q_mu"] * mu
        r[..., 2] = vy
        r[..., 3] = vx - self.vref_scale * vref
        r[..., 4] = self.sq["q_B"] * (np.arctan(vy / vx_safe) - np.arctan(delta * self.kin))
        r[..., 5] = self.sq["r_delta"] * du[..., 0]
        r[..., 6] = self.sq["r_throttle"] * du[..., 1]
        lon = self.half_len * np.sin(np.abs(mu))
        lat = self.half_wid * np.cos(mu)
        g = self.constraints(z, u, self.lateral_margin)
        gate = (vx > floor).astype(dt) + self.prec.dtype(0.5) * (vx == floor).astype(dt)
        q = vy / vx_safe
        datan = self.sq["q_B"] / (1.0 + q * q)
        b = delta * self.kin
        Jr = np.zeros(lead + (7, NZ + NU), dtype=dt)
        Jr[..., 0, 1] = self.sq["q_n"]
        Jr[..., 1, 2] = self.sq["q_mu"]
        Jr[..., 2, 4] = 1.0
        Jr[..., 3, 0] = -self.vref_scale * dvref
        Jr[..., 3, 3] = 1.0
        Jr[..., 4, 3] = -datan * q / vx_safe * gate
        Jr[..., 4, 4] = datan / vx_safe
        Jr[..., 4, 6] = -self.sq["q_B"] * self.kin / (1.0 + b * b)
        Jr[..., 5, 8], Jr[..., 5, 10] = -self.sq["r_delta"], self.sq["r_delta"]
        Jr[..., 6, 9], Jr[..., 6, 11] = -self.sq["r_throttle"], self.sq["r_throttle"]
        sign = np.where(mu >= 0, 1.0, -1.0).astype(dt)
        lon_mu = self.half_len * np.cos(np.abs(mu)) * sign
        lat_mu = -self.half_wid * np.sin(mu)
        Jg = np.zeros(lead + (N_CON, NZ + NU), dtype=dt)
        Jg[..., 0, 0], Jg[..., 0, 1], Jg[..., 0, 2] = -dnl, 1.0, -lon_mu + lat_mu
        Jg[..., 1, 0], Jg[..., 1, 1], Jg[..., 1, 2] = -dnr, -1.0, lon_mu + lat_mu
        for row, col, v in ((2, S, -1), (3, MU, 1), (4, MU, -1), (5, VX, -1), (6, DELTA, 1),
                            (7, DELTA, -1), (8, THROTTLE, 1), (9, THROTTLE, -1), (10, NZ, 1),
                            (11, NZ, -1), (12, NZ + 1, 1), (13, NZ + 1, -1)):
            Jg[..., row, col] = v
        return r, g, Jr, Jg
