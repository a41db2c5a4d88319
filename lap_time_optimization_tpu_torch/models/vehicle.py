"""Vehicle models as parameter modules with vectorised force laws.

Port of `lap_time_optimization_tpu/models/vehicle.py`.  Every parameter is a
0-d buffer, so `vehicle.to(device, dtype)` moves and casts the whole set.
`load_vehicle` builds float64 modules on the CPU; callers cast once.

* `PointMassVehicle` — tbr18-style point mass with a piecewise-linear engine
  map and a friction-circle traction law (reference src/vehicle.py:10-35).
* `PacejkaVehicle` — MX5-style car with Pacejka-parameterised tyres, drag
  terms and an elliptical max-force traction approximation
  (reference src/vehicleMX5.py:11-79).
"""

from __future__ import annotations

import torch
from torch import nn

from lap_time_optimization_tpu_torch.ops.spline import interp
from lap_time_optimization_tpu_torch.utils import io

GRAV = 9.81  # m s^-2


def _register(module: nn.Module, values: dict) -> None:
    for name, v in values.items():
        module.register_buffer(name, torch.as_tensor(v, dtype=torch.float64))


def _sqrt_or_zero(slack: torch.Tensor) -> torch.Tensor:
    """sqrt(slack) where positive, else 0 (the saturated friction branch).
    `torch.maximum`, as `jnp.maximum` in the JAX package, splits the gradient
    at a tie where `clamp` would pass all of it."""
    safe = torch.maximum(slack, torch.full_like(slack, 1e-12))
    return torch.where(slack > 0.0, torch.sqrt(safe), torch.zeros_like(safe))


class PointMassVehicle(nn.Module):
    """Point-mass vehicle: engine map interpolation + friction circle."""

    FIELDS = ("mass", "friction_coef", "engine_v", "engine_f")

    def __init__(self, *, mass, friction_coef, engine_v, engine_f, name: str = ""):
        super().__init__()
        _register(self, dict(mass=mass, friction_coef=friction_coef,
                             engine_v=engine_v, engine_f=engine_f))
        self.name = name

    def engine_force(self, v: torch.Tensor) -> torch.Tensor:
        """Linear interpolation over the engine map (src/vehicle.py:25-27)."""
        return interp(v, self.engine_v, self.engine_f)

    def traction(self, v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Remaining longitudinal force on the friction circle:
        sqrt((μ m g)² − (m v² κ)²), clamped to 0 when saturated
        (src/vehicle.py:29-35)."""
        f = self.friction_coef * self.mass * GRAV
        f_lat = self.mass * v * v * k
        return _sqrt_or_zero(f * f - f_lat * f_lat)


class PacejkaVehicle(nn.Module):
    """Pacejka-parameterised car (MX5): the full parameter set used by both
    the quasi-static racing-line solver and the NMPC bicycle model."""

    FIELDS = (
        "mass", "rotational_inertia", "length_f", "length_r", "width",
        "B_f", "C_f", "D_f", "B_r", "C_r", "D_r", "Cr_0", "Cr_2", "ptv",
        "C_m", "T", "friction_coef", "ro_long",
    )

    def __init__(self, *, name: str = "", **params):
        super().__init__()
        missing = set(self.FIELDS) - set(params)
        if missing:
            raise TypeError(f"PacejkaVehicle missing parameters: {sorted(missing)}")
        _register(self, {f: params[f] for f in self.FIELDS})
        self.name = name

    def engine_force(self, v: torch.Tensor) -> torch.Tensor:
        """Max longitudinal force T·C_m − Cr0 − Cr2·v² (src/vehicleMX5.py:19-21)."""
        return self.T * self.C_m - self.Cr_0 - self.Cr_2 * v * v

    def traction(self, v: torch.Tensor, k: torch.Tensor, lam: float = 2.0) -> torch.Tensor:
        """Elliptical traction approximation with F_max = λ·D̄·m·g
        (src/vehicleMX5.py:23-37; D̄ averages front/rear peak factors)."""
        D = 0.5 * (self.D_f + self.D_r)
        f_max = lam * D * self.mass * GRAV
        f_lat = self.mass * v * v * k
        return _sqrt_or_zero(f_max * f_max - f_lat * f_lat)


def load_vehicle(name_or_path: str):
    """Load a vehicle JSON, dispatching on schema: files with an "engineMap"
    are point-mass vehicles, files with tyre tables are Pacejka."""
    path = io.resolve_vehicle(name_or_path)
    data = io.load_jsonc(path)
    if "engineMap" in data:
        return PointMassVehicle(
            mass=float(data["mass"]),
            friction_coef=float(data["frictionCoefficient"]),
            engine_v=[float(v) for v in data["engineMap"]["v"]],
            engine_f=[float(f) for f in data["engineMap"]["f"]],
            name=data["name"],
        )
    return PacejkaVehicle(
        mass=float(data["mass"]),
        rotational_inertia=float(data["rotational_inertia"]),
        length_f=float(data["length_f"]),
        length_r=float(data["length_r"]),
        width=float(data.get("width", 2.0)),
        B_f=float(data["frontTire"]["B_f"]),
        C_f=float(data["frontTire"]["C_f"]),
        D_f=float(data["frontTire"]["D_f"]),
        B_r=float(data["rearTire"]["B_r"]),
        C_r=float(data["rearTire"]["C_r"]),
        D_r=float(data["rearTire"]["D_r"]),
        Cr_0=float(data["Cr_0"]),
        Cr_2=float(data["Cr_2"]),
        ptv=float(data["ptv"]),
        C_m=float(data["control"]["C_m"]),
        T=float(data["control"]["T"]),
        friction_coef=float(data["control"]["lambda"]),
        ro_long=float(data["control"]["ro_long"]),
        name=data["name"],
    )
