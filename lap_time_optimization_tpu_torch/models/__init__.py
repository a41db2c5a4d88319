"""Vehicle parameter modules and dynamics models."""

from lap_time_optimization_tpu_torch.models.vehicle import (  # noqa: F401
    PacejkaVehicle,
    PointMassVehicle,
    load_vehicle,
)
