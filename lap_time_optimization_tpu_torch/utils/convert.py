"""Parameters carried across from the JAX package as plain numpy arrays.

The system has no weights: its parameters are the vehicle's, the track's
lookup tables and `OCPParams`.  Each function takes a dict of numpy arrays
keyed by the JAX dataclass field names (e.g. filled with
`{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}`)
and returns the port's module, in the arrays' dtype on the CPU, so both
packages can run on bit-identical parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from lap_time_optimization_tpu_torch import track as race_track
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams
from lap_time_optimization_tpu_torch.mpc.track import GEOMETRY_FIELDS, LOOKUP_FIELDS, MPCTrack


def _floats(d: dict, names) -> dict:
    return {k: torch.from_numpy(np.array(d[k])) for k in names if d.get(k) is not None}


def _cast(module, d: dict, names):
    """Buffers are created in float64; cast to the arrays' own dtype."""
    return module.to(torch.from_numpy(np.array(d[names[0]])).dtype)


def vehicle_from_numpy(d: dict) -> PacejkaVehicle:
    return _cast(PacejkaVehicle(name=str(d.get("name", "")), **_floats(d, PacejkaVehicle.FIELDS)),
                 d, PacejkaVehicle.FIELDS)


def race_track_from_numpy(d: dict) -> race_track.Track:
    """The racing-line `Track` from the JAX `Track`'s fields: the geometry
    arrays plus `closed`, `size`, `ns`, `name` and `decongest_stride`."""
    return _cast(race_track.Track(closed=bool(d["closed"]), size=int(d["size"]), ns=int(d["ns"]),
                                  name=str(d.get("name", "")),
                                  decongest_stride=int(d.get("decongest_stride", 3)),
                                  **_floats(d, race_track.FIELDS)),
                 d, race_track.FIELDS)


def track_from_numpy(d: dict) -> MPCTrack:
    return MPCTrack(closed=bool(d.get("closed", True)),
                    **_floats(d, LOOKUP_FIELDS + GEOMETRY_FIELDS))


def ocp_params_from_numpy(d: dict) -> OCPParams:
    return _cast(OCPParams(**_floats(d, OCPParams.FIELDS)), d, OCPParams.FIELDS)


def model_from_numpy(vehicle: dict, track: dict, enable_torque_vectoring: bool = False,
                     enable_traction_ellipse: bool = False) -> BicycleModel:
    return BicycleModel(vehicle_from_numpy(vehicle), track_from_numpy(track),
                        enable_torque_vectoring=enable_torque_vectoring,
                        enable_traction_ellipse=enable_traction_ellipse)
