"""The system under test: the PyTorch and CUDA port's closed loops.

The only module of the benchmark that imports the port.  `System` builds
the model, the OCP parameters and the solver configuration that a
configuration file states, through the port's public API (the vehicle from
the configuration's numbers, the track tables by `mpc.track.load` from the
racing-line artifacts), and runs one request: one call of
`runner.closed_loop` (B = 1) or `runner.closed_loop_batch`, ending in the
copy of its `SimResult` to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


class System:
    def __init__(self, config: dict, root: str, device: str):
        from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
        from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle
        from lap_time_optimization_tpu_torch.mpc import runner
        from lap_time_optimization_tpu_torch.mpc import track as mpc_track
        from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig

        self.runner = runner
        self.dtype, self.device = dtype_of(config["dtype"]), torch.device(device)
        art = config["artifacts"]
        track = mpc_track.load(art["vehicle"], art["track"], art["method"],
                               base_dir=os.path.join(root, art["base_dir"]))
        vehicle = PacejkaVehicle(name=config["vehicle"]["name"],
                                 **{k: v for k, v in config["vehicle"].items() if k != "name"})
        self.model = BicycleModel(vehicle, track).to(self.device, self.dtype)
        self.p = OCPParams(**config["ocp"]).to(self.device, self.dtype)
        self.cfg = SolverConfig(**config["solver"])

    def request(self, x0: np.ndarray, cycles: int) -> dict:
        """One request from x0 (B, 8): the port's loop over `cycles`
        control cycles, then its results on the host, each with the
        instance axis first."""
        x = torch.as_tensor(x0, dtype=self.dtype).to(self.device)
        if x.shape[0] == 1:
            res = self.runner.closed_loop(self.model, self.p, self.cfg, x[0], cycles)
            return {k: v.cpu().numpy()[None] for k, v in res._asdict().items()}
        res = self.runner.closed_loop_batch(self.model, self.p, self.cfg, x, cycles)
        return {k: v.cpu().numpy() for k, v in res._asdict().items()}

    def warm_up(self, x0: np.ndarray, cycles: int) -> None:
        """One request with the window's B and dtype and as few cycles as
        make every program the window's requests replay: G, and the tail
        program where G does not divide `cycles`."""
        G = self.runner.GRAPH_CYCLES
        self.request(x0, G + cycles % G if cycles > G else cycles)

    def close(self) -> None:
        """Drop the model and the device memory it holds."""
        self.model = self.p = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
