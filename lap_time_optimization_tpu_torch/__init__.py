"""lap_time_optimization_tpu_torch — the PyTorch/CUDA port of `lap_time_optimization_tpu`.

The JAX package beside it is the reference; this package mirrors its layout
(`utils/`, `models/`, `ops/`, `optim/`, `mpc/`, `cli/`, `viz/`, `track.py`)
so each counterpart sits at the same relative path.  It imports `torch` and
numpy, never `jax`, and importing it needs no CUDA toolkit: the hand-written
kernels under `csrc/` are compiled with `nvcc` at their first launch on a
CUDA tensor.

Ported so far: the closed-loop NMPC (artifacts → track tables → bicycle RK4 →
AL-iLQR, one CUDA kernel launch per solve → closed loop), as a single
stream, in checkpointed chunks and as a batched fleet, with the replay plots;
and the batched racing-line global searches (`optim/global_search`: the
nonlinear multi-start and the Bayesian search), whose batched forward
evaluation runs the CUDA velocity-profile kernel.
"""

__version__ = "0.1.0"
