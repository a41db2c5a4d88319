"""Compute kernels: splines, velocity profiles, the ladder L-BFGS, the GP, and the
hand-written CUDA kernels (the whole AL-iLQR solve, the batched velocity profile)."""
