"""Compute kernels: splines, velocity profiles, the ladder L-BFGS, the GP, and the
hand-written CUDA kernels (fused AL-iLQR iteration, batched velocity profile)."""
