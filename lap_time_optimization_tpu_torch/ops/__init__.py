"""Compute kernels: closed-curve splines and the fused AL-iLQR iteration."""
