"""NMPC stack: artifact track, AL-iLQR solver, closed-loop runner."""
