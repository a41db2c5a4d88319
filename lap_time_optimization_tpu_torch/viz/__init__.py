"""Simulation replay plots (matplotlib, imported only when a plot is drawn)."""
