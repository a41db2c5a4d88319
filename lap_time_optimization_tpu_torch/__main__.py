"""`python -m lap_time_optimization_tpu_torch <track> <vehicle> <width> --method`

The port's racing-line entry point (`cli/race.py`), mirroring
`python -m lap_time_optimization_tpu`.  The NMPC closed loop lives at
`python -m lap_time_optimization_tpu_torch.cli.mpc`.
"""

from lap_time_optimization_tpu_torch.cli.race import main

if __name__ == "__main__":
    main()
