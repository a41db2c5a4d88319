"""Racing-line searches: the batched nonlinear multi-start and the Bayesian search."""
