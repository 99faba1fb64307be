"""Multi-GPU layout and the rank runtime (the JAX package's ``parallel``).

``mesh``: the five parallel axes, their order and the rank grid that
gives each global rank its coordinate on each axis. ``distributed``: the
process groups of one rank, the host-0 bridge the step descriptions
cross, and the chart's ``PST_*`` environment.
"""
