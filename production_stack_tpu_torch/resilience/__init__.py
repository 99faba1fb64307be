"""The engine's side of the resilience layer: request deadlines and the
tenant-fair admission order (copies of the JAX package's
``resilience/deadline.py`` and ``resilience/tenancy.py`` parts the engine
reads; the router's side is not ported)."""
