"""Metrics of the engine: Prometheus text in plain Python."""
