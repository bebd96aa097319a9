"""obs/ — the telemetry the port's server needs: the row schema, the metric
registry and the /metrics + /healthz endpoint (copies of the JAX package's
jax-free modules of the same names)."""
