"""The benchmark harness of amico_tpu_torch: configurations, traffic and
per-layer metrics are found by name under ``benchmark/`` (see README.md)."""
