"""Per-layer metric readers, one file a metric, found by its name in
``BENCHMARK.json``: ``read(s)`` returns the metric's value from a traced
run (``harness.per_layer``'s ``s``), or None where it finds nothing."""
