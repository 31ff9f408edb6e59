"""Per-layer metrics, one reader a file: ``read(ctx)`` returns the metric's
value from a traced run's context, or None where it finds nothing to
read."""
