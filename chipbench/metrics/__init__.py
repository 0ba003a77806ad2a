"""One reader a per-layer metric, found by the metric's name:
``read(obs, ctx)`` returns the value, or None where the run has nothing
for it to read (the harness then leaves the metric out)."""
