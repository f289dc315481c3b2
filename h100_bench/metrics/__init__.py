"""One reader per per-layer metric: ``read(run)`` returns the reading,
or None where the run has nothing for it to read."""
