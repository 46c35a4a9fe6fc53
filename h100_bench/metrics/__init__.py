"""One reader a metric: ``metrics/<name>.py`` has ``read(run)``, which
returns the metric's value from a finished ``harness.main.Run``, or None
where the run gives nothing to read (the harness then leaves the metric out
of the line)."""
