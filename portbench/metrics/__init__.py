"""Per-layer metric readers: ``metrics/<metric>.py`` defines ``read(run)``,
which returns the metric's value from the run's spans and trace, or None
where the run holds nothing to read (the harness then leaves it out)."""
