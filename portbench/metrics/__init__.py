"""One reader a metric, named as the metric: ``read(run)`` takes the
harness's :class:`portbench.harness.Run` and returns the number, or None
where the run has nothing to read (the harness then leaves the metric
out). End-to-end readers take the host clock the harness kept; per-layer
readers the traced run's spans and device trace."""
