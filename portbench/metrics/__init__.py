"""One reader a per-layer metric: ``portbench/metrics/<base>.py`` reads
the metrics named ``<base>`` and ``<base>.<split>`` (the split names the
end-to-end metric it moves).  ``read(outcome)`` (a
``portbench.cells.common.Outcome``: its ``trace``, the window's ``work``,
``memory_peak_bytes``) returns the number, or ``None`` where the cell
gives it nothing to read (the harness then leaves the metric out of the
line); a share of a roofline or a peak is never made up as 0."""
