"""One reader a per-layer metric, named as ``BENCHMARK.json`` names it
(dots become underscores): ``read(rec)`` takes the metric from the traced
run's record (``portbench.trace``) and returns its value, or None where
the record holds nothing for it, and the metric is then left out of the
result line. A reader that needs a measurement of its own takes it from
``rec["live"]`` (the program as the window left it) after the window has
closed."""
