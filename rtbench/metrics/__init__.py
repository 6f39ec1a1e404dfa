"""One reader a metric of BENCHMARK.json, in ``<metric name>.py``, with
``read(run) -> float | None`` (``core.Run``). A reader that finds nothing
to read returns None, and the harness leaves the metric out."""
