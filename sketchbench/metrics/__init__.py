"""Metric readers: ``<name>.py`` defines ``read(run) -> float | None``."""
