"""Per-layer metric readers, one module a metric (README.md)."""
