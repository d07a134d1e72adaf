"""One reader per metric, end-to-end or per-layer, found by the
metric's name: read(obs) returns the value, or None where the window
gave it nothing to read."""
