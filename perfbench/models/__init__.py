"""Adapters between a configuration's model kind and the program; a
configuration names its kind under "model"."""
