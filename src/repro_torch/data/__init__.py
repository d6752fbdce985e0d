"""Synthetic training data and its host pipeline (port of ``repro/data``)."""
