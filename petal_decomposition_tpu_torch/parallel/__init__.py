"""Fit pipelines (single device so far; see :mod:`.distributed`)."""
