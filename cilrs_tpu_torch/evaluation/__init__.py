"""Offline evaluation: predictions over a resident table, report metrics."""
