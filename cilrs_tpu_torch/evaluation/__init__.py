"""Offline evaluation: predictions over a resident table, report metrics,
scores, the HUD and the residual breakdown."""
