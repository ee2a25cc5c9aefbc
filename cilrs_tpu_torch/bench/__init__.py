"""Measurement on the card: timing helpers and kernel A/B scripts."""
