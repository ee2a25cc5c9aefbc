"""Datasets: session loading, split, card-resident frame tables."""
