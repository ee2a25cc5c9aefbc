"""Datasets: session loading, split, card-resident frame tables, on-card
collection, and resizing of external sessions (``prepare``)."""
