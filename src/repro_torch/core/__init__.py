"""Planner core of the PyTorch port: regions, analysis, search, cache."""
