"""Synthetic data generators of the port."""
