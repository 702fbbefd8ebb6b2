"""Synthetic training data (NumPy only)."""
