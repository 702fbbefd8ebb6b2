"""Accounting helpers for traced steps."""
