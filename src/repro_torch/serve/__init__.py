"""Serving-side parameter handling."""
