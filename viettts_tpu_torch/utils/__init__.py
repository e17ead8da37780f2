"""Metrics of the port."""
