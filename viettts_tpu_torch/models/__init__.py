"""The port's models (inference only)."""
