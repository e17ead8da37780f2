"""Tensor ops of the port: LSTM primitives and the two kernel wrappers."""
