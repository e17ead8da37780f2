"""Tensor ops of the port: LSTM primitives, the log-mel front-end and the
two kernel wrappers."""
