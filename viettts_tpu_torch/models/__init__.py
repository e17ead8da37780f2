"""The port's models: inference, and the training forward of the duration
and acoustic models."""
