"""Corpus reading of the port: TextGrids and the training data loaders."""
