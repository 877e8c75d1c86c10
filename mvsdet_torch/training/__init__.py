"""Optimizer and training loop of the port."""
