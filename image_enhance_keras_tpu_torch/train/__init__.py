"""Checkpoint loading (the training slice comes later)."""
