"""Logging and repo-asset helpers."""
