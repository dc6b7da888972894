"""Frozen operation and byte counts, one module per configuration."""
