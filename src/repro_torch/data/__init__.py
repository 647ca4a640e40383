"""Synthetic workload generators (numpy), copied from ``repro.data``."""
