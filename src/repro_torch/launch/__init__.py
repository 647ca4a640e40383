"""Launchers (a port of ``repro.launch``): ``serve``."""
