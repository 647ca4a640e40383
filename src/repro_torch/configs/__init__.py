"""Architecture and shape configurations (a copy of ``repro.configs``:
pure data, no framework)."""
