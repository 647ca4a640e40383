"""Launchers (a port of ``repro.launch``): ``serve``, and ``mesh``'s lane
topology for the stacked workers."""
