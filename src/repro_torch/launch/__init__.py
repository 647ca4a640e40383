"""Launchers (a port of ``repro.launch``): ``serve`` and ``train``; ``mesh``
(mesh shapes, the production meshes, a ``DeviceMesh`` over a process
group, the exchange plane's lane topology), ``sharding`` (the sharding
rules) and ``pipeline`` (GPipe over a process group)."""
