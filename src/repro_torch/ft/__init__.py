"""Fault tolerance (the port of ``repro.ft``): straggler detection and
plan re-cuts (``straggler``), heartbeats (``health``), atomic checkpoints
(``checkpoint``), seeded fault plans (``faults``), meshes reformed from
the surviving devices and the placed restore onto them (``elastic``),
and the training supervisor that closes the loop (``supervisor``)."""
