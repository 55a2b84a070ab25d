"""Fault tolerance (the port of ``repro.ft``): straggler detection and
plan re-cuts (``straggler``), heartbeats (``health``), atomic checkpoints
(``checkpoint``) and seeded fault plans (``faults``).  The training
supervisor and elastic restore (``ft/supervisor``, ``ft/elastic``) wait
for the distributed runtime."""
