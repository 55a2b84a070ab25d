"""Fault tolerance (the port of ``repro.ft``): straggler detection and
plan re-cuts (``straggler``), heartbeats (``health``), atomic checkpoints
(``checkpoint``), seeded fault plans (``faults``) and meshes reformed
from the surviving devices (``elastic.make_mesh_for``).  The training
supervisor and the elastic restore wait for a later slice."""
