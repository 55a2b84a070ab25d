"""The cluster planner (the paper's contribution), the port's copy of
``repro.core``: the computation-graph IR (``graph``), the FPGA board and
network cost models (``cost_model``), the four distributed strategies
(``strategies``), the cluster's discrete-event simulator (``simulator``),
the cost-balanced stage partitioner (``partition``), strategy selection
and reconfiguration (``scheduler``), the lowering of a plan onto a
device mesh and the pipeline cut points of a model's stack
(``placement``), and the VTA knob search, microbatch choice, knob tables
and execution-pattern choice (``autotune``).  Pure Python: same names,
same numbers as the reference's, no backend imported.  Two parts time
the port's runtime and need torch: the measurement harness
(``measure``) and the measured knob search (``autotune.tune_runtime``,
which imports it when called)."""
