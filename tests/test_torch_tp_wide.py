"""Tensor and expert parallelism on the (1, 4) and (2, 2) meshes: the cases
of ``tests/test_torch_tp.py`` (its docstring says what each holds) whose
mesh shapes are these, in a module of their own so that their spawns and
the reference's compiles run beside the (1, 2) and (2, 1) ones, on another
worker.  The fixtures and the case tests are ``test_torch_tp``'s; they take
their cases from this module's ``SHAPES``.
"""

import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

from test_torch_tp import (  # noqa: E402,F401  (fixtures and tests collected here)
    one_process,
    pytest_generate_tests,
    ref_inputs,
    reference,
    reference_run,
    runs,
    test_compressor_error_feedback,
    test_placed_state_bytes_equal_the_stand_in,
    test_processes_hold_the_reference_slices,
    test_routing_across_a_model_group,
    test_static_serving_per_mesh_position,
    test_train_metrics,
    test_train_params,
)

SHAPES = [(1, 4), (2, 2)]
