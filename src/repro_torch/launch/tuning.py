"""The launchers' ``--autotune`` / ``--tuning-file`` (the reference
launchers' tuning block, shared by ``launch.serve`` and ``launch.train``).

``--autotune`` runs ``core.autotune.tune_runtime`` over the kinds whose
knobs the port's kernels honour, on the launcher's device, saves the
table to ``--tuning-file`` when one is given, and installs it with
``models.layers.set_tuning``.  ``--tuning-file`` alone loads a table and
installs it; a table whose ``device`` is neither ``"any"`` nor this
process's ``core.measure.device_signature`` exits with a message (the
reference applies such a table silently through this flag).  The table
stays installed for the launcher's run only: the previous one is back
when ``main`` returns.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def tuning_from(autotune: bool, tuning_file: str | None, *, cfg, kinds, device):
    """Tune or load a table per the two options and install it for the
    ``with`` body, which gets the table (None when neither option is
    given)."""
    from repro_torch.core.autotune import TuningTable, tune_runtime
    from repro_torch.core.measure import device_signature
    from repro_torch.models.layers import set_tuning, tuning_table

    if autotune:
        table = tune_runtime(cfg=cfg, kinds=tuple(kinds), save_path=tuning_file,
                             verbose=True, device=device).table
        if tuning_file:
            print(f"autotune: saved tuning table to {tuning_file}")
    elif tuning_file:
        table = TuningTable.load(tuning_file)
        here = device_signature(device)
        if table.device not in ("any", here):
            raise SystemExit(f"tuning table {tuning_file} was measured on "
                             f"{table.device!r}, not on this process's {here!r}: "
                             "re-run with --autotune")
        print(f"loaded tuning table {tuning_file}")
    else:
        table = None
    prev = set_tuning(table) if table is not None else tuning_table()
    try:
        yield table
    finally:
        set_tuning(prev)
