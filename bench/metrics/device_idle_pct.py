"""Share of the traced sub-window in which no operation ran on the card."""


def read(run):
    tr = run.window.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
