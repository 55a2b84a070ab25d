"""``flash_mma_kernel``'s share of its roofline in the traced sub-window:
the least time the card needs for the prompt rows prefilled in it
(``work.attention.flash_prefill`` per chunk, every layer; pad rows not
counted) over the kernel's device time."""

from bench.harness import peaks
from bench.harness.readings import prefill_chunks
from bench.work import attention


def read(run):
    tr = run.window.trace
    t = tr.kernel_s("flash_mma_kernel") if tr else 0.0
    if t <= 0:
        return None
    ops = nbytes = 0
    chunk = int(run.c["engine"]["prefill_chunk"])
    for off, rows in prefill_chunks(run.records, tr.t0, tr.t1, chunk):
        o, b = attention.flash_prefill(run.c, off, rows)
        ops, nbytes = ops + o, nbytes + b
    layers = run.c["num_hidden_layers"]
    return 100.0 * peaks.bound_s(ops * layers, nbytes * layers, run.c["dtype"]) / t
