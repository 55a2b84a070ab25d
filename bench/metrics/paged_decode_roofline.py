"""``paged_decode_kernel``'s share of its roofline in the traced
sub-window: the least time the card needs for the decode steps that fell
in it (``work.attention.paged_decode``, every layer) over the kernel's
device time."""

from bench.harness import peaks
from bench.harness.readings import decode_steps
from bench.work import attention


def read(run):
    tr = run.window.trace
    t = tr.kernel_s("paged_decode_kernel") if tr else 0.0
    if t <= 0:
        return None
    ops = nbytes = 0
    page = int(run.c["engine"]["page_size"])
    for kv_lens, unique in decode_steps(run.records, tr.t0, tr.t1, page):
        o, b = attention.paged_decode(run.c, kv_lens, unique)
        ops, nbytes = ops + o, nbytes + b
    layers = run.c["num_hidden_layers"]
    return 100.0 * peaks.bound_s(ops * layers, nbytes * layers, run.c["dtype"]) / t
