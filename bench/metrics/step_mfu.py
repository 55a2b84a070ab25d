"""The whole step's share of the card's peak in the traced sub-window: the
model's operations (``work.model``) for every token processed in it,
prompt rows and decode rows, with the head of each token whose logits are
read, over the sub-window's seconds at the peak rate."""

from bench.harness import peaks
from bench.harness.readings import decode_contexts, prefill_chunks
from bench.work import model


def read(run):
    tr = run.window.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    c, ops = run.c, 0
    for kv in decode_contexts(run.records, tr.t0, tr.t1):
        ops += model.tokens(c, kv, 1) + model.head(c)
    for r in run.records:
        if r.times and tr.t0 <= r.times[0] <= tr.t1:
            ops += model.head(c)
    chunk = int(c["engine"]["prefill_chunk"])
    for off, rows in prefill_chunks(run.records, tr.t0, tr.t1, chunk):
        ops += model.tokens(c, off + 1, rows)
    if not ops:
        return None
    return 100.0 * ops / ((tr.t1 - tr.t0) * peaks.FLOPS[c["dtype"]])
