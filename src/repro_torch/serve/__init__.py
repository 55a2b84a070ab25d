"""Serving: steps (chunked prefill, greedy decode, verify, generate), the
paged KV cache and the continuous-batching engine."""
