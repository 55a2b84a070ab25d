"""Serving steps: chunked prefill, greedy decode, generate."""
