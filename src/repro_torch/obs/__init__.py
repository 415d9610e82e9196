"""Observability of the port: trace spans, in-step metrics, the JSONL sink."""
