"""Serving: KV-cache prefill and decode with continuous batching."""
