"""Serving of the port (``repro/serve``): greedy prefill + decode."""
