"""Fault tolerance of the port (``repro/ft``): supervised stepping."""
