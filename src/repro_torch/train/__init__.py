"""Training of the port (``repro/train``): AdamW, the train step, the
supervised loop."""
