"""Model configurations of the port (``repro/configs``): the schema and the
architectures that the ported slices can run."""
