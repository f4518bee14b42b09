"""Multi-device layout of the port: the sharding rules
(``repro/distributed/``)."""
