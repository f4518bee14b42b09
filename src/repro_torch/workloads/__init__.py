"""The port's workload zoo (phold, phold-hotspot, queueing, cluster), each
with a numpy oracle mirror."""
from .registry import all_workloads, conformance_spec, get_workload  # noqa: F401
