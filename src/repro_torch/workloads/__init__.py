"""The port's workload zoo (PHOLD so far), each with a numpy oracle mirror."""
from .registry import conformance_spec, get_workload  # noqa: F401
