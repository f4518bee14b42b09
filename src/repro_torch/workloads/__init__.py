"""The port's workload zoo (the JAX package's seven ids), each with a numpy
oracle mirror; :func:`bench_path` builds one at the reference's bench
scale."""
from .registry import (all_workloads, bench_path, conformance_spec,  # noqa: F401
                       get_workload)
