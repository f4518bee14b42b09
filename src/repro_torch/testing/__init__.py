"""The port's test harnesses: the clean-run contract (:mod:`.clean`), the
conformance face against its own oracle (:mod:`.conformance`) and the pinned
golden digests (:mod:`.golden`)."""
from .clean import CLEAN_COUNTERS, assert_clean, unclean_counters  # noqa: F401

__all__ = ["CLEAN_COUNTERS", "assert_clean", "unclean_counters"]
