"""Utilities: logging, profiling, parameter-tree files."""

from .logger import create_logger  # noqa: F401
from .profiling import Throughput, profile_trace  # noqa: F401
