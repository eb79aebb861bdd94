"""Data-parallel regex: host-side automaton compilation (the port's copy
of the JAX package's ``regex/``); the device scans over char matrices
come with ``ops/regex.py``."""

from .compile import RegexUnsupported, compile_regex, parse  # noqa: F401
