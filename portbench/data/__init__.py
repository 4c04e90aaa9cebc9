"""Data generators of the benchmark, found by a configuration's
``generator``."""
