"""Plain PyTorch references the benchmark judges answers by, found by a
configuration's ``reference``."""
