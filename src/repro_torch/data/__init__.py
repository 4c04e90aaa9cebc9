"""Data substrate: the TPC-H generator (numpy, bit-identical to ``repro``'s)."""
