"""Drivers of the port (the reference keeps its drivers in ``examples/``)."""
