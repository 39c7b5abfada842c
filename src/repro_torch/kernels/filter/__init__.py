"""The ramp filter kernel: `kernel.filter_rows` and its tables."""
