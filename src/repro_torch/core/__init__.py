"""Data-driven layers of the thesis on the port: window autotune with
Hopper cost models, number-format emulation and the fixed-point search."""
