"""Fault tolerance of the port: straggler detection and restarts."""
