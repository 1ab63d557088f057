"""Probes and benchmarks of the port, run on the card."""
