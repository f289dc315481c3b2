"""Benchmarks of the port: the seven-model suite (``suite.py``)."""
