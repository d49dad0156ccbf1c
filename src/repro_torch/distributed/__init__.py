"""Logical-axis sharding of the port's parameters and caches over a
``DeviceMesh``."""
