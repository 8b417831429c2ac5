"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and per-layer readers by name, drives the program, times it, reads
its counters and trace, and checks its output against the plain reference.
"""
