"""DTFL core of the port (pair: ``repro/core/``). Imports nothing eagerly."""
