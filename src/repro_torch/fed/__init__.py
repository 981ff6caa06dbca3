"""Federated trainers of the port (pair: ``repro/fed/``). Imports nothing eagerly."""
