"""Offline synthetic data of the port (pair: ``repro/data/``)."""
