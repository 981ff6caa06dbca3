"""Entry points of the port (pair: ``repro/launch/``)."""
