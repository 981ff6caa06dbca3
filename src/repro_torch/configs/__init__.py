"""Model configs of the port (pair: ``repro/configs/``)."""
