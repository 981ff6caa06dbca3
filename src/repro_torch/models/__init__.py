"""Models of the port (pair: ``repro/models/``); ResNet only in this slice."""
