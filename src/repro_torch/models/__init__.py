"""Models of the port (pair: ``repro/models/``): the ResNet and the dense transformer."""
