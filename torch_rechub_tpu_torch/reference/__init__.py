"""Plain PyTorch references of the port's models, each in a file of its own that imports only ``torch``."""
