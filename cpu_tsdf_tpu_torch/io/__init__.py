"""File formats of the port (numpy, no tensors)."""
