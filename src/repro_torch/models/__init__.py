"""The model zoo of the port (PyTorch ``nn.Module``s), mirroring
``repro.models`` module for module; so far the recsys family and its
embedding substrate."""
