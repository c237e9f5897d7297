"""Hand-written Hopper kernels of the port (``csrc/``), their plain PyTorch
versions (``ref``) and the device-dispatching wrappers (``ops``)."""
