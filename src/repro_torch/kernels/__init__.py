"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes
launchers, the plain PyTorch versions (``ref``) and the device-dispatching
wrappers with launch counters (``ops``)."""
from repro_torch.kernels import ops, ref  # noqa: F401
