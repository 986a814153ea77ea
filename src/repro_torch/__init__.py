"""Hermes / PIPELOAD ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``: it mirrors the
reference file for file where a file is ported, imports ``torch`` and
numpy (never JAX, never ``repro``), and runs on a CUDA device unless the
caller asks for the CPU.
"""
