"""Measurement tools of the PyTorch/CUDA port, run as ``python -m``."""
