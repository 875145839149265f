"""Measurement tools of the port; each runs on a CUDA card (``python -m``)."""
