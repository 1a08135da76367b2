"""Gradient compression (``fleet/compression.py``)."""
