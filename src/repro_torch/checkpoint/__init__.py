"""Checkpoints of the trainer's state (``checkpoint/manager.py``)."""
