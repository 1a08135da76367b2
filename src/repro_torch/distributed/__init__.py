"""Train, prefill and decode steps (``distributed/steps.py``)."""
