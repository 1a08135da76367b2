"""The synthetic token stream (``data/pipeline.py``)."""
