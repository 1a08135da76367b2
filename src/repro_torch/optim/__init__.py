"""AdamW and its schedule (``optim/adamw.py``)."""
