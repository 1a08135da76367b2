"""Train, prefill and decode steps (``distributed/steps.py``) and the
sharding rules over ``torch.distributed`` (``distributed/sharding.py``)."""
