"""Entry points that drive the model stack."""
