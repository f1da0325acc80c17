"""Sample workflows of the port (``samples/lm.py``: LM training)."""
