"""Data layer of the port: synthetic LM rollout batches (``buffer``)."""
