"""Batched environments: the protocol (``base``) and the Ocean suite."""
