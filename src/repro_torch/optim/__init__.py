"""Optimizers as plain functions on tensors."""
