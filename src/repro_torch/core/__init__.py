"""Spaces, emulation and vectorization (the paper's §3.1 and §3.3)."""
