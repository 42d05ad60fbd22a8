"""Model layer of the port: params, layers, attention, the dense transformer
stack, the backbone policy, and the JAX-parameter converter."""
