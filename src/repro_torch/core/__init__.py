"""Spaces, emulation, vectorization and the env pools (the paper's §3.1
and §3.3): the device ``Pool`` and the host ``HostPool``."""
