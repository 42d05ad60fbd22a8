"""Distributed layer: fault tolerance and the async actor–learner topology.

Submodules load lazily (PEP 562): the async tier's spawned actors import
``repro_torch.distributed.actor_learner`` in a fresh interpreter, and this
package must not import anything on their behalf. ``sharding`` holds the
Ocean half of ``repro/distributed/sharding.py`` (the data-parallel tier).
"""

_SUBMODULES = ("fault", "actor_learner", "sharding")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.distributed.{name}")
    raise AttributeError(
        f"module 'repro_torch.distributed' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
