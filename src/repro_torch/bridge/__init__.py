"""HostBridge: one-line wrappers for third-party host environments.

    from repro_torch import bridge
    venv = bridge.wrap(lambda: MyGymnasiumEnv(), num_envs=8)

Auto-detects Gymnasium / PettingZoo-parallel / duck-typed ``reset``+``step``
APIs, derives emulation specs from ``core/emuspec``, and exposes the
VecEnv batch protocol over the first-finisher ``core/host.HostPool``.
``make_host_engine`` lifts a wrapped env into the TrainEngine's async
``host`` tier. See ``bridge/vecenv.py`` and ``bridge/adapters.py``. The
counterpart of ``repro/bridge``; it imports no torch (spawned host-pool
workers import this package).
"""
from repro_torch.bridge.adapters import (ADAPTERS, APIS, DuckAdapter,
                                         GymnasiumAdapter, PettingZooAdapter,
                                         convert_space, detect_api,
                                         np_emulate_obs, np_unemulate_action,
                                         np_unemulate_bytes, spaces_of)
from repro_torch.bridge.vecenv import HostVecEnv, make_host_engine, wrap

__all__ = [
    "ADAPTERS", "APIS", "DuckAdapter", "GymnasiumAdapter",
    "PettingZooAdapter", "HostVecEnv", "convert_space", "detect_api",
    "make_host_engine", "np_emulate_obs", "np_unemulate_action",
    "np_unemulate_bytes", "spaces_of", "wrap",
]
