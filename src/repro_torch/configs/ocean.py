"""Per-env training presets for the Ocean suite: a copy of
``repro/configs/ocean.py`` (the original eight, Ocean II and the league's
duel — all 13 envs the port registers).

One place records the knobs each scenario needs to solve (score > 0.9) in a
CI-smoke budget: policy width, LSTM for the memory env, the CNN frontend for
pixel envs, and the env-step budget. ``launch.train --ocean`` and the
tests read these so "train env X" never re-hardcodes per-env flags.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import TrainConfig


@dataclass(frozen=True)
class OceanPreset:
    hidden: int = 64
    recurrent: bool = False
    conv: bool = None                # None → env's obs_frontend attr decides
    total_steps: int = 200_000
    target_score: float = 0.9
    tcfg_overrides: tuple = ()       # ((field, value), ...) on the base tcfg


def ocean_tcfg(name: str, **overrides) -> TrainConfig:
    """The Ocean training config: the launcher's defaults + the env preset's
    overrides + caller overrides (highest precedence)."""
    base = dict(num_envs=64, unroll_length=64, update_epochs=4,
                num_minibatches=4, learning_rate=1e-3, gamma=0.95)
    base.update(dict(preset(name).tcfg_overrides))
    base.update(overrides)
    return TrainConfig(**base)


OCEAN_PRESETS = {
    "squared": OceanPreset(total_steps=300_000),
    "password": OceanPreset(total_steps=300_000),
    "stochastic": OceanPreset(),
    "memory": OceanPreset(recurrent=True, total_steps=500_000),
    "multiagent": OceanPreset(total_steps=150_000),
    "spaces": OceanPreset(),
    "bandit": OceanPreset(total_steps=150_000),
    "continuous": OceanPreset(total_steps=400_000),
    # Ocean II — budgets/overrides are where PPO (seed 0) solves with margin
    "pong": OceanPreset(),           # conv picked up from Pong.obs_frontend
    "drone": OceanPreset(total_steps=1_000_000,
                         # entropy bonus keeps the Gaussian σ too wide to
                         # hover precisely; solved at ~650k with it off
                         tcfg_overrides=(("ent_coef", 0.0),)),
    "tagteam": OceanPreset(total_steps=600_000,
                           tcfg_overrides=(("ent_coef", 0.003),)),
    "maze": OceanPreset(total_steps=1_000_000,   # procgen: fresh maze/episode
                        tcfg_overrides=(("gamma", 0.98),)),
    # Policy League — duel trains under self-play (launch.train --selfplay):
    # score vs the frozen pool hovers near 0.5 by construction, so the
    # solved criterion is arena winrate vs the random baseline, not score
    "duel": OceanPreset(total_steps=300_000, target_score=0.9),
}


def preset(name: str) -> OceanPreset:
    return OCEAN_PRESETS.get(name, OceanPreset())
