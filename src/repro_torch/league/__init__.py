"""Policy League: versioned policy store, rating-ranked opponent pool, and
the self-play arena — the counterpart of ``repro/league``.

    store.PolicyStore      — versioned frozen-policy archive over ckpt
    ranker.Ranker          — Elo over match records + opponent samplers
    arena.Arena            — batched round-robin match evaluation
    selfplay               — TrainEngine integration + the run_selfplay loop

CLI: ``python -m repro_torch.league arena --league-dir DIR --env duel``.
"""
from repro_torch.league.arena import Arena
from repro_torch.league.ranker import (OpponentSampler, Ranker,
                                       SAMPLER_STRATEGIES)
from repro_torch.league.selfplay import (LeagueResult, SelfPlay,
                                         SelfPlayCarry, build_league,
                                         make_selfplay_update, run_selfplay,
                                         selfplay_rollout)
from repro_torch.league.store import INITIAL_RATING, PolicyStore

__all__ = [
    "Arena", "INITIAL_RATING", "LeagueResult", "OpponentSampler",
    "PolicyStore", "Ranker", "SAMPLER_STRATEGIES", "SelfPlay",
    "SelfPlayCarry", "build_league", "make_selfplay_update", "run_selfplay",
    "selfplay_rollout",
]
