"""Host-side training loop for Ocean PPO: a thin facade over
``rl.engine.TrainEngine``.

The counterpart of ``repro/rl/trainer.py``: construction from a raw env,
``train`` (with periodic checkpoints and resume), ``save``/``restore`` of
the params and optimizer state, the history, and the metrics log
(``log_dir``: one JSONL record per update). The engine owns the
device-resident state and the K-updates-per-launch loop.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.core import spaces as sp
from repro_torch.core.emulation import Emulated
from repro_torch.models.policy import OceanPolicy
from repro_torch.rl.distributions import Dist
from repro_torch.rl.engine import TrainEngine
from repro_torch.rl.learner import TrainState
from repro_torch.utils.metrics import MetricsLogger


def ocean_policy_stack(env, hidden: int = 128, recurrent: bool = False,
                       conv: bool = None):
    """Derive ``(Emulated, Dist, OceanPolicy)`` from a raw Ocean env — the
    one place the env→policy derivation lives (action kind from the
    emulated action spec, the CNN frontend from ``obs_frontend``)."""
    em = Emulated(env)
    if em.act_spec.kind == "discrete":
        dist = Dist("categorical", nvec=em.act_spec.nvec)
    else:       # continuous actions — paper §8 extension
        dist = Dist("gaussian", cont_dim=em.act_spec.cont_dim)
    # pixel envs opt in to the CNN frontend via `obs_frontend = "conv"`;
    # the policy then restores the emulated-flat obs to its 2D layout
    if conv is None:
        conv = getattr(env, "obs_frontend", None) == "conv"
    conv_shape = None
    if conv:
        space = env.observation_space
        if not (isinstance(space, sp.Box) and len(space.shape) == 2):
            raise ValueError(
                f"conv frontend needs a single 2D Box observation, got "
                f"{space}")
        conv_shape = space.shape
    policy = OceanPolicy(em.obs_spec.total, dist.nvec, hidden=hidden,
                         recurrent=recurrent,
                         num_outputs=dist.num_outputs,
                         conv_shape=conv_shape)
    return em, dist, policy


class Trainer:
    """``device=None`` means CUDA (raises without a Hopper card); pass
    ``device="cpu"`` to train on the CPU. ``mesh`` (the shard_map tier's)
    and ``num_shards`` (the jit tier's S-block emulation) pass through to
    the engine."""

    def __init__(self, env, tcfg: TrainConfig = None, hidden: int = 128,
                 recurrent: bool = False, seed: int = 0,
                 log_dir: str = None,
                 backend: str = None, updates_per_launch: int = None,
                 conv: bool = None, device=None, mesh=None,
                 num_shards: int = 1):
        self.logger = MetricsLogger(log_dir,
                                    run_name=type(env).__name__.lower())
        self.tcfg = tcfg or TrainConfig()
        self.em, self.dist, self.policy = ocean_policy_stack(
            env, hidden=hidden, recurrent=recurrent, conv=conv)
        self.engine = TrainEngine(self.em, self.policy, self.tcfg, self.dist,
                                  seed=seed, device=device, backend=backend,
                                  updates_per_launch=updates_per_launch,
                                  mesh=mesh, num_shards=num_shards)
        self.history = []

    # engine state, exposed under the reference's names -----------------------
    @property
    def ts(self) -> TrainState:
        return self.engine.ts

    @property
    def rc(self):
        return self.engine.rc

    @property
    def vec(self):
        return self.engine.vec

    @property
    def steps_per_update(self) -> int:
        return self.engine.steps_per_update

    def train(self, total_steps: int, log_every: int = 0,
              target_score: Optional[float] = None,
              checkpoint_dir: Optional[str] = None, resume: bool = False,
              on_launch=None):
        """Run until total env interactions ≥ total_steps (or solved).
        ``target_score`` is checked at launch boundaries (identical to
        per-update for K = 1). With ``checkpoint_dir`` the engine saves its
        resumable state every ``tcfg.checkpoint_every`` updates (async, at
        the update boundary); ``resume=True`` restores the newest committed
        checkpoint first and continues from its update count. Metrics
        stream into ``self.logger``. Returns the solving update's metrics,
        else the last update's ({} when a resumed run had nothing left)."""
        if checkpoint_dir:
            self.engine.checkpoint_dir = checkpoint_dir
            if resume and ckpt.latest(checkpoint_dir) is not None:
                u0 = self.engine.restore(checkpoint_dir)
                print(f"  resumed at update {u0}")

        def on_update(u, m):
            self.history.append(m)
            if log_every and (u % log_every == 0):
                print(f"  upd {u:4d} steps {m['env_steps']:7d} "
                      f"score {m['score']:.3f} "
                      f"ret {m['episode_return']:.3f} "
                      f"kl {m['approx_kl']:.4f} "
                      f"sps {m['sps']:.0f}")

        _, solved = self.engine.run(total_steps, target_score=target_score,
                                    on_update=on_update,
                                    on_launch=on_launch, logger=self.logger)
        if solved is not None:
            return solved
        return self.history[-1] if self.history else {}

    def save(self, ckpt_dir: str):
        """Save the params, the optimizer state and the step count: the
        reference's ``{"params", "opt", "step"}`` tree, so either package
        restores the params the other saved."""
        return ckpt.save(ckpt_dir, {"params": self.ts.params,
                                    "opt": self.ts.opt, "step": self.ts.step})

    def restore(self, ckpt_dir: str):
        tree = ckpt.restore(ckpt_dir, {"params": self.ts.params,
                                       "opt": self.ts.opt,
                                       "step": self.ts.step})
        self.engine.ts = TrainState(tree["params"], tree["opt"],
                                    tree["step"])
