"""EnvPool analogue — the paper's double-buffered async vectorization.

The counterpart of ``repro/core/pool.py``. The paper's Python EnvPool
simulates M = k·N environments and returns batches of N from the first
workers to finish; with k = 2 the CPU steps half the envs while the GPU
computes actions for the other half. For batched device envs the overlap is
the card's queue: while the learner consumes buffer i, buffer i+1's env
step is already enqueued. CUDA runs eager PyTorch asynchronously, so the
pool is a small round-robin scheduler that never waits on the device: an
env step is enqueued by ``send`` and its results are handed out, still in
flight, by the next ``recv`` of that buffer.

API matches EnvPool: ``recv() → (obs, rew, done, info, buf)``, then
``send(actions, buf)``. ``num_buffers > 2`` hides more learner latency.

Each buffer's initial state is drawn from the one generator, in buffer
order, and every step draws from it too; the reference folds a key per
buffer, so the two agree by outcome, not by random stream.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.vector import VecEnv


def empty_info(num_envs: int, device) -> dict:
    """The per-env info of a step in which no episode ended."""
    return {"score": torch.zeros(num_envs, device=device),
            "episode_return": torch.zeros(num_envs, device=device),
            "episode_length": torch.zeros(num_envs, dtype=torch.int32,
                                          device=device),
            "valid": torch.zeros(num_envs, dtype=torch.bool, device=device)}


class Pool:
    def __init__(self, env, num_envs: int, generator: torch.Generator,
                 num_buffers: int = 2):
        if num_buffers < 1:
            raise ValueError(f"num_buffers must be >= 1, got {num_buffers}")
        self.vec = VecEnv(env, num_envs)
        self.num_buffers = num_buffers
        self.batch_size = self.vec.batch_size
        self.generator = generator
        dev = generator.device
        # independent env-state buffers stepped by one VecEnv
        self._states, self._pending = [], []
        for _ in range(num_buffers):
            state, obs = self.vec.init(generator)
            self._states.append(state)
            self._pending.append((
                obs, torch.zeros(self.batch_size, device=dev),
                torch.zeros(self.batch_size, dtype=torch.bool, device=dev),
                empty_info(num_envs, dev)))
        self._cursor = 0
        self._awaiting = [False] * num_buffers

    def recv(self):
        """Observations of the current buffer. Waits on nothing: the other
        buffers' steps stay in flight on the device queue."""
        b = self._cursor
        if self._awaiting[b]:
            raise RuntimeError("recv() twice without send()")
        self._awaiting[b] = True
        obs, rew, done, info = self._pending[b]
        return obs, rew, done, info, b

    def send(self, actions, buf: Optional[int] = None):
        """Enqueue the step of the awaited buffer and advance the cursor.

        The cursor always advances from its own value, never from ``buf``:
        ``recv`` hands out only the cursor buffer, so a stale ``buf`` from
        an older ``recv`` raises instead of skewing the round-robin."""
        b = self._cursor
        if buf is not None and buf != b:
            raise ValueError(
                f"send(buf={buf}) does not match the awaited buffer {b}; "
                f"pass the buf returned by the matching recv()")
        if not self._awaiting[b]:
            raise RuntimeError("send() without recv()")
        state, obs, rew, done, info = self.vec.step(self._states[b], actions,
                                                    self.generator)
        self._states[b] = state
        self._pending[b] = (obs, rew, done, info)
        self._awaiting[b] = False
        self._cursor = (self._cursor + 1) % self.num_buffers
