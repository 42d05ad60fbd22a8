"""The ``serial`` backend of the port's ``VecEnv`` and ``autotune``.

``serial`` steps each env as a batch of one, env i with generator i of a
list of N; it must be, bit for bit, the batched (``vmap``) path given the
same list of generators, through init, resets and auto-resets, for a
single-agent, a multiagent and a dict-observation env. Where a step draws
nothing, env i alone must also step as row i of one batched call over all
N does, whatever generator that call is handed. ``autotune`` times both
backends and names the faster one, as the reference's does.
"""
import pytest
import torch

from repro_torch.core import emulation as tem
from repro_torch.core import spaces as sp
from repro_torch.core.vector import VecEnv, autotune, block_generators
from repro_torch.envs import ocean as tocean

N, STEPS = 6, 40


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["password", "multiagent", "spaces"])
def test_serial_is_the_batched_path_with_n_generators(name):
    em = tem.Emulated(tocean.OCEAN[name]())
    vecs = [VecEnv(em, N, backend=b) for b in ("serial", "vmap")]
    gens = [block_generators(11, N, "cpu") for _ in vecs]
    act = torch.Generator().manual_seed(3)
    outs = [v.init(g) for v, g in zip(vecs, gens)]
    assert all(_equal(x, y) for x, y in zip(*outs))
    states = [o[0] for o in outs]
    dones = 0
    for _ in range(STEPS):
        a = sp.sample(vecs[0].single_action_space, act,
                      (vecs[0].batch_size,))
        outs = [v.step(s, a, g) for v, s, g in zip(vecs, states, gens)]
        for x, y in zip(*outs):
            assert _equal(x, y)
        states = [o[0] for o in outs]
        dones += int(outs[0][3].sum())
    assert dones > 0            # the auto-reset ran
    assert _equal(*(v.reset(s, g)[1] for v, s, g in zip(vecs, states, gens)))


def _rows_equal(a, b, rows):
    if isinstance(a, dict):
        return all(_rows_equal(a[k], b[k], rows) for k in a)
    return a.dtype == b.dtype and torch.equal(a[rows], b[rows])


@pytest.mark.parametrize("name", ["password", "multiagent", "maze"])
def test_serial_env_alone_steps_as_its_row_of_one_batched_call(name):
    """These envs' steps draw nothing, so until its first reset (which
    draws) env i stepped alone gives what row i of one batched ``env.step``
    over all N gives: the batched call here is handed a generator of its
    own, so it runs the env over N rows at once and not block by block."""
    em = tem.Emulated(tocean.OCEAN[name]())
    ser, vec = VecEnv(em, N, backend="serial"), VecEnv(em, N)
    gens = block_generators(11, N, "cpu")
    s_ser, _ = ser.init(gens)
    s_vec, _ = vec.init(block_generators(11, N, "cpu"))
    other = torch.Generator().manual_seed(99)
    act = torch.Generator().manual_seed(3)
    A = vec.num_agents
    live = torch.ones(N, dtype=torch.bool)      # envs not yet reset
    compared = 0
    for _ in range(STEPS):
        a = sp.sample(vec.single_action_space, act, (vec.batch_size,))
        out_s = ser.step(s_ser, a, gens)
        out_v = vec.step(s_vec, a, other)
        done = out_s[3].view(N, A)[:, 0]
        assert torch.equal(done[live], out_v[3].view(N, A)[:, 0][live])
        live &= ~done
        rows = live.repeat_interleave(A)
        assert _rows_equal(out_s[0], out_v[0], live)        # state
        assert _rows_equal(out_s[1], out_v[1], rows)        # obs
        assert _rows_equal(out_s[2], out_v[2], rows)        # reward
        assert _rows_equal(out_s[4], out_v[4], live)        # info
        compared += int(live.sum())
        s_ser, s_vec = out_s[0], out_v[0]
    assert compared >= 2 * N


def test_serial_with_one_generator_steps_each_env_in_turn():
    """Given one generator, env i of a serial VecEnv draws after env i - 1:
    the batched path given that generator N times over."""
    em = tem.Emulated(tocean.Bandit())
    ser = VecEnv(em, 4, backend="serial")
    s1, o1 = ser.init(torch.Generator().manual_seed(5))
    s2, o2 = VecEnv(em, 4).init([torch.Generator().manual_seed(5)] * 4)
    assert _equal(s1, s2) and _equal(o1, o2)
    with pytest.raises(ValueError, match="serial"):
        VecEnv(em, 4, backend="shard")


def test_autotune_returns_both_backends_and_the_winner():
    rates, best = autotune(tem.Emulated(tocean.Squared()), 8, steps=4,
                           device="cpu")
    assert set(rates) == {"serial", "vmap"}
    assert all(r > 0 for r in rates.values())
    assert best == max(rates, key=rates.get)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune(tem.Emulated(tocean.Squared()), 8, steps=1)
