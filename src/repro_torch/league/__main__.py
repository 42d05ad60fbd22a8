"""League CLI — the counterpart of ``python -m repro.league``.

  # rank every stored version with a batched all-pairs arena, persist Elo
  PYTHONPATH=src python -m repro_torch.league arena --league-dir DIR

  # leaderboard without playing
  PYTHONPATH=src python -m repro_torch.league ls --league-dir DIR

``arena`` runs on the card unless ``--device cpu``.
"""
import argparse

from repro_torch.league.ranker import Ranker
from repro_torch.league.store import PolicyStore


def _leaderboard(store: PolicyStore) -> str:
    ranker = Ranker(store.ratings())
    lines = [f"{'rank':>4}  {'version':>7}  {'rating':>8}  {'step':>10}  "
             f"{'score':>6}"]
    for i, v in enumerate(ranker.rank()):
        m = store.meta(v)
        sc = "-" if m["score"] is None else f"{m['score']:.3f}"
        lines.append(f"{i + 1:>4}  v{v:<6}  {m['rating']:>8.1f}  "
                     f"{m['step']:>10}  {sc:>6}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.league")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("arena", help="round-robin rate all stored versions")
    pa.add_argument("--league-dir", required=True)
    pa.add_argument("--env", default="duel",
                    help="competitive OCEAN env the policies play")
    pa.add_argument("--num-envs", type=int, default=16)
    pa.add_argument("--hidden", type=int, default=64,
                    help="policy width the snapshots were trained with")
    pa.add_argument("--max-versions", type=int, default=8,
                    help="rate only the newest K versions")
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--device", default="cuda")

    pl = sub.add_parser("ls", help="print the leaderboard")
    pl.add_argument("--league-dir", required=True)

    args = ap.parse_args(argv)
    store = PolicyStore(args.league_dir)
    if args.cmd == "ls":
        print(_leaderboard(store))
        return 0

    import torch

    from repro_torch import device as _device
    from repro_torch.configs.ocean import preset
    from repro_torch.envs.ocean import OCEAN
    from repro_torch.league.arena import Arena
    from repro_torch.rl.trainer import ocean_policy_stack

    if len(store) < 2:
        print(f"need >= 2 stored versions to play matches "
              f"(store has {len(store)})")
        return 1
    dev = _device.resolve(args.device)
    em, dist, policy = ocean_policy_stack(
        OCEAN[args.env](), hidden=args.hidden,
        recurrent=preset(args.env).recurrent)
    arena = Arena(em, policy, dist, num_envs=args.num_envs, device=dev)
    versions = store.versions()[-args.max_versions:]
    stacked = store.load_stacked(versions, policy.abstract(dev))
    records = arena.round_robin(
        stacked, versions, torch.Generator(device=dev).manual_seed(args.seed))
    ranker = Ranker(store.ratings())
    ranker.record(records)
    store.set_ratings(ranker.ratings)
    print(f"played {len(records)} matches over versions "
          f"{versions[0]}..{versions[-1]}")
    print(_leaderboard(store))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
