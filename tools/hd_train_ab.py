#!/usr/bin/env python3
"""Phase 16(d)'s bf16 train steps of gemma-7b and stablelm-12b through the
launcher, in another checkout and in this one, in turns on one card.

    python3 tools/hd_train_ab.py OLD_DIR [--arch gemma-7b,stablelm-12b]
        [--rounds 2]

Run from the root of the new checkout. OLD_DIR is another checkout of the
repo (the parent, unpacked with ``git archive``). For each arch, each
round runs old then new, then new then old (``--rounds 2``: old, new, new,
old), each in a subprocess of its own started in its checkout:
``chip_smoke.lm_launcher_run(arch, depth=HD_TRAIN_DEPTH)``, 10 steps of
B 8 x T 256 at full width and depth 8, which checks the launches and
routes that checkout expects and prints its line (the median step ms,
tokens/s, ``flash_attention_bwd``'s routes over the 10 steps). Each
checkout builds its kernels into its own ``_build/`` once, in the first
subprocess. The card's name and power limit come first; the last line is
one JSON object: each run's median step ms and routes.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN = ("import sys, chip_smoke as c; "
       "c.lm_launcher_run(sys.argv[1], tag='hd train ab', "
       "depth=c.HD_TRAIN_DEPTH)")
LINE = re.compile(r"median step ([\d.]+) ms.*flash_attention_bwd routes "
                  r"over the \d+ steps (\{[^}]*\})")


def one(checkout: Path, arch: str) -> dict:
    r = subprocess.run([sys.executable, "-c", RUN, arch], cwd=checkout,
                       capture_output=True, text=True, timeout=900)
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("[hd train ab]")), None)
    if r.returncode != 0 or line is None:
        raise SystemExit(f"{arch} in {checkout}: exit {r.returncode}\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    print(line, flush=True)
    m = LINE.search(line)
    return {"step_ms": float(m.group(1)), "routes": m.group(2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("--arch", default="gemma-7b,stablelm-12b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dirs = {"old": args.old.resolve(), "new": ROOT}
    out = {"card": smi}
    for arch in args.arch.split(","):
        runs = {"old": [], "new": []}
        for i in range(args.rounds):
            for name in (("old", "new") if i % 2 == 0 else ("new", "old")):
                runs[name].append(one(dirs[name], arch))
        med = {n: statistics.median(r["step_ms"] for r in rs)
               for n, rs in runs.items()}
        print(f"{arch}: median step ms old {med['old']:.2f} "
              f"({[r['step_ms'] for r in runs['old']]}), new "
              f"{med['new']:.2f} ({[r['step_ms'] for r in runs['new']]}); "
              f"new - old {med['new'] - med['old']:+.2f} ms", flush=True)
        out[arch] = {"runs": runs, "median_step_ms": med}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
