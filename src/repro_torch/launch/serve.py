"""Serving launcher: batched autoregressive decoding against the caches
(KV caches for attention layers, conv window and SSM state for Mamba2
layers).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 8 --prompt-len 512 --tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --batch 8 --prompt-len 512 --tokens 64

runs the full config on the card (bf16, random weights from ``--seed``):
one prefill, then ``tokens - 1`` decode steps, and prints tok/s. ``--smoke``
takes the reduced config; ``--device cpu`` runs on the CPU. ``--quantize
int8`` (or ``int4``) quantises the drawn weights per output channel and
sends every matmul through the ``quant_matmul`` kernel, as
``repro.launch.dryrun --quantize`` does for the reference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", default="off",
                    choices=["off", "int8", "int4"])
    args = ap.parse_args(argv)
    quantize = None if args.quantize == "off" else args.quantize

    dev = _device.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    policy = BackbonePolicy(cfg, device=dev, generator=gen,
                            quantize=quantize)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = actor.generate(policy, prompt, args.tokens, gen,
                         max_len=args.prompt_len + args.tokens,
                         temperature=args.temperature)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} quantize={args.quantize} device={dev} "
          f"generated {tuple(out.shape)} in "
          f"{dt:.3f}s ({args.batch * args.tokens / dt:.1f} tok/s incl. "
          f"first-call overhead)")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
