"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains on the GPU unless ``--device cpu`` is given (without a GPU the
default raises). ``--smoke`` selects the reduced config; without it the
published widths and depth are trained, from random parameters drawn from
``--seed``, on ``SyntheticTokens``.

    python -m repro_torch.launch.train --arch mamba2-130m --steps 20 --batch 4 --seq 512
    python -m repro_torch.launch.train --arch granite-3-2b --smoke --device cpu

It prints the JAX launcher's lines (the parameter count, then the step,
loss and tokens/s of every logged step), then the device, the median step
time, tokens/s at that time and the peak device bytes.
"""
from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.serve import card_name
from repro_torch.models.model import CausalLM
from repro_torch.models.module import count_params, init_params
from repro_torch.optim import get_optimizer
from repro_torch.runtime import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where to train (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = init_params(CausalLM(cfg, device=device), args.seed)
    print(f"{cfg.name}: {count_params(model)/1e6:.1f}M params, 1 device(s)")
    data = SyntheticTokens(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch=args.batch, seed=args.seed
    )
    loop = TrainLoop(
        cfg=cfg, model=model,
        optimizer=get_optimizer(cfg, lr=args.lr, total=args.steps),
        data=data, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    if args.resume and loop.try_resume():
        print(f"resumed from step {loop.step}")
    hist = loop.run(args.steps, log_every=max(1, args.steps // 20))
    for s, l, t in zip(hist["step"], hist["loss"], hist["tokens_per_s"]):
        print(f"step {s:6d}  loss {l:8.4f}  {t:9.0f} tok/s")
    # Each logged interval's tokens/s is its steps' tokens over its wall, so
    # one step takes the batch's tokens over it; the median skips warm-up.
    tokens = args.batch * args.seq
    step_ms = statistics.median(tokens / t for t in hist["tokens_per_s"]) * 1e3
    peak = (f"peak {torch.cuda.max_memory_allocated(device):,} bytes allocated"
            if device.type == "cuda" else "peak bytes not measured")
    print(f"device: {card_name(device)}; step median {step_ms:.3f} ms over "
          f"{len(hist['step'])} logged interval(s); {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"{peak}")


if __name__ == "__main__":
    main()
