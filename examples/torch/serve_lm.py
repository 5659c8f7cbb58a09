"""Batched serving: prefill a prompt batch, then greedy-decode new tokens
through the KV/SSM caches (ring buffers for sliding-window layers); the
PyTorch port of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch/serve_lm.py --arch gemma3-27b [--device cpu]
"""
import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import random_inputs
from repro_torch.models import CausalLM, init_params
from repro_torch.runtime import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="where to serve (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    model = init_params(CausalLM(cfg, device=device), 0)
    prompt, extras = random_inputs(cfg, args.batch, 48, 0, device)
    t0 = time.time()
    out = greedy_generate(model, prompt, args.new_tokens, extras=extras)
    dt = time.time() - t0
    print(f"{cfg.name}-reduced: {out.shape[0]}x{out.shape[1]} tokens in {dt:.2f}s "
          f"({out.numel() / dt:.0f} tok/s)")
    print(out.cpu())


if __name__ == "__main__":
    main()
