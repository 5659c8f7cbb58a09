"""Serving launcher: batched prefill + greedy decode of one architecture
with random parameters drawn from ``--seed``.

    python -m repro_torch.launch.serve --arch qwen3-8b            # on the GPU
    python -m repro_torch.launch.serve --arch mamba2-130m --smoke --device cpu

It prints the JAX package's line (the generated shape, the wall time and
tokens/s), the first tokens, then the device, the prefill time, the median
decode time per token and the peak device bytes.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import CausalLM
from repro_torch.models.module import init_params
from repro_torch.runtime.serve_loop import greedy_generate


def random_inputs(cfg, batch: int, prompt_len: int, seed: int, device):
    """(prompt [batch, prompt_len], extras) drawn on ``device``: the prompt
    from a generator seeded ``seed + 1``, the encoder frames or vision
    embeddings (in ``cfg.dtype``) from one seeded 2, as the reference's
    ``PRNGKey(seed + 1)`` and ``PRNGKey(2)``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=device)
    extras = None
    if cfg.encoder is not None or cfg.cross_attn_every is not None:
        gen = torch.Generator(device=device).manual_seed(2)
        key, n_src = (("frames", cfg.encoder.n_frames) if cfg.encoder is not None
                      else ("vision_embeds", cfg.n_vision_tokens))
        extras = {key: torch.randn((batch, n_src, cfg.d_model), generator=gen,
                                   dtype=cfg.dtype, device=device)}
    return prompt, extras


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of a CUDA device (the torch
    name if ``nvidia-smi`` cannot be read), or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def generate(model, prompt, new_tokens: int, extras=None) -> dict:
    """One timed ``greedy_generate`` call: the tokens, the wall time, the
    prefill time, the decode time of every step and its median, all in ms,
    whether every logit was finite, and on a GPU the peak allocated bytes
    since the last reset of the peak counter."""
    stats: dict = {}
    t0 = time.perf_counter()
    out = greedy_generate(model, prompt, new_tokens, extras=extras, stats=stats)
    wall = time.perf_counter() - t0
    decode_ms = [s * 1e3 for s in stats["decode_s"]]
    dev = prompt.device
    return {
        "tokens": out,
        "wall_s": wall,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms": decode_ms,
        "decode_ms_median": statistics.median(decode_ms) if decode_ms else None,
        "all_finite": stats["all_finite"],
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where to serve (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = init_params(CausalLM(cfg, device=device), args.seed)
    prompt, extras = random_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    res = generate(model, prompt, args.new_tokens, extras)
    out, dt = res["tokens"], res["wall_s"]
    print(f"{cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print(out[:, :12].cpu())
    decode = (f"decode median {res['decode_ms_median']:.3f} ms/token over "
              f"{len(res['decode_ms'])} steps" if res["decode_ms"] else "no decode step")
    peak = (f"peak {res['peak_bytes']:,} bytes allocated" if res["peak_bytes"] is not None
            else "peak bytes not measured")
    print(f"device: {card_name(device)}; prefill {res['prefill_ms']:.3f} ms; {decode}; {peak}")
    if not res["all_finite"]:
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()
