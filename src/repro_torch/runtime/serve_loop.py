"""Batched serving loop: prefill + greedy decode over the KV/SSM caches."""
from __future__ import annotations

import time
from typing import Optional

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits, vocab_size: int):
    """Argmax over the real vocab of the last position: [B, 1]. The padded
    vocab is masked first."""
    last = logits[:, -1].clone()
    last[:, vocab_size:] = float("-inf")
    return last.argmax(dim=-1, keepdim=True)


def greedy_generate(model, prompt, n_new: int, extras=None,
                    max_len: Optional[int] = None, stats: Optional[dict] = None):
    """prompt: [B, S] integer -> generated [B, n_new] int64 (greedy).

    With ``stats`` (a dict), the device is synchronized around the prefill
    and every decode step, and ``stats`` receives ``prefill_s``,
    ``decode_s`` (one host-clock time per decode step) and ``all_finite``
    (every logit of every step was finite)."""
    cfg = model.cfg
    b, s = prompt.shape
    max_len = max_len or (s + n_new)
    dev = prompt.device
    finite = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = model.prefill(prompt, extras=extras, max_len=max_len)
        token = _greedy(logits, cfg.vocab_size)
        if stats is not None:
            _sync(dev)
            stats["prefill_s"] = time.perf_counter() - t0
            stats["decode_s"] = []
            finite.append(torch.isfinite(logits).all())
        out = [token]
        pos = torch.full((b,), s, dtype=torch.long, device=dev)
        for _ in range(n_new - 1):
            t0 = time.perf_counter()
            logits, caches = model.decode_step(caches, token, pos)
            token = _greedy(logits, cfg.vocab_size)
            if stats is not None:
                _sync(dev)
                stats["decode_s"].append(time.perf_counter() - t0)
                finite.append(torch.isfinite(logits).all())
            out.append(token)
            pos = pos + 1
    if stats is not None:
        stats["all_finite"] = bool(torch.stack(finite).all())
    return torch.cat(out, dim=1)
