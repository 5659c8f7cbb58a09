"""Step functions per shape kind, as the JAX package's ``launch/steps.py``
builds them; the port's take the model in place of the parameter tree."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import using_cfg
from repro_torch.optim import get_optimizer
from repro_torch.runtime.train_loop import make_train_step


def step_fn_for(cfg, kind: str, lr: float = 3e-4, accum_steps: int = 1,
                grad_shardings=None, accum_dtype=None, microbatch_repeat=None):
    """Returns (fn, argument names). The train step's optimizer is
    ``get_optimizer(cfg, lr=lr)``; its state comes from that optimizer's
    ``init`` over the model's ``named_parameters``. ``microbatch_repeat``:
    see :func:`~repro_torch.runtime.train_loop.make_train_step`."""
    if kind == "train":
        # Big-model training always remats: saved-activation footprint would
        # otherwise scale with depth x sequence. Configs may still pin an
        # explicit policy.
        if cfg.remat == "none":
            cfg = dataclasses.replace(cfg, remat="full")
        optimizer = get_optimizer(cfg, lr=lr)
        fn = make_train_step(
            cfg, optimizer, accum_steps=accum_steps,
            grad_shardings=grad_shardings,
            accum_dtype=accum_dtype or torch.float32,
            microbatch_repeat=microbatch_repeat,
        )
        return fn, ("model", "opt_state", "step", "batch")
    if kind == "prefill":
        def prefill_fn(model, tokens, extras):
            with using_cfg(model, cfg):
                return model.prefill(tokens, extras=extras or None)

        return prefill_fn, ("model", "tokens", "extras")
    if kind == "decode":
        def serve_fn(model, caches, token, position, extras):
            del extras  # the cross-attention source is in the caches
            with using_cfg(model, cfg):
                return model.decode_step(caches, token, position)

        return serve_fn, ("model", "caches", "token", "position", "extras")
    raise ValueError(kind)
