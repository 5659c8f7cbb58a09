"""Model assembly: the causal LM, VLM and enc-dec forward, prefill, decode
and loss, as the JAX package's ``models/model.py`` computes them.

:class:`CausalLM` holds the parameters (``embed``, ``layers``,
``final_norm``, and ``pos_dec`` / ``encoder`` where the configuration has
them) and reads its activation dtype from ``self.cfg`` at every call: the
parameters keep ``cfg.param_dtype`` and each weight is cast to
``cfg.dtype`` where it is used.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import (
    distribute_logical,
    embed_tokens,
    embedding_specs,
    learned_pos,
    learned_pos_specs,
    logits_head,
    mesh_of,
    norm,
    norm_specs,
    on_shards,
    shard_start,
    with_logical,
)
from repro_torch.models.module import SpecModule


class CausalLM(nn.Module):
    """Every architecture of :mod:`repro_torch.configs` in one module.

    Built with uninitialized parameters on ``device``: the GPU unless the
    caller asks for the CPU (:func:`repro_torch.device.resolve_device`
    raises without one), or ``"meta"``, which allocates nothing.
    :func:`repro_torch.models.module.init_params` draws them, or
    ``load_state_dict(from_reference(cfg, params))`` carries the JAX
    package's.
    """

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.embed = SpecModule(embedding_specs(cfg), device)
        self.layers = blocks.build_layers(cfg, device=device)
        self.final_norm = SpecModule(norm_specs(cfg), device)
        if not cfg.use_rope:
            self.pos_dec = SpecModule(learned_pos_specs(cfg.max_seq_len, cfg.d_model), device)
        if cfg.encoder is not None:
            self.encoder = SpecModule({
                "layers": blocks.build_layers(cfg, n_layers=cfg.encoder.n_layers,
                                              causal=False, allow_cross=False, device=device),
                "final_norm": norm_specs(cfg),
                "pos_enc": learned_pos_specs(cfg.encoder.n_frames, cfg.d_model),
            }, device)

    # ----------------------------------------------------------------- #
    def _encode(self, frames):
        """Whisper encoder over precomputed frame embeddings (frontend stub)."""
        cfg = self.cfg
        b, s, _ = frames.shape
        pos = torch.arange(s, device=frames.device).expand(b, s)
        x = frames + learned_pos(self.encoder.pos_enc, pos, cfg.dtype)
        x, _, _ = blocks.stack_apply(self.encoder.layers, x, cfg,
                                     {"positions": pos, "max_len": s})
        return norm(self.encoder.final_norm, x, cfg)

    def _make_ctx(self, tokens, extras, max_len: Optional[int]):
        b, s = tokens.shape
        positions = distribute_logical(torch.arange(s, device=tokens.device).expand(b, s),
                                       ("batch", None))
        ctx: Dict[str, Any] = {"positions": positions, "max_len": max_len or s}
        if self.cfg.encoder is not None:
            ctx["cross_src"] = self._encode(extras["frames"])
        elif self.cfg.cross_attn_every is not None:
            ctx["cross_src"] = extras["vision_embeds"]
        return ctx

    def forward(self, tokens, extras=None, collect_cache: bool = False,
                max_len: Optional[int] = None):
        """tokens: [B, S] integer -> (logits [B, S, Vp], aux, caches or None)."""
        cfg = self.cfg
        ctx = self._make_ctx(tokens, extras or {}, max_len)
        x = embed_tokens(self.embed, tokens, cfg)
        if not cfg.use_rope:
            x = x + learned_pos(self.pos_dec, ctx["positions"], cfg.dtype)
        # On a mesh: the residual stream batch-sharded, the logits also over
        # the vocab (the layout GSPMD propagates from the parameters').
        x = with_logical(x, ("batch", None, None))
        x, aux, caches = blocks.stack_apply(self.layers, x, cfg, ctx, collect_cache)
        x = with_logical(norm(self.final_norm, x, cfg), ("batch", None, None))
        logits = with_logical(logits_head(self.embed, x, cfg), ("batch", None, "vocab"))
        return logits, aux, caches

    def prefill(self, tokens, extras=None, max_len: Optional[int] = None):
        """Fill the KV/SSM caches; return (last-token logits, caches)."""
        logits, _aux, caches = self.forward(tokens, extras, collect_cache=True,
                                            max_len=max_len)
        return logits[:, -1:], caches

    def decode_step(self, caches, token, position):
        """token: [B, 1]; position: [B]. Returns (logits [B, 1, Vp], caches).

        The attention layers' ring buffers are updated in place."""
        cfg = self.cfg
        ctx = {"position": position, "positions": position[:, None]}
        x = embed_tokens(self.embed, token, cfg)
        if not cfg.use_rope:
            x = x + learned_pos(self.pos_dec, position[:, None], cfg.dtype)
        x = with_logical(x, ("batch", None, None))
        x, new_caches = blocks.stack_decode(self.layers, x, caches, cfg, ctx)
        x = with_logical(norm(self.final_norm, x, cfg), ("batch", None, None))
        logits = with_logical(logits_head(self.embed, x, cfg), ("batch", None, "vocab"))
        return logits, new_caches


@contextlib.contextmanager
def using_cfg(model: CausalLM, cfg):
    """Run ``model`` under ``cfg`` (its remat policy, its activation dtype)
    inside the block, then give it back its own: the step functions take the
    configuration as the reference's pure functions do."""
    own, model.cfg = model.cfg, cfg
    try:
        yield model
    finally:
        model.cfg = own


# --------------------------------------------------------------------- #
# Loss (the training objective: runtime/train_loop.py differentiates it)
# --------------------------------------------------------------------- #
def _label_logits(logits, labels):
    """``logits[..., labels]`` [B, S]. On a mesh, vocab-parallel: each rank
    reads the labels that fall in its vocab shard (0 for the others) and the
    shards' values sum (a [B, S] all-reduce); the gradient stays sharded."""
    mesh = mesh_of(logits)
    v0, sharded, ins, out = 0, False, None, None
    if mesh is not None:
        from torch.distributed.tensor import Partial, Replicate

        pl = logits.placements
        sharded = any(p.is_shard(2) for p in pl)
        v0 = shard_start(logits.shape, mesh, pl, 2)
        rows = tuple(Replicate() if p.is_shard(2) else p for p in pl)
        ins, out = (pl, rows), (tuple(Partial() if p.is_shard(2) else p for p in pl),)

    def pick(logits, labels):
        if not sharded:
            return torch.gather(logits, -1, labels[..., None])[..., 0]
        idx = labels - v0
        inside = (idx >= 0) & (idx < logits.shape[-1])
        ll = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, ll, 0.0)

    return on_shards(pick, mesh, ins, out)(logits, labels)


def ce_loss(logits, labels, cfg, z_loss: float = 1e-4):
    """Cross-entropy over the padded vocab (pad ids masked out)."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > cfg.vocab_size:
        bias = torch.zeros(vp, dtype=torch.float32, device=logits.device)
        bias[cfg.vocab_size:] = -1e9
        logits = logits + bias
    # torch.logsumexp's own steps, written out: on a mesh the max and the sum
    # reduce over the vocab shards ([B, S] all-reduces), where logsumexp
    # would gather the logits whole.
    m = with_logical(logits.amax(-1, keepdim=True), ("batch", None, None)).detach()
    logz = torch.log((logits - m).exp_().sum(-1)) + m[..., 0]
    loss = (logz - _label_logits(logits, labels)).mean()
    if z_loss:
        loss = loss + z_loss * (logz ** 2).mean()
    return loss


def loss_fn(model: CausalLM, batch, aux_weight: float = 0.01):
    logits, aux, _ = model(batch["tokens"], extras=batch.get("extras"))
    loss = ce_loss(logits, batch["labels"], model.cfg)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
