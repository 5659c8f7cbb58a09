"""Training loop with checkpoint/restart, failure injection and metrics.

``make_train_step`` builds the step (loss -> grads -> clip -> optimizer);
``TrainLoop`` owns the impure parts: data, checkpoint manager, failure
injection, resume. Resuming from a checkpoint is bit-identical to an
uninterrupted run (step-indexed data + saved optimizer state + saved step
counter), on the CPU and on the card: the step runs under
``torch.use_deterministic_algorithms`` (:func:`deterministic_mode`).

The JAX package's step is a pure function that ``jit`` compiles and whose
parameter and state buffers it donates. The port has neither: the step runs
eagerly and updates the model's parameters and the optimizer state in place.
Checkpoints hold ``{"params", "opt"}`` in the reference's tree layout
(``models/convert.py::to_reference``), so either package resumes the other's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, latest_step, restore_pytree
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.models.model import loss_fn, using_cfg
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm

# cuBLAS picks reproducible kernels only with a fixed workspace; torch checks
# this variable whenever deterministic mode meets a cuBLAS call.
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic_mode(enabled: bool = True):
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    previous mode after it: the backward passes of the embedding gather,
    ``ce_loss``'s ``gather`` and the MoE's gathers accumulate with atomics on
    CUDA unless it is on. Serving never enters it. Uninitialized memory is
    not filled (a debugging aid of the mode, not needed for determinism)."""
    if not enabled:
        yield
        return
    import torch.utils.deterministic as det

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


@contextlib.contextmanager
def _trainable(model):
    """Parameters record gradients inside the block (the model's own flags
    are ``requires_grad=False``: serving builds no graph)."""
    params = list(model.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
            p.grad = None


def _map(fn, tree):
    """``fn`` over the tensors of a batch (nested dicts; ``None`` kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, or zeros where no loss term reached ``p`` (``jax.grad``
    gives zeros there)."""
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    return p.grad


def make_train_step(cfg, optimizer: Optimizer, max_grad_norm: float = 1.0,
                    accum_steps: int = 1, grad_shardings=None,
                    accum_dtype=torch.float32, deterministic: bool = True):
    """(model, opt_state, step, batch) -> (model, opt_state, metrics).

    One ``torch.autograd`` backward of ``loss_fn`` under ``cfg`` (its remat
    policy), then ``clip_by_global_norm``, ``optimizer.update`` and
    ``apply_updates``, all in place on the model's parameters and the state.
    ``step`` is the step count as a tensor on the model's device (or an int).

    ``accum_steps > 1`` splits the batch into microbatches run one after the
    other and sums their gradients in ``accum_dtype``, as the reference's
    scan does; where that is the parameter's dtype, autograd's own
    accumulation into ``.grad`` is the sum, so no second buffer is held.

    ``grad_shardings`` places the reference's gradients on its mesh; on one
    card there is nothing to place, and it is accepted and ignored.
    ``deterministic``: run under :func:`deterministic_mode`.
    """
    del grad_shardings

    def step_fn(model, opt_state, step, batch):
        params = dict(model.named_parameters())
        with using_cfg(model, cfg), _trainable(model), deterministic_mode(deterministic):
            if accum_steps == 1:
                loss, metrics = loss_fn(model, batch)
                loss.backward()
                grads = {k: _grad(p) for k, p in params.items()}
            else:
                def split(x):
                    return x.reshape((accum_steps, x.shape[0] // accum_steps) + x.shape[1:])

                micro = _map(split, batch)
                buffers = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                           for k, p in params.items() if p.dtype != accum_dtype}
                loss = 0.0
                for i in range(accum_steps):
                    l_i, _ = loss_fn(model, _map(lambda x: x[i], micro))
                    l_i.backward()
                    loss = loss + l_i.detach()
                    for k, buf in buffers.items():
                        buf.add_(_grad(params[k]).to(accum_dtype))
                        params[k].grad = None
                with torch.no_grad():
                    grads = {k: (buffers[k] if k in buffers else _grad(p)).div_(accum_steps).float()
                             for k, p in params.items()}
                loss = loss / accum_steps
                metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            with torch.no_grad():
                plain = {k: p.detach() for k, p in params.items()}
                updates, opt_state = optimizer.update(grads, opt_state, plain, step)
                apply_updates(plain, updates)
            del grads, updates
        out = {
            "loss": loss.detach().float(),
            "ce": metrics["ce"].detach().float(),
            "grad_norm": gnorm,
        }
        return model, opt_state, out

    return step_fn


# --------------------------------------------------------------------- #
# The reference's checkpoint layout
# --------------------------------------------------------------------- #
def _state_to_reference(cfg, state, keys):
    """The optimizer state in the reference's layout: a dict over the
    model's parameter keys (AdamW's ``m`` and ``v``) is restacked, any other
    tensor (Adafactor's, already stacked) is copied to the host."""
    if isinstance(state, dict) and set(state) == keys:
        return to_reference(cfg, state)
    if isinstance(state, dict):
        return {k: _state_to_reference(cfg, v, keys) for k, v in state.items()}
    if state.device.type == "meta":
        return state
    return state.detach().cpu().numpy().copy()


@torch.no_grad()
def _load_state_(cfg, state, tree, keys):
    """Copy a restored reference-layout ``tree`` into ``state`` in place."""
    if isinstance(state, dict) and set(state) == keys:
        for k, t in from_reference(cfg, tree, dtype=torch.float32).items():
            state[k].copy_(t)
    elif isinstance(state, dict):
        for k, v in state.items():
            _load_state_(cfg, v, tree[k], keys)
    else:
        src = torch.as_tensor(np.asarray(tree))
        if tuple(src.shape) != tuple(state.shape) or src.dtype != state.dtype:
            raise ValueError(f"checkpoint leaf {tuple(src.shape)} {src.dtype} does not fit the "
                             f"optimizer state's {tuple(state.shape)} {state.dtype}")
        state.copy_(src)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta")


def device_batch(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> device tensors (token ids as int64, which torch's
    ``gather`` needs); a pinned staging copy keeps the upload asynchronous."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = device_batch(v, device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("tokens", "labels"):
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


@dataclasses.dataclass
class TrainLoop:
    cfg: Any
    model: Any  # a CausalLM; trained in place
    optimizer: Optimizer
    data: Any  # exposes batch_at(step)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_blocking: bool = False  # True: synchronous saves (a crash can never
    # lose the latest scheduled checkpoint; async saves trade that for speed)
    failure_injector: Optional[Any] = None

    def __post_init__(self):
        self.device = next(self.model.parameters()).device
        self.opt_state = self.optimizer.init(dict(self.model.named_parameters()))
        self.step = 0
        self.manager = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        self._step_fn = make_train_step(self.cfg, self.optimizer)

    # ------------------------------------------------------------------ #
    def _tree(self) -> dict:
        """``{"params", "opt"}`` in the reference's layout, on the host."""
        keys = set(self.model.state_dict())
        return {"params": to_reference(self.cfg, self.model.state_dict()),
                "opt": _state_to_reference(self.cfg, self.opt_state, keys)}

    def try_resume(self) -> bool:
        if self.manager is None or latest_step(self.manager.path) is None:
            return False
        keys = set(self.model.state_dict())
        like = {"params": to_reference(self.cfg, _to_meta(self.model.state_dict())),
                "opt": _state_to_reference(self.cfg, _to_meta(self.opt_state), keys)}
        restored, step, _ = restore_pytree(self.manager.path, like)
        self.model.load_state_dict(from_reference(self.cfg, restored["params"]))
        _load_state_(self.cfg, self.opt_state, restored["opt"], keys)
        self.step = step
        return True

    def save(self, blocking: bool = True):
        if self.manager is not None:
            self.manager.save(self._tree(), self.step, blocking=blocking)

    # ------------------------------------------------------------------ #
    def run(self, n_steps: int, log_every: int = 10) -> Dict[str, list]:
        history: Dict[str, list] = {"loss": [], "step": [], "tokens_per_s": []}
        t_last = time.time()
        target = self.step + n_steps
        step_t = torch.tensor(self.step, device=self.device)
        while self.step < target:
            if self.failure_injector is not None:
                self.failure_injector.maybe_fail(self.step)
            batch = device_batch(self.data.batch_at(self.step), self.device)
            self.model, self.opt_state, metrics = self._step_fn(
                self.model, self.opt_state, step_t, batch)
            self.step += 1
            step_t += 1
            if self.step % log_every == 0 or self.step == target:
                loss = float(metrics["loss"])
                dt = time.time() - t_last
                toks = batch["tokens"].numel() * log_every / max(dt, 1e-9)
                history["loss"].append(loss)
                history["step"].append(self.step)
                history["tokens_per_s"].append(toks)
                t_last = time.time()
            if self.manager is not None and self.step % self.ckpt_every == 0:
                self.save(blocking=self.ckpt_blocking)
        if self.manager is not None:
            self.save(blocking=True)
            self.manager.wait()
        return history
