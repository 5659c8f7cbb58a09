"""Train an LM end-to-end for a few hundred steps through the full stack:
data pipeline, AdamW + warmup-cosine, grad clipping, checkpointing; the
PyTorch port of ``examples/train_lm.py``.

Default: a reduced granite-3-2b config. ``--full --arch mamba2-130m`` trains
the actual ~130M assigned config through the identical code path.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 200] [--full] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import CausalLM, count_params, init_params
from repro_torch.optim import get_optimizer
from repro_torch.runtime import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true",
                    help="train the FULL assigned config (real hardware)")
    ap.add_argument("--device", default="cuda", help="where to train (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full:
        cfg = get_config(args.arch)
    else:
        cfg = get_smoke_config(args.arch)
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, d_ff=512, vocab_size=2048)
    model = init_params(CausalLM(cfg, device=device), 0)
    print(f"{cfg.name}-reduced: {count_params(model)/1e6:.2f}M params")

    loop = TrainLoop(
        cfg=cfg,
        model=model,
        optimizer=get_optimizer(cfg, lr=3e-3, warmup=20, total=args.steps),
        data=SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64, batch=8, seed=0),
    )
    hist = loop.run(args.steps, log_every=20)
    for s, l, t in zip(hist["step"], hist["loss"], hist["tokens_per_s"]):
        print(f"step {s:5d}  loss {l:7.4f}  {t:8.0f} tok/s")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise SystemExit(f"loss did not decrease: {hist['loss'][0]:.4f} -> "
                         f"{hist['loss'][-1]:.4f}")
    print("loss decreased — training path OK")


if __name__ == "__main__":
    main()
