"""Training CLI (counterpart of ``repro.launch.train``).

Smoke size on the host (float32, a few seconds a step):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --device cpu --steps 20

Without ``--device cpu`` it trains on the card (CUDA kernels, flash
attention's forward and backward among them); without ``--smoke`` at the
arch's full width in its compute dtype on float32 master weights.
Checkpoints go to ``--ckpt-dir`` every ``--ckpt-every`` steps and at the
end; a run started again with the same directory resumes from the latest.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenLoader
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (host-sized), float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    if cfg.encdec:
        raise SystemExit(f"{cfg.name}: the token loader has no audio frames; "
                         "train it through Model.loss with a frames batch")
    model = Model(cfg, device=args.device)
    print(f"{cfg.name}: {model.n_params():,} params on {model.device}")
    hp = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    loader = TokenLoader(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                         device=args.device)
    tc = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10)
    Trainer(model, make_train_step(model, hp), loader, tc).run()


if __name__ == "__main__":
    main()
