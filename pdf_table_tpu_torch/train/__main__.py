"""LORE TSR training on one card (counterpart of tools/train_tsr_lore.py).

    python -m pdf_table_tpu_torch.train --image_dir WTW/images \
        --label_path WTW/train.json --reader mypkg.io:read_rgb --steps 1000

``--reader MODULE:FUNCTION`` names ``read(path) -> uint8 RGB (H, W, 3)``:
the port decodes no image format itself (the card's machine has neither
cv2 nor PIL); where cv2 is installed, a two-line function around
``cv2.imread`` serves.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os


def load_reader(spec: str):
    """``"module:function"`` -> the function."""
    module, _, name = spec.partition(":")
    if not name:
        raise ValueError(f"--reader takes MODULE:FUNCTION, got {spec!r}")
    return getattr(importlib.import_module(module), name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pdf_table_tpu_torch.train")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--label_path", default=None)
    p.add_argument("--reader", required=True,
                   help="MODULE:FUNCTION, read(path) -> uint8 RGB array")
    p.add_argument("--task_type", default="wtw")
    p.add_argument("--backbone", default="dla34")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--output_dir", default="lore_train")
    p.add_argument("--eval_every", type=int, default=0,
                   help="kept for the JAX tool's command line; no eval set "
                        "is wired")
    p.add_argument("--resume", default=None,
                   help="train_state dir of an earlier run "
                        "(save_train_state): resumes the optimizer and step")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint the forward stage by stage: less "
                        "activation memory, a second forward")
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    from ..data import WtwDataset
    from ..models.lore.config import LoreConfig
    from .lore_trainer import LoreTrainArgs, LoreTrainer

    cfg = LoreConfig.wtw(backbone=args.backbone) \
        if args.task_type == "wtw" \
        else LoreConfig.wireless(backbone=args.backbone)
    ds = WtwDataset(args.image_dir, args.label_path, config=cfg,
                    reader=load_reader(args.reader))
    print(f"dataset: {len(ds)} images")
    train_args = LoreTrainArgs(learning_rate=args.learning_rate,
                               batch_size=args.batch_size,
                               total_steps=args.steps,
                               output_dir=args.output_dir,
                               remat=args.remat,
                               grad_accum_steps=args.grad_accum_steps)
    trainer = LoreTrainer(cfg, train_args, device=args.device)
    if args.resume:
        trainer.restore_train_state(args.resume)
        print(f"resumed at step {trainer.state.step}")
    history = trainer.fit(ds, args.steps)
    trainer.save_checkpoint()
    trainer.save_train_state()
    with open(os.path.join(args.output_dir, "history.json"), "w") as f:
        json.dump(history, f)
    print(f"done; best loss {trainer.best_loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
