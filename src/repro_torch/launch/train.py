"""Training driver for the LM zoo's ten archs.

Counterpart of ``repro.launch.train``, with its flags and output lines,
plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m

The model's weights come from seed 0; step ``t``'s batch (tokens, and
frames × 0.1 for whisper or 4 patch rows × 0.02 for pixtral, in the
config's dtype) from a ``torch.Generator`` seeded with ``t`` on the
device, so a batch is a pure function of its step and a resumed run sees
the batches an unbroken one would. AdamW at lr 1e-3; a checkpoint every 50
steps in ``--ckpt-dir`` (the port's per-layer layout, not the reference's
stacked leaves), resumed from with ``--resume auto``. ``--device``
defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import make_lm_model
from repro_torch.training import (AdamWConfig, TrainLoopConfig, adamw_init,
                                  make_train_step, run_train_loop)

__all__ = ["lm_batch_fn", "main"]

#: pixtral's patch rows a sample, as the reference's driver draws them
N_PATCHES = 4


def lm_batch_fn(cfg, batch: int, seq: int, device) -> Callable[[int], dict]:
    """``batch_fn(step)`` for ``run_train_loop``: ``tokens`` (batch, seq)
    uniform over the vocabulary, plus whisper's ``frames`` (batch, seq,
    d) × 0.1 or pixtral's ``patch_embeds`` (batch, 4, d) × 0.02 drawn in
    ``cfg.dtype``, all from a generator on ``device`` seeded with the
    step."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg.dtype)

    def batch_fn(step: int) -> dict:
        g = torch.Generator(device=dev).manual_seed(step)
        out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                       generator=g, device=dev)}
        if cfg.family == "encdec":
            out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=g, device=dev,
                                        dtype=dtype) * 0.1
        if cfg.family == "vlm":
            out["patch_embeds"] = torch.randn(
                (batch, N_PATCHES, cfg.d_model), generator=g, device=dev,
                dtype=dtype) * 0.02
        return out
    return batch_fn


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_lm_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(model.param_tree(), opt)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                           ckpt_dir=args.ckpt_dir, resume=args.resume,
                           log_every=10)
    state, hist = run_train_loop(make_train_step(model, opt), state,
                                 lm_batch_fn(cfg, args.batch, args.seq, dev),
                                 loop)
    if hist:
        print(f"[train] {args.arch}: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f} over {len(hist)} steps")


if __name__ == "__main__":
    main()
