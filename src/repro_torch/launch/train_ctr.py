"""Training driver: DCNv2 on synthetic Criteo with checkpoint/restart,
then AUC/LogLoss served through a "dual" plan.

Counterpart of ``examples/train_ctr.py``, with its flags, model and output
lines, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train_ctr [--steps 300]
    PYTHONPATH=src python -m repro_torch.launch.train_ctr --device cpu \\
        --steps 3

The full heavy-tail Criteo schema at d=16 gives ≈107M embedding
parameters. Interrupt a run at any point and start it again: it resumes
from the newest intact checkpoint in ``--ckpt-dir``. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs the
plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ctr_spec
from repro_torch.core import compile_plan
from repro_torch.data import CRITEO, CTRLoader, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.ctr import DCNv2
from repro_torch.training import (AdamWConfig, TrainLoopConfig, adamw_init,
                                  logloss, make_ctr_step, roc_auc,
                                  run_train_loop)

__all__ = ["main"]

#: the validation batch: step index and rows (``examples/train_ctr.py``)
VAL_STEP, VAL_ROWS = 10_000, 8192


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ctr_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    schema = CRITEO          # full heavy-tail schema: ~6.7M rows
    spec = ctr_spec("dcnv2", "criteo", embed_dim=16, hidden=256)
    model = DCNv2(spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    params = model.param_tree()
    n = model.n_params(params)
    print(f"model: dcnv2/criteo  params = {n/1e6:.1f}M")

    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, ckpt_every=100,
                               ckpt_dir=args.ckpt_dir, log_every=25)
    state, hist = run_train_loop(
        make_ctr_step(model, opt), state,
        batch_fn=CTRLoader(schema, args.batch, device=dev), cfg=loop_cfg)

    # evaluation through the DPIFrame dual executor
    plan = compile_plan(model, "dual", VAL_ROWS, device=dev)
    val = synthetic_batch(schema, VAL_STEP, VAL_ROWS, device="cpu")
    probs = plan.predict(val["ids"].numpy())
    labels = val["labels"].numpy()
    print(f"val AUC = {roc_auc(labels, probs):.4f}   "
          f"LogLoss = {logloss(labels, probs):.4f}")
    if hist:
        print(f"first-loss {hist[0]['loss']:.4f} -> last-loss "
              f"{hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
