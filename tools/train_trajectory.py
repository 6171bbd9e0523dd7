#!/usr/bin/env python3
"""SpectralNet's SGD trajectory in float32 (the port) against float64.

Runs ``train_step`` of kofft_tpu_torch's SpectralNet (entry widths: win
256, hop 128, 32 mel bands, 8 classes) for ``--steps`` steps at ``--lr``
from one of three points, and beside it the same SGD on the float64
autograd reference of ``chip_smoke.spectral_net_loss_f64`` (an
implementation independent of the port), printing after each step both
losses (each at the parameters before the step) and the SNR of every
parameter after it against float64, as one JSON line.

Points: ``init`` is ``init(0)`` (six empty mel bands); ``off`` moves the
mel table by 0.01 N(0,1) with a unit-variance head and bias; ``steady``
moves it by 0.01 |N(0,1)| with a head at init's scale and a bias of
0.1 N(0,1). The batch is (``--batch``, ``--samples``) of seeded normal
samples with seeded labels.

    python tools/train_trajectory.py --batch 256 --steps 10 --lr 1e-3
    python tools/train_trajectory.py --device cuda ...   # on a card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def start_point(model, which: str, seed: int):
    """The params NamedTuple of ``which`` as float32 numpy arrays."""
    p = model.init(0)
    rng = np.random.default_rng(seed)
    draw = rng.standard_normal
    if which == "off":
        return type(p)(p.mel + 0.01 * draw(p.mel.shape).astype(np.float32),
                       draw(p.w_head.shape).astype(np.float32),
                       draw(p.b_head.shape).astype(np.float32))
    if which == "steady":
        return type(p)(
            p.mel + 0.01 * np.abs(draw(p.mel.shape)).astype(np.float32),
            (draw(p.w_head.shape) / np.sqrt(p.mel.shape[1])).astype(
                np.float32),
            0.1 * draw(p.b_head.shape).astype(np.float32))
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--samples", type=int, default=16000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--point", choices=["init", "off", "steady"],
                    default="init")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as C
    from kofft_tpu_torch.models import SpectralNet, train_step

    model = SpectralNet(device=args.device)
    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.batch, args.samples), dtype=np.float32)
    y = rng.integers(0, model.n_classes, args.batch).astype(np.int32)
    p32 = start_point(model, args.point, args.seed + 1)
    p64 = [np.asarray(q, np.float64) for q in p32]
    xt = torch.as_tensor(x, device=model.device)
    yt = torch.as_tensor(y, device=model.device)
    for step in range(args.steps):
        p32, loss = train_step(model, p32, xt, yt, args.lr)
        loss64, g64 = C.spectral_net_loss_f64(p64, x, y, model.win_len,
                                              model.hop)
        p64 = [q - args.lr * g for q, g in zip(p64, g64)]
        got = [q.double().cpu().numpy() for q in p32]
        print(json.dumps({
            "step": step + 1, "loss": loss.item(), "loss_float64": loss64,
            "params_vs_float64_db": C.grad_snrs(
                p64, got, model.init(0)._fields),
            "device": str(model.device), "batch": [args.batch, args.samples],
            "lr": args.lr, "point": args.point}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
