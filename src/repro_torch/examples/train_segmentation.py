"""Paper Table 5 example: U-Net semantic segmentation with BCE+Dice loss and
Adam (the paper's setup), trained with MBS beyond the no-MBS batch
limit; reports IoU — the twin of the JAX package's
``examples/train_segmentation.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_segmentation \
        --batch 32 --steps 40 [--device cpu]

U-Net of base 8 and depth 2 through the ``compiled`` executor, as in
the JAX twin (so no fused Adam kernel runs). The BN statistics a step
returns are dropped, as there.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import optim
from repro_torch.core import losses, mbs
from repro_torch.data import SegmentationDataset
from repro_torch.examples import add_device, on_device, resolve_device, staged
from repro_torch.models import cnn


def main(argv=None, params=None):
    """Returns ``{"losses": {step: loss} of the printed steps, "iou"}``.
    ``params`` is an initial ``(params, state)`` pair replacing the
    seed-0 one."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_segmentation")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--image-size", type=int, default=24)
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)

    params, state = (cnn.unet_init(0, base=8, depth=2, device=device)
                     if params is None else on_device(params, device))
    ds = SegmentationDataset(image_size=args.image_size)
    opt = optim.adam(1e-2, weight_decay=5e-4)  # paper §4.2.4

    def loss_fn(p, b, exact_denom=None):
        logits, _ = cnn.unet_forward(p, state, b["image"], depth=2,
                                     train=True)
        return losses.bce_dice_loss(  # paper eq. (20)
            logits, b["mask"], sample_weight=b.get("sample_weight"),
            exact_denom=exact_denom), {}

    micro = min(args.micro, args.batch)
    step = mbs.make_mbs_train_step(loss_fn, opt, mbs.MBSConfig(micro))
    p, s = params, opt.init(params)
    printed = {}
    t0 = time.perf_counter()
    for i in range(args.steps):
        split = staged(mbs.split_minibatch(ds.batch(args.batch, i), micro),
                       device)
        p, s, m = step(p, s, split)
        if i % 10 == 0:
            printed[i] = float(m["loss"])
            print(f"step {i:3d}  loss {printed[i]:.4f}", flush=True)
    ev = staged(ds.batch(32, 10 ** 6), device)
    logits, _ = cnn.unet_forward(p, state, ev["image"], depth=2, train=False)
    iou = float(losses.iou(logits, ev["mask"]))
    print(f"IoU {iou:.4f}  ({time.perf_counter() - t0:.1f}s, mini-batch "
          f"{args.batch}, micro {micro})")
    return {"losses": printed, "iou": iou}


if __name__ == "__main__":
    main()
