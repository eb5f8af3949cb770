"""Paper Table 4 example: image classification with and without MBS across
mini-batch sizes, under a simulated memory cap — the twin of the JAX
package's ``examples/train_classifier.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_classifier \
        --batches 8 16 32 64 --steps 30 [--no-mbs] [--device cpu]

The ResNet (stage sizes (1, 1), width 8, 8 classes) starts from the same
seed for every batch size. As in the JAX twin, the BN statistics a step
returns are dropped and the evaluation uses the initial ones, and a
batch above ``MEMORY_CAP_BATCH`` without MBS is reported "Failed": the
cap stands for the paper's 24 GB card, not this device's memory.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import optim
from repro_torch.core import losses, mbs
from repro_torch.data import ClassificationDataset
from repro_torch.examples import add_device, on_device, resolve_device, staged
from repro_torch.models import cnn

STAGE_SIZES = (1, 1)
MEMORY_CAP_BATCH = 16  # simulated no-MBS failure point (paper: 24 GB GPU)


def main(argv=None, params=None):
    """Returns ``{batch: {"acc", "loss"} or "Failed"}``. ``params`` is an
    initial ``(params, state)`` pair replacing the seed-0 one."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_classifier")
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--no-mbs", action="store_true")
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)

    ds = ClassificationDataset(num_classes=8, image_size=args.image_size)
    opt = optim.sgd(0.01, momentum=0.9, weight_decay=5e-4)  # paper §4.2.4

    results = {}
    for batch in args.batches:
        init, state = (cnn.resnet_init(0, num_classes=8,
                                       stage_sizes=STAGE_SIZES, width=8,
                                       device=device)
                       if params is None else on_device(params, device))

        def loss_fn(p, b, exact_denom=None):
            logits, _ = cnn.resnet_forward(p, state, b["image"],
                                           stage_sizes=STAGE_SIZES,
                                           train=True)
            return losses.cross_entropy(
                logits, b["label"], sample_weight=b.get("sample_weight"),
                exact_denom=exact_denom), {
                    "acc": losses.accuracy(logits, b["label"])}

        use_mbs = not args.no_mbs
        if not use_mbs and batch > MEMORY_CAP_BATCH:
            print(f"batch {batch:4d}  w/o MBS: Failed (exceeds memory cap)")
            results[batch] = "Failed"
            continue
        micro = min(args.micro, batch)
        step = (mbs.make_mbs_train_step(loss_fn, opt, mbs.MBSConfig(micro))
                if use_mbs else mbs.make_baseline_train_step(loss_fn, opt))
        p, s = init, opt.init(init)
        t0 = time.perf_counter()
        for i in range(args.steps):
            mini = ds.batch(batch, i)
            data = staged(mbs.split_minibatch(mini, micro) if use_mbs
                          else mini, device)
            p, s, m = step(p, s, data)
        ev = staged(ds.batch(128, 10 ** 6, train=False), device)
        logits, _ = cnn.resnet_forward(p, state, ev["image"],
                                       stage_sizes=STAGE_SIZES, train=False)
        acc = float(losses.accuracy(logits, ev["label"]))
        loss = float(m["loss"])
        mode = f"w/ MBS (mu={micro})" if use_mbs else "w/o MBS"
        print(f"batch {batch:4d}  {mode:16s}  acc {acc:.3f}  "
              f"loss {loss:.3f}  {time.perf_counter() - t0:.1f}s",
              flush=True)
        results[batch] = {"acc": acc, "loss": loss}
    return results


if __name__ == "__main__":
    main()
