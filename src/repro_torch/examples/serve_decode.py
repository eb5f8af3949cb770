"""Batched serving: prefill a batch of prompts, then decode tokens against
the ring-buffer KV cache (greedy) — the twin of the JAX package's
``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch gemma2-9b --batch 4 --prompt-len 24 --new-tokens 16 \
        [--device cpu]

(arch ids map to REDUCED variants here.) The cache is written in place
by each decode step (the JAX twin donates it); prompts are drawn from a
``torch.Generator`` seeded 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.examples import add_device, on_device, resolve_device
from repro_torch.models import transformer


def main(argv=None, params=None, prompts=None):
    """Returns the generated ids (batch, new tokens) on the CPU.
    ``params`` replaces the seed-0 weights and ``prompts`` (batch,
    prompt length) the drawn prompts."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_decode")
    ap.add_argument("--arch", default="gemma2-9b", choices=configs.ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)

    cfg = configs.get_reduced(args.arch)
    if cfg.is_encdec:
        raise SystemExit("use the transformer archs for this example")
    params = (transformer.init_params(cfg, seed=0, device=device)
              if params is None else on_device(params, device))
    max_len = args.prompt_len + args.new_tokens

    if prompts is None:
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len), generator=gen)
    prompts = torch.as_tensor(prompts).to(device)

    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, prompts,
                                        max_len=max_len, dtype=torch.float32)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=device)
    for _ in range(args.new_tokens - 1):
        logits, cache = transformer.decode_step(params, cfg, tok, cache, pos,
                                                dtype=torch.float32)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
        pos = pos + 1
    gen = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"prefill {args.prompt_len} + decode {args.new_tokens}")
    print(f"generated shape {tuple(gen.shape)}  {dt:.2f}s  "
          f"{tps:.1f} tok/s")
    print("first sequence:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
