"""Batched serving example of the PyTorch port: prefill + decode across
architecture families (the counterpart of examples/serve_batched.py).

    PYTHONPATH=src python examples/serve_batched_torch.py              # card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Serves the reduced configs of five families (dense, hybrid Mamba2 with
shared attention, RWKV-6, MLA + MoE, encoder-decoder) with random weights
from seed 0: the prompt runs through ``decode_step`` token by token
(teacher-forced), then the model generates greedily.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, encdec

ARCHS = ["olmo-1b", "zamba2-1.2b", "rwkv6-7b", "deepseek-v3-671b",
         "whisper-large-v3"]


def serve_one(arch: str, device, batch=2, prompt=8, gen=8):
    """The (batch, gen) tokens generated by the reduced ``arch``."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)
    total = prompt + gen
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt))).to(device)
    caches = model.init_cache(batch, total, torch.float32)
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.normal(
            size=(batch, cfg.encoder_seq_len, cfg.d_model))).float().to(device)
        caches = {"self": caches,
                  "cross": encdec.cross_kv(params, cfg,
                                           encdec.encode(params, cfg, frames))}
    cur = toks[:, :1]
    out = []
    t0 = time.time()
    for t in range(total - 1):
        logits, caches = model.decode_step(
            params, cur, caches, torch.full((batch,), t, device=device))
        nxt = torch.argmax(logits[:, -1], -1)[:, None]
        cur = toks[:, t + 1:t + 2] if t + 1 < prompt else nxt
        if t + 1 >= prompt:
            out.append(nxt[:, 0].cpu().numpy())
    dt = (time.time() - t0) / (total - 1) * 1e3
    print(f"{arch:22s} generated {len(out)} tokens/seq x{batch} "
          f"({dt:.0f} ms/step)")
    return np.stack(out, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {arch: serve_one(arch, device) for arch in ARCHS}


if __name__ == "__main__":
    main()
    sys.exit(0)
