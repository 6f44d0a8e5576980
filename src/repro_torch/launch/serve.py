"""Serving launcher of the sequence track: teacher-forced decode over the
prompt, then autoregressive decode.

Counterpart of ``src/repro/launch/serve.py``:

    # internlm2-1.8b at full size with random weights, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 2 --prompt-len 16 --gen 16

    # a reduced model of any ported family on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch internlm2-1.8b --reduced   # or arctic-480b, deepseek-v3-671b,
                                          # qwen2-vl-7b, whisper-large-v3

Runs on the card (``--device cuda``, the default; it raises where no card
is visible) unless ``--device cpu`` is given.  As in the reference, the
prompt is run through ``decode_step`` token by token (the cache is as long
as prompt + generated tokens), so no full-sequence pass and no attention
kernel runs here: ``Model.prefill`` is the full forward that does.  The
VLM's patches and the encoder-decoder's frames are drawn as the reference
draws them; the patches go unused (decode has no patch prefix, as in the
reference), the frames are encoded once into the cross-attention K/V
before the decode loop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import build_model, encdec


def serve(args, params=None, cfg=None):
    """Returns the generated tokens, (batch, gen) int.  ``params``: weights
    to serve (e.g. carried over from the JAX package); None draws them from
    ``--seed`` on the device.  ``cfg``: the config to serve (e.g. one cut
    in depth); None takes ``--arch``'s, reduced with ``--reduced``."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(args.seed))
    B = args.batch
    total = args.prompt_len + args.gen
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, args.prompt_len))).to(device)
    inputs = {"tokens": tokens}
    if cfg.family == "vlm":
        inputs["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.vision_prefix_len, cfg.d_model))).float().to(device)
    if cfg.is_encoder_decoder:
        inputs["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model))).float().to(device)

    t0 = time.time()
    # prefill by running decode over the prompt (cache len = total)
    caches = model.init_cache(B, total, torch.float32)
    if cfg.is_encoder_decoder:
        enc_out = encdec.encode(params, cfg, inputs["frames"])
        caches = {"self": caches,
                  "cross": encdec.cross_kv(params, cfg, enc_out)}
    out_tokens = []
    cur = tokens[:, :1]
    for t in range(total - 1):
        pos = torch.full((B,), t, dtype=torch.int64, device=device)
        logits, caches = model.decode_step(params, cur, caches, pos)
        nxt = torch.argmax(logits[:, -1], -1)[:, None]
        if t + 1 < args.prompt_len:
            cur = tokens[:, t + 1: t + 2]  # teacher-forced prompt
        else:
            cur = nxt
            out_tokens.append(nxt[:, 0].cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    gen = np.stack(out_tokens, 1) if out_tokens else np.zeros((B, 0), np.int64)
    print(f"[{cfg.name}] generated {gen.shape} in {dt:.1f}s "
          f"({dt / max(total - 1, 1) * 1e3:.0f} ms/token)")
    print("sample:", gen[0][:16].tolist())
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
