"""End-to-end run of the PyTorch port: train a scaled-down assigned
architecture for a few hundred steps with GST+EFD on the sequence track.

The counterpart of ``examples/llm_segment_training.py``, at its config:
internlm2-1.8b's family scaled down (8 layers, d_model 512, vocab 2048,
the full config's code path), which holds 27M parameters (the reference
example's docstring says ~100M); documents are 4-segment token sequences
whose property (the majority topic) needs whole-input evidence.  Runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/llm_segment_training_torch.py [--steps 300]
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import gst as G
from repro_torch.core.embedding_table import init_table
from repro_torch.data.tokens import doc_batch_iterator, make_property_docs
from repro_torch.graphs.experiment import epoch_generator
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.optim import cosine_schedule, make_optimizer


def main(steps: int = 300, device: str = "cuda", log_every: int = 25):
    dev = resolve_device(device)
    base = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(
        base, num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        d_ff=1536, vocab_size=2048, head_dim=64, gst_num_segments=4,
        gst_num_classes=5)
    # the encode trains: the plain attention (the kernel has no backward);
    # the SED pooling below goes through the sed_pool kernel
    model = build_model(cfg, use_kernels=False, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    backbone = ParamTree(model.init(gen))
    n_params = sum(p.numel() for p in backbone.parameters())
    print(f"backbone: {cfg.name} family, {n_params / 1e6:.0f}M params "
          f"on {dev}")

    J, L = 4, 128
    n_docs = 256
    docs = make_property_docs(n_docs=n_docs, n_segments=J, seg_len=L,
                              vocab=cfg.vocab_size, n_topics=5, seed=0)
    head = G.head_init(cfg.d_model, 5, "mlp", gen, dev)
    opt = make_optimizer("adamw", lr=3e-4, weight_decay=0.01,
                         schedule=cosine_schedule(3e-4, steps, warmup=20))
    state = G.TrainState(backbone, head, None,
                         init_table(n_docs, J, cfg.d_model, device=dev), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))
    step = G.make_train_step(
        lambda p, s: model.encode_segment(p.tree, s), opt,
        G.VARIANTS["gst_efd"], keep_prob=0.5, use_kernels=True)

    rng = np.random.default_rng(0)
    it, t0 = 0, time.time()
    accs = []
    while it < steps:
        for tokens, seg_valid, ids, labels in doc_batch_iterator(
                docs, 16, rng=rng):
            batch = G.GSTBatch(
                {"tokens": torch.from_numpy(tokens["tokens"]).to(dev)},
                torch.from_numpy(seg_valid).to(dev),
                torch.from_numpy(ids.astype(np.int64)).to(dev),
                torch.from_numpy(labels).to(dev))
            state, m = step(state, batch, epoch_generator(0, it))
            accs.append(float(m["metric"]))
            it += 1
            if it % log_every == 0:
                print(f"step {it:4d}: loss={float(m['loss']):.3f} "
                      f"acc({log_every})={np.mean(accs[-log_every:]):.3f} "
                      f"({(time.time() - t0) / it * 1e3:.0f} ms/step)",
                      flush=True)
            if it >= steps:
                break
    final = float(np.mean(accs[-50:]))
    print(f"final train accuracy (last 50 steps): {final:.3f} (chance 0.2)")
    return final


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    sys.exit(0 if main(args.steps, args.device) > 0.3 else 1)
