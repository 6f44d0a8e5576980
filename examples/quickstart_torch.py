"""Quickstart of the PyTorch port: GST+EFD on a synthetic MalNet-like
dataset, the counterpart of ``examples/quickstart.py`` at its sizes.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Walks the full pipeline: generate graphs -> partition (METIS-like BFS) ->
padded segment batches -> GST+EFD training (sampled-segment backprop +
historical embedding table + SED) -> prediction-head finetuning -> eval,
through the steps of ``repro_torch.core.gst`` with the port's kernels on
(their plain versions on CPU tensors).  The steps draw from an explicit
``torch.Generator``.  Runs on the card unless ``--device cpu``; exits 1
when the test accuracy is at or below 0.3.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gst as G
from repro_torch.core.embedding_table import init_table
from repro_torch.graphs import batching as Bt
from repro_torch.graphs import data as D
from repro_torch.graphs.experiment import to_batch
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
from repro_torch.optim import make_optimizer


def main(n_graphs: int = 80, n_train: int = 64, max_seg_nodes: int = 64,
         hidden: int = 64, epochs: int = 30, finetune_epochs: int = 10,
         device: str = "cuda") -> float:
    dev = resolve_device(device)
    # 1. data + preprocessing (paper §3.1: partition once, up front)
    graphs = D.make_malnet_like(n_graphs=n_graphs, seed=0)
    train, test = graphs[:n_train], graphs[n_train:]
    ds = Bt.segment_dataset(train, max_seg_nodes=max_seg_nodes, method="bfs")
    ds_test = Bt.segment_dataset(test, max_seg_nodes=max_seg_nodes,
                                 method="bfs", j_max=ds.j_max, e_max=ds.e_max)
    print(f"{ds.n} train graphs, J_max={ds.j_max} segments of <= {ds.m_max} "
          f"nodes, on {dev}")

    # 2. model: SAGE backbone F + MLP head F'
    cfg = GNNConfig(backbone="sage", n_feat=8, hidden=hidden,
                    use_kernels=True)
    encode = make_encode_fn(cfg)
    gen = torch.Generator().manual_seed(0)
    backbone = gnn_init(cfg, gen, "cpu").to(dev)
    head = G.head_init(hidden, 5, "mlp", gen, "cpu").to(dev)
    opt = make_optimizer("adam", lr=5e-3)
    state = G.TrainState(backbone, head, None,
                         init_table(ds.n, ds.j_max, hidden, device=dev), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    # 3. GST+EFD training (Algorithm 2); the sampled segments and the SED
    # draws come from one generator
    step = G.make_train_step(encode, opt, G.VARIANTS["gst_efd"],
                             keep_prob=0.5, use_kernels=True)
    eval_step = G.make_eval_step(encode, use_kernels=True)
    refresh = G.make_refresh_step(encode)
    draws = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)

    def batches(d, shuffle=True):
        for tup in Bt.batch_iterator(d, 8, rng=rng, shuffle=shuffle):
            yield to_batch(*tup, dev)

    for epoch in range(epochs):
        for batch in batches(ds):
            state, m = step(state, batch, draws)
        if (epoch + 1) % 10 == 0:
            print(f"epoch {epoch+1}: loss={float(m['loss']):.3f} "
                  f"train_acc={float(m['metric']):.3f}")

    # 4. head finetuning (paper §3.3): refresh table, train F' only
    for batch in batches(ds, shuffle=False):
        state = refresh(state, batch)
    ft_opt = make_optimizer("adam", lr=2e-3)
    state = state._replace(opt_state=ft_opt.init(
        list(state.head.parameters())))
    ft = G.make_finetune_step(ft_opt, use_kernels=True)
    for _ in range(finetune_epochs):
        for batch in batches(ds):
            state, m = ft(state, batch)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    # 5. eval (all segments fresh — the paper's test distribution)
    accs = [float(eval_step(state, b)["metric"])
            for b in batches(ds_test, False)]
    print(f"test accuracy: {np.mean(accs):.3f} (chance = 0.2)")
    return float(np.mean(accs))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    acc = main(device=ap.parse_args().device)
    sys.exit(0 if acc > 0.3 else 1)
