"""Training launcher of the port: the graph track.

Counterpart of ``src/repro/launch/train.py`` (``--track graph``):

    # GST+EFD on synthetic MalNet with a SAGE backbone, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --track graph \
        --backbone sage --variant gst_efd --epochs 30

    # the same on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --track graph \
        --device cpu --epochs 3 --finetune-epochs 1 --n-graphs 48

Runs on the card (``--device cuda``, the default; it raises where no card
is visible) unless ``--device cpu`` is given.  ``--lr`` does not reach the
graph track, which trains at ``run_experiment``'s 5e-3: the reference's
``train_graph`` passes no learning rate either.  The seq and lm tracks land
with the sequence slice, ``--metrics``/``--trace-out`` with the telemetry
slice, and the tiered-store flags parse here but raise
``NotImplementedError`` until the store slice.
"""
from __future__ import annotations

import argparse

from repro_torch.core import gst as G


def train_graph(args):
    from repro_torch.graphs.experiment import run_experiment
    r = run_experiment(
        dataset=args.dataset, backbone=args.backbone, variant=args.variant,
        n_graphs=args.n_graphs, epochs=args.epochs,
        finetune_epochs=args.finetune_epochs, keep_prob=args.keep_prob,
        seed=args.seed, use_kernels=args.use_kernels, device=args.device,
        table_device_rows=args.table_device_rows,
        wb_threshold=args.wb_threshold,
        sed_age_weighting=args.sed_age_weighting,
        stale_forecast=args.stale_forecast)
    print(f"[graph/{args.dataset}] {args.backbone} {args.variant}"
          f"{' [kernels]' if args.use_kernels else ''} on {args.device}: "
          f"train={r.train_metric:.3f} test={r.test_metric:.3f} "
          f"{r.ms_per_iter:.1f} ms/iter")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", default="graph", choices=["graph"])
    ap.add_argument("--dataset", default="malnet", choices=["malnet", "tpugraphs"])
    ap.add_argument("--backbone", default="sage", choices=["gcn", "sage", "gps"])
    ap.add_argument("--n-graphs", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--finetune-epochs", type=int, default=10)
    ap.add_argument("--variant", default="gst_efd", choices=list(G.VARIANTS))
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route the SpMM and the SED pooling through the "
                         "port's kernels (their plain versions on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keep-prob", type=float, default=0.5)
    ap.add_argument("--table-device-rows", type=int, default=None,
                    help="cap device-resident historical-table rows "
                         "(the store slice; raises until then)")
    ap.add_argument("--wb-threshold", type=float, default=0.0,
                    help="delta-gated write-back under --table-device-rows "
                         "(the store slice; raises until then)")
    ap.add_argument("--sed-age-weighting", type=float, default=0.0,
                    help="λ of the exp(-λ·age) staleness decay folded into "
                         "the stale branch of Eq.-1 η (use_sed+use_table "
                         "variants). 0 = off")
    ap.add_argument("--stale-forecast", action="store_true",
                    help="extrapolate stale host-tier rows on fault-in "
                         "(the store slice; raises until then)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="does not reach the graph track (as in the "
                         "reference), which trains at 5e-3")
    args = ap.parse_args(argv)
    return train_graph(args)


if __name__ == "__main__":
    main()
