"""TpuGraphs-style ranking with GST through the PyTorch port (paper §5.3),
the counterpart of ``examples/tpugraphs_ranking.py``: per-segment runtime
prediction + sum pooling (the head is part of F; F' = Σ), PairwiseHinge
loss, OPA metric, for four variants, their train steps taken in turns
(``run_in_lockstep``) so that their times per iteration compare.

    PYTHONPATH=src python examples/tpugraphs_ranking_torch.py [--device cpu]

Runs on the card unless ``--device cpu``.
"""
import argparse
import sys

from repro_torch.graphs.experiment import run_in_lockstep


def main(n_graphs: int = 64, epochs: int = 25, device: str = "cuda"):
    print("variant      train_OPA  test_OPA  ms/iter")
    variants = ["gst", "gst_one", "gst_e", "gst_efd"]
    # the four runs' train steps in turns: on the card a step is host
    # bound, and runs made one after the other would also compare the
    # host's drift between them
    results = dict(zip(variants, run_in_lockstep([
        dict(dataset="tpugraphs", backbone="sage", variant=variant,
             n_graphs=n_graphs, epochs=epochs, finetune_epochs=0, seed=0,
             device=device) for variant in variants])))
    for variant, r in results.items():
        print(f"{variant:12s} {r.train_metric:8.3f} {r.test_metric:9.3f} "
              f"{r.ms_per_iter:7.1f}")
    # the paper's Table 2 ordering: GST fits train best; E-variants are
    # faster per iteration than GST
    if not results["gst"].ms_per_iter > results["gst_e"].ms_per_iter:
        raise AssertionError(
            f"gst's ms_per_iter {results['gst'].ms_per_iter} is not above "
            f"gst_e's {results['gst_e'].ms_per_iter}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=ap.parse_args().device)
    sys.exit(0)
