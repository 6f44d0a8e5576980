"""The launcher's prefetch lane over an all-overlap schedule, for the tests
of the port on the CPU and on the card (no jax import).

Within a launcher epoch the batches are disjoint, so a run of
``train_dist`` patches no row.  ``all_overlap_run`` hands the launcher's
own epoch loop (``run_epoch_prefetch``, or the inline commit + step) a
schedule whose every batch is a permutation of one set of rows, so every
step but the last patches all of the next batch's rows.
"""
import numpy as np

from repro_torch.core import gst as G
from repro_torch.dist import pipeline as DP
from repro_torch.dist import train as DT
from repro_torch.graphs.experiment import epoch_generator
from repro_torch.launch import train_dist as TD


def all_overlap_schedule(n_rows: int, batch: int, steps: int, seed: int = 1):
    """``steps`` permutations of one random set of ``batch`` row ids."""
    rng = np.random.default_rng(seed)
    base = rng.permutation(n_rows)[:batch]
    return [rng.permutation(base).astype(np.int64) for _ in range(steps)]


def all_overlap_run(argv, steps: int = 4):
    """One epoch of ``steps`` all-overlap batches through ``train_dist``'s
    setup of ``argv`` (its own epoch loop: the lane under
    ``--prefetch-lookups``, else inline).  Returns (the last loss, shard
    0's parameters, the table (emb, age, init), the rows patched), all on
    the host."""
    s = TD.setup(TD.build_parser().parse_args(argv))
    try:
        sched = all_overlap_schedule(s.ds.n, s.args.batch_size, steps)
        gens = [epoch_generator(s.args.seed, 0) for _ in s.ctx.local_ranks]

        def sync():
            if s.ctx.device.type == "cuda":
                import torch
                torch.cuda.synchronize(s.ctx.device)

        if s.ctx.prefetch:
            feeder = DP.make_feeder("sync", s.ds, sched, s.put_pinned)
            states, loss, _, rows = TD.run_epoch_prefetch(
                s, s.states, feeder, gens, sync, [])
        else:
            states, rows = s.states, 0
            for item in DP.make_feeder("sync", s.ds, sched, s.put_writing):
                states, batches = s.commit(states, item)
                states, m = s.step(states, batches, gens)
                loss = m["loss"]
        table = tuple(DT.host_table(s.ctx, states, s.store))
        params = [p.detach().cpu() for p in G.train_params(states[0])]
        return float(loss), params, table, rows
    finally:
        s.store.close()
