"""Readings of the control: the reference in TF32 against the float64
reference, at a cell's own size, on several seeds.

    python -m hgcn_bench.control --workload reddit.batch --seeds 1 2 3

For each seed it makes the run's inputs (the configuration's graph,
the weights and the feature pool from the seed, as a run makes them,
through the configuration's model module), computes every snapshot's
logits with the model's reference in ``precision="tf32"`` and in
float64, and prints one JSON line a seed with the largest ``logit_err``
over the snapshots. The control has to read above the configuration's
limit: it is the step below the float32 (TF32 off) that the
configuration states. It does not run the program.
"""
from __future__ import annotations

import argparse
import json
import sys

from hgcn_bench import graphgen
from hgcn_bench.reference import logit_err
from hgcn_bench.spec import model_of, resolve


def readings(cell, seeds, device="cuda",
             cache_dir=graphgen.CACHE_DIR) -> list:
    import torch

    atil, _, _ = graphgen.load_graph(cell.config["name"],
                                     cell.config["graph"], cache_dir)
    model = model_of(cell.config)
    ref = model.reference(atil, device, "float64")
    ctl = model.reference(atil, device, "tf32")
    out = []
    for seed in seeds:
        weights, pool = model.make_inputs(torch, cell.config, cell.traffic,
                                          seed, atil.shape[0], device)
        worst = 0.0
        for k in range(pool.shape[0]):
            want = ref.logits(pool[k], weights)
            worst = max(worst, logit_err(ctl.logits(pool[k], weights), want))
        out.append({"workload": cell.name, "seed": seed,
                    "control_logit_err": worst,
                    "limit": cell.config["limits"]["logit_err"]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for row in readings(resolve(args.workload), args.seeds, args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
