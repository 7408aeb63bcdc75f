"""Quickstart: the full H-GCN pipeline on a synthetic Cora, on the port.

  synthesize graph -> reorder (community labels) -> tri-partition
  (Algorithms 1+2) -> train the paper's 2-layer GCN through the
  heterogeneous SpMM executor (forward and backward through the hand
  kernels on the card) -> evaluate -> serve the trained weights.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      (add ``--device cpu`` to run the plain versions on the CPU, and
      ``--scale 0.3`` for a smaller Cora)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import reorder
from repro_torch.core.formats import partition_to, reduction_plan
from repro_torch.core.hybrid_spmm import gcn_forward
from repro_torch.core.partition import PartitionConfig, analyze_and_partition
from repro_torch.data.graphs import make_paper_dataset
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.models.common import normal_init
from repro_torch.train.optimizer import AdamW
from repro_torch.train.steps import make_hybrid_gcn_train_step

HIDDEN = 128
TILE = 64
# served vs training logits: the class-padded X·W runs at another M, and
# cuBLAS may sum its 1433 terms in another order
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)


def prepare(name: str = "cora", *, scale: float = 1.0, seed: int = 0,
            device="cuda", reorder_by: str = "labels") -> dict:
    """Data and offline preprocessing (paper §IV-B: reorder once,
    offline): the graph reordered by its planted communities (or not,
    ``reorder_by=None``), partitioned at T = 64 and placed on ``device``
    with its reduction plan; labels = community id mod the class count
    (learnable from the graph's structure); a 60 % train mask from
    ``seed``."""
    dev = resolve_device(device)
    csr, x, _, st = make_paper_dataset(name, scale=scale, seed=seed)
    labels = make_paper_dataset.last_labels
    perm, t_reorder = np.arange(csr.shape[0]), 0.0
    if reorder_by is not None:
        csr, perm, t_reorder = reorder(csr, reorder_by, labels=labels)
    host_part, meta, _ = analyze_and_partition(csr,
                                               PartitionConfig(tile=TILE))
    part = partition_to(host_part, dev)
    y = (labels[perm] % st.n_classes).astype(np.int64)
    train = np.random.default_rng(seed).random(meta.n_rows) < 0.6
    return dict(
        name=name, stats=st, csr=csr, host_part=host_part, part=part,
        meta=meta,
        plan=reduction_plan(part, meta, device=dev), reorder_s=t_reorder,
        x=torch.from_numpy(x[perm]).to(dev), y=torch.from_numpy(y).to(dev),
        train=torch.from_numpy(train).to(dev),
        test=torch.from_numpy(~train).to(dev), device=dev)


def init_weights(data: dict, *, hidden: int = HIDDEN, seed: int = 0) -> list:
    """The two GCN weights, N(0, 0.05²) from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    st = data["stats"]
    return [normal_init(gen, (st.n_features, hidden), 0.05).to(data["device"]),
            normal_init(gen, (hidden, st.n_classes), 0.05).to(data["device"])]


def forward_kw(data: dict, *, backend: str = "cuda",
               ell_dispatch: str = "ragged") -> dict:
    return dict(meta=data["meta"], plan=data["plan"], backend=backend,
                ell_dispatch=ell_dispatch, device=data["device"])


@torch.no_grad()
def accuracy(data: dict, ws, mask, **kw) -> float:
    kw = dict(forward_kw(data), **kw)
    logits = gcn_forward(data["part"], data["x"], ws, **kw)
    hit = (torch.argmax(logits, -1) == data["y"]) & mask
    return float(hit.sum() / mask.sum())


def train(data: dict, ws, *, steps: int = 60, lr: float = 5e-3,
          weight_decay: float = 1e-4, log_every: int = 0, **kw) -> tuple:
    """``steps`` AdamW steps of the masked cross-entropy on the train
    mask. Returns (weights, optimizer state, losses)."""
    opt = AdamW(lr=lr, weight_decay=weight_decay)
    state = opt.init(ws)
    step = make_hybrid_gcn_train_step(data["part"], opt,
                                      **dict(forward_kw(data), **kw))
    batch = {"x": data["x"], "labels": data["y"], "mask": data["train"]}
    losses = []
    for epoch in range(steps):
        ws, state, m = step(ws, state, batch)
        losses.append(float(m["loss"]))
        if log_every and (epoch % log_every == 0 or epoch == steps - 1):
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"train-acc {accuracy(data, ws, data['train'], **kw):.3f} "
                  f"test-acc {accuracy(data, ws, data['test'], **kw):.3f}")
    return ws, state, losses


@torch.no_grad()
def serve_trained(data: dict, ws) -> torch.Tensor:
    """The trained weights served through ``Engine.register`` /
    ``infer`` (the graph's partition, padded into its shape class)."""
    engine = Engine(partition_cfg=PartitionConfig(tile=TILE),
                    device=data["device"])
    engine.register(data["name"], data["csr"],
                    part_meta=(data["host_part"], data["meta"]),
                    weights=[w.detach() for w in ws])
    return engine.infer(data["name"], data["x"])


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of Cora's vertices (density kept)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    data = prepare("cora", scale=args.scale, device=args.device)
    print(f"reordered in {data['reorder_s'] * 1e3:.1f} ms;",
          data["meta"].summary())
    ws, _, losses = train(data, init_weights(data), steps=args.steps,
                          log_every=10)
    final = accuracy(data, ws, data["test"])
    print(f"final test accuracy: {final:.3f} "
          f"({time.perf_counter() - t0:.1f} s on {data['device']})")
    logits = gcn_forward(data["part"], data["x"], ws,
                         **forward_kw(data)).detach()
    served = serve_trained(data, ws)
    print("served vs training forward: max |diff| = "
          f"{float((served - logits).abs().max()):.2e}")
    assert final > 0.5, "GCN through the hybrid executor should learn this"
    assert torch.allclose(served, logits, **SERVE_TOL), \
        "the serving view must agree with the training forward"
    return final


if __name__ == "__main__":
    main()
