"""Demo: what the tri-partition does to a heterogeneous graph, engine by
engine — reorder ablation, per-engine nnz split, cost-model times, and
plain-vs-kernel backend agreement (port of ``examples/hybrid_spmm_demo.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.hybrid_spmm_demo
      (``--device cpu``: both backends run the plain versions)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bandwidth, reorder
from repro_torch.core.cost_model import gcn_inference_time
from repro_torch.core.hybrid_spmm import hybrid_spmm
from repro_torch.core.partition import PartitionConfig, analyze_and_partition
from repro_torch.data.graphs import make_paper_dataset


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    csr, x, y, st = make_paper_dataset("cora", scale=args.scale)
    labels = make_paper_dataset.last_labels

    print("=== reordering ablation (paper §IV-B / Fig. 4) ===")
    for strat in ("identity", "degree", "rcm", "community", "labels"):
        kw = {"labels": labels} if strat == "labels" else {}
        csr2, _, dt = reorder(csr, strat, **kw)
        part, meta, _ = analyze_and_partition(csr2, PartitionConfig(tile=64))
        t = gcn_inference_time(meta, st.n_features, 128, st.n_classes, 0.05)
        tot = meta.nnz
        print(f"{strat:9s} bw={bandwidth(csr2):6d} "
              f"dense={meta.nnz_dense / tot:6.1%} "
              f"ell={meta.nnz_ell / tot:6.1%} coo={meta.nnz_coo / tot:6.1%} "
              f"modeled T={t.pipelined * 1e3:6.2f} ms "
              f"({dt * 1e3:5.1f} ms to reorder)")

    print("\n=== backend agreement (torch vs cuda kernels) ===")
    csr2, _, _ = reorder(csr, "labels", labels=labels)
    part, meta, _ = analyze_and_partition(csr2, PartitionConfig(tile=64))
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((meta.n_rows, 64)).astype(
        np.float32))
    y_t = hybrid_spmm(part, b, meta=meta, backend="torch", device=args.device)
    y_k = hybrid_spmm(part, b, meta=meta, backend="cuda", device=args.device)
    err = float((y_t - y_k).abs().max())
    print(f"max |torch - cuda| = {err:.2e} on {y_k.device}")
    assert err < 1e-4
    print(meta.summary())
    return err


if __name__ == "__main__":
    main()
