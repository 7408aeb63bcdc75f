"""The paper's GCN (H-GCN §V-A): ``config["model"]["kind"] == "gcn"``.

``logits = A_tilde · relu(A_tilde · X · W1) · W2`` for two layers; the
configuration gives ``n_layers`` and ``d_hidden``, its graph block
``n_features`` and ``n_classes``. The program serves it through
``Engine.register(..., weights=<list>)``; the plain reference is
``reference.Reference``.
"""
from __future__ import annotations

import math

from hgcn_bench import traffic as traffic_mod, yardstick
from hgcn_bench.reference import Reference


def glorot(torch, gen, fan_in: int, fan_out: int, device):
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_in, fan_out), generator=gen, device=device,
                   dtype=torch.float32)
    return u * (2.0 * lim) - lim


def make_inputs(torch, config: dict, traffic: dict, seed: int, n: int,
                device) -> tuple:
    """The weights (glorot, [F_in, H], ..., [H, C]) and the feature pool
    (Bernoulli), made on the device from the seed in a few large calls,
    float32: the weights first, then the pool, from one generator."""
    graph, model = config["graph"], config["model"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f_in = int(graph["n_features"])
    dims = [f_in] + [int(model["d_hidden"])] * (int(model["n_layers"]) - 1) \
        + [int(graph["n_classes"])]
    weights = [glorot(torch, gen, a, b, device)
               for a, b in zip(dims[:-1], dims[1:])]
    return weights, traffic_mod.feature_pool(torch, gen, traffic, n, f_in,
                                             device)


def register(engine, name: str, csr, graph: dict, labels, weights):
    """``Engine.register`` with the graph block's reorder and the GCN's
    weight list, which enables ``infer`` and the queue."""
    return engine.register(name, csr, reorder=graph["reorder"],
                           labels=labels, weights=weights)


def reference(csr, device, precision: str = "float64") -> Reference:
    return Reference(csr, device, precision)


def request_flops(config: dict, n: int, nnz: int) -> float:
    """``yardstick.gcn_request_flops`` at the configuration's widths (a
    2-layer GCN)."""
    graph, model = config["graph"], config["model"]
    return yardstick.gcn_request_flops(n, nnz, int(graph["n_features"]),
                                       int(model["d_hidden"]),
                                       int(graph["n_classes"]))


def layer1_operands(engine, name: str, handle, x) -> tuple:
    """Layer 1's X·W operands as the executor gets them: ``x`` permuted
    and padded to the class's rows, [1, rows, F], and the registered W1,
    [1, F, H]. Calls the class's ``prepare_x``, not the instance's, which
    a traced run's probe wraps."""
    from repro_torch.engine import Engine

    return Engine.prepare_x(engine, name, x)[None], handle.weights[0][None]
