"""A group member's logits do not depend on the group size.

The GCN forward runs a class group of G stacked graphs with one launch of
each kernel per layer; every kernel takes G as a grid dimension and keeps
its order, and X·W runs as one 2-D product per member
(``hybrid_spmm.member_matmul``), the same call at every G. So member g of a
group of 4 is bitwise-equal to the same graph, features and weights run
alone (G = 1): what lets a request re-dispatched in a smaller group (a
chaos batch-mate rescued by quarantine bisection, or a 1-request
``infer``) keep its bits, as the reference promises ("batch-mates resolve
bitwise-equal", docs/ROBUSTNESS.md).

On the CPU the kernel wrappers run their plain versions, and there a
batched product happens to give the per-member bits too; the ``cuda``
tests run the kernels and cuBLAS, where a batched X·W would not.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.hybrid_spmm import gcn_forward, member_matmul
from repro_torch.engine import Engine
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

DISPATCHES = ("ragged", "fused", "loop")
N, F_IN, HID, F_OUT, G = 256, 24, 16, 5, 4


def _member_inputs(seed=0):
    """G partitions padded into one class, features and weights."""
    rng = np.random.default_rng(seed)
    reg = ClassRegistry()
    parts = []
    for g in range(G):
        csr = tc.csr_from_dense(make_heterogeneous_matrix(N, seed=g))
        part, meta, _ = tc.analyze_and_partition(csr,
                                                 tc.PartitionConfig(tile=64))
        parts.append((part, meta))
    sc = None
    for part, meta in parts:
        sc = reg.classify(part, meta)
    padded = [pad_to_class(p, m, sc) for p, m in parts]
    xs = [rng.standard_normal((sc.n_col_tiles * sc.tile, F_IN))
          .astype(np.float32) for _ in range(G)]
    ws = [[rng.standard_normal((F_IN, HID)).astype(np.float32) * 0.3,
           rng.standard_normal((HID, F_OUT)).astype(np.float32) * 0.3]
          for _ in range(G)]
    return sc, padded, xs, ws


def _stack(padded, xs, ws, dev):
    parts = [tc.partition_to(p, dev) for p, _ in padded]
    part = type(parts[0])(*(type(c)(*(torch.stack(leaves)
                                      for leaves in zip(*comps)))
                            for c, comps in zip(parts[0], zip(*parts))))
    x = torch.stack([torch.from_numpy(a) for a in xs]).to(dev)
    w = [torch.stack([torch.from_numpy(m[i]) for m in ws]).to(dev)
         for i in range(2)]
    return part, x, w


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _group_vs_alone(dev, backend, dispatch, block_cols=0):
    sc, padded, xs, ws = _member_inputs()
    meta = sc.to_meta()
    part, x, w = _stack(padded, xs, ws, dev)
    ys = gcn_forward(part, x, w, meta=meta, backend=backend,
                     ell_dispatch=dispatch, block_cols=block_cols,
                     device=dev)
    assert ys.shape[0] == G
    for g in range(G):
        alone = gcn_forward(tc.partition_to(padded[g][0], dev),
                            torch.from_numpy(xs[g]).to(dev),
                            [torch.from_numpy(m).to(dev) for m in ws[g]],
                            meta=meta, backend=backend,
                            ell_dispatch=dispatch, block_cols=block_cols,
                            device=dev)
        assert _same_bits(ys[g], alone), (backend, dispatch, g)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("backend", ("cuda", "torch"))
def test_group_member_bitwise_equal_to_alone(backend, dispatch):
    _group_vs_alone("cpu", backend, dispatch)


def test_group_member_bitwise_equal_with_column_blocks():
    _group_vs_alone("cpu", "cuda", "ragged", block_cols=8)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_serve_group_bitwise_equal_to_infer(dispatch):
    rng = np.random.default_rng(1)
    eng = Engine(device="cpu", ell_dispatch=dispatch)
    a = make_heterogeneous_matrix(300, seed=5)
    eng.register("g", tc.csr_from_dense(a), weights=[
        rng.standard_normal((F_IN, HID)).astype(np.float32) * 0.3,
        rng.standard_normal((HID, F_OUT)).astype(np.float32) * 0.3])
    xs = [rng.standard_normal((300, F_IN)).astype(np.float32)
          for _ in range(G)]
    for size in (4, 3, 2):
        group = eng.serve_group([("g", x) for x in xs[:size]])
        for y, x in zip(group, xs):
            assert _same_bits(y, eng.infer("g", x))


def test_member_matmul_is_one_2d_product_per_member():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 70, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 9, 4)).astype(np.float32))
    out = member_matmul(x, w)
    for g in range(3):
        assert _same_bits(out[g], torch.matmul(x[g], w[g]))
    shared = member_matmul(x, w[:1])          # one weight for the group
    for g in range(3):
        assert _same_bits(shared[g], torch.matmul(x[g], w[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_group_member_bitwise_equal_to_alone_on_card(dispatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _group_vs_alone("cuda", "cuda", dispatch)
