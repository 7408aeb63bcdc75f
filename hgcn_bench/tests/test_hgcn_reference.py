"""The plain reference against a dense float64 product, the TF32
rounding, and the control: the reference in TF32 fails the limit that
the program's float32 output meets."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hgcn_bench import graphgen, spec
from hgcn_bench.reference import Reference, logit_err, round_tf32


def _graph(n=400, seed=3):
    a, _ = graphgen.sbm_graph(n, 8 * n, seed=seed, return_labels=True)
    return graphgen.normalized_adjacency(a)


def _inputs(n, f, h, c, seed=5):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.05).astype(np.float32)
    w1 = rng.uniform(-0.1, 0.1, (f, h)).astype(np.float32)
    w2 = rng.uniform(-0.2, 0.2, (h, c)).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, w1, w2)]


def test_reference_matches_a_dense_float64_product():
    atil = _graph()
    x, w1, w2 = _inputs(atil.shape[0], 48, 16, 5)
    a = torch.from_numpy(atil.toarray().astype(np.float64))
    hid = torch.relu(a @ (x.double() @ w1.double()))
    want = a @ (hid @ w2.double())
    got = Reference(atil, "cpu").logits(x, [w1, w2])
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("value,expect", [
    (1.0, 1.0), (1.0 + 2 ** -11, 1.0), (1.0 + 3 * 2 ** -11, 1.0 + 2 ** -9),
    (1.0 + 2 ** -10, 1.0 + 2 ** -10), (-1.0 - 3 * 2 ** -11, -1.0 - 2 ** -9),
    (1.0 + 2 ** -11 + 2 ** -20, 1.0 + 2 ** -10), (0.0, 0.0)])
def test_round_tf32_keeps_ten_mantissa_bits_nearest_even(value, expect):
    got = float(round_tf32(torch.tensor([value], dtype=torch.float32))[0])
    assert got == expect


def test_round_tf32_passes_non_finite_values():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    y = round_tf32(x)
    assert torch.isinf(y[:2]).all() and torch.isnan(y[2])


def test_logit_err_reads_gaps_against_the_largest_logit():
    want = torch.tensor([[2.0, -4.0], [1.0, 0.5]], dtype=torch.float64)
    got = want.float().clone()
    got[1, 1] += 0.004
    assert logit_err(got, want) == pytest.approx(0.001, rel=1e-5)
    got[0, 0] = float("nan")
    assert logit_err(got, want) == float("inf")
    assert logit_err(got[:1], want) == float("inf")


def _limit(config: str) -> float:
    with open(spec.ROOT / "hgcn_bench" / "configs" / f"{config}.json") as f:
        return json.load(f)["limits"]["logit_err"]


@pytest.mark.parametrize("config", ["gcn-reddit", "gcn-flickr"])
def test_the_control_fails_the_limit_and_the_program_meets_it(config):
    """The control (the reference in TF32) at the configuration's
    widths on a small graph reads above the limit; the program's
    float32 forward on the same inputs reads below it."""
    from repro_torch.core.formats import csr_from_scipy
    from repro_torch.engine import Engine

    with open(spec.ROOT / "hgcn_bench" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    g = dict(cfg["graph"], n_vertices=1500, density=0.004)
    atil, labels = graphgen.generate(g)
    x, w1, w2 = _inputs(atil.shape[0], g["n_features"],
                        cfg["model"]["d_hidden"], g["n_classes"])
    want = Reference(atil, "cpu").logits(x, [w1, w2])
    control = Reference(atil, "cpu", "tf32").logits(x, [w1, w2])
    eng = Engine(device="cpu")
    eng.register("g", csr_from_scipy(atil), reorder="labels", labels=labels,
                 weights=[w1, w2])
    got = eng.infer("g", x)
    limit = _limit(config)
    assert logit_err(got, want) < limit / 3
    assert logit_err(control, want) > 3 * limit
