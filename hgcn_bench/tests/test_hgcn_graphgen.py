"""The frozen generator gives the program's ``make_paper_dataset`` CSR
and communities, and its cache returns what it stored."""
import numpy as np
import pytest

from hgcn_bench import graphgen
from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset


@pytest.mark.parametrize("name,scale", [("flickr", 0.02), ("reddit", 0.01),
                                        ("pubmed", 0.1)])
def test_frozen_generator_reproduces_make_paper_dataset(name, scale):
    csr, _, _, st = make_paper_dataset(name, scale=scale, seed=0)
    labels = make_paper_dataset.last_labels
    n = max(int(st.n_vertices * scale), 64)
    g = {"n_vertices": n, "density": PAPER_DATASETS[name].density,
         "graph_seed": 0}
    atil, comm = graphgen.generate(g)
    assert atil.shape == tuple(csr.shape)
    np.testing.assert_array_equal(atil.indptr, csr.indptr)
    np.testing.assert_array_equal(atil.indices, csr.indices)
    np.testing.assert_array_equal(atil.data, csr.data)
    np.testing.assert_array_equal(comm, labels)


def test_cache_round_trip(tmp_path):
    g = {"n_vertices": 300, "density": 0.01, "graph_seed": 4}
    a1, l1, cached1 = graphgen.load_graph("t", g, tmp_path)
    a2, l2, cached2 = graphgen.load_graph("t", g, tmp_path)
    assert (cached1, cached2) == (False, True)
    assert (a1 != a2).nnz == 0 and np.array_equal(l1, l2)
    other = dict(g, graph_seed=5)
    assert graphgen.graph_key(other) != graphgen.graph_key(g)
    assert len(list(tmp_path.iterdir())) == 1


@pytest.mark.parametrize("n,density", [(2000, 0.02), (1500, 0.05)])
def test_fill_reaches_density_and_keeps_the_programs_draws(n, density):
    g = {"n_vertices": n, "density": density, "graph_seed": 3}
    base, comm0 = graphgen.generate(g)
    filled, comm = graphgen.generate(dict(g, fill=True))
    target = int(density * n * n)
    target -= target % 2
    assert base.nnz - n < target        # the plain draws fall short
    assert filled.nnz - n == target     # A, without the self loops
    assert (filled != filled.T).nnz == 0
    assert filled.diagonal().min() > 0
    np.testing.assert_array_equal(comm, comm0)
    on_base = (base != 0).astype(np.int8)
    assert (on_base - on_base.multiply(filled != 0)).nnz == 0
    again, _ = graphgen.generate(dict(g, fill=True))
    assert (again != filled).nnz == 0


def test_configs_state_the_nonzeros_their_graph_block_gives():
    """Each configuration's ``expected`` counts: A_tilde is A with the
    self loops, and a filled graph's A is density * n^2 (even); a graph
    of the plain draws has fewer, and lists ``density`` as cut."""
    import json
    bench = json.loads((graphgen.CACHE_DIR.parents[2] / "BENCHMARK.json")
                       .read_text())
    reduced = {c["name"]: c["reduced"] for c in bench["configs"]}
    for path in sorted((graphgen.CACHE_DIR.parents[1] / "configs")
                       .glob("*.json")):
        cfg = json.loads(path.read_text())
        g, exp = cfg["graph"], cfg["expected"]
        n = g["n_vertices"]
        want = max(int(g["density"] * n * n), 4 * n)
        want -= want % 2
        assert exp["nnz_a_tilde"] == exp["nnz_a"] + n
        if g["fill"]:
            assert exp["nnz_a"] == want
        else:
            assert exp["nnz_a"] < want
            assert "density" in reduced[cfg["name"]]
