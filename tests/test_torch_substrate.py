"""The port's copies of the reference's pure-numpy modules equal it
exactly: the ACAP cost model (``core.cost_model``), the neighbor sampler
(``data.sampler``) and the architecture configs (``configs``)."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import repro.configs as jconfigs
import repro.core.cost_model as jcost
import repro.data.sampler as jsampler
import repro_torch.configs as tconfigs
import repro_torch.core.cost_model as tcost
import repro_torch.data.sampler as tsampler
from repro.core.partition import (PartitionConfig as JaxPartitionConfig,
                                  analyze_and_partition as jax_partition)
from repro.data.graphs import make_paper_dataset as jax_dataset
from repro_torch.convert import partition_from_numpy
from repro_torch.core import reorder
from repro_torch.core.partition import PartitionConfig, analyze_and_partition
from repro_torch.data.graphs import make_paper_dataset, random_edge_list


@pytest.mark.parametrize("name,strategy", [("cora", "labels"),
                                           ("citeseer", None),
                                           ("pubmed", "rcm")])
def test_gcn_inference_time_equals_reference(name, strategy):
    csr, _, _, st = make_paper_dataset(name, scale=0.2, seed=0)
    if strategy:
        csr, _, _ = reorder(csr, strategy,
                            labels=make_paper_dataset.last_labels)
    _, meta, _ = analyze_and_partition(csr, PartitionConfig(tile=64))
    for hidden, x_density in ((128, 0.05), (16, 1.0)):
        got = tcost.gcn_inference_time(meta, st.n_features, hidden,
                                       st.n_classes, x_density)
        want = jcost.gcn_inference_time(meta, st.n_features, hidden,
                                        st.n_classes, x_density)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.pipelined, got.unpipelined) == (want.pipelined,
                                                    want.unpipelined)


def test_engine_models_equal_reference():
    for size in (16, 32, 64):
        for density in (0.02, 0.1, 0.35):
            pd = tcost.typical_padding_density(int(density * 100), size)
            assert pd == jcost.typical_padding_density(int(density * 100),
                                                       size)
            assert tcost.grouping_speedup(size, density, pd) == \
                jcost.grouping_speedup(size, density, pd)
            assert tcost.sparse_tile_time(1e5, density, pd, size=size) == \
                jcost.sparse_tile_time(1e5, density, pd, size=size)
    assert tcost.pl_spmm_time(1234, 64) == jcost.pl_spmm_time(1234, 64)
    assert tcost.dense_gemm_time(64, 64, 32, 200) == \
        jcost.dense_gemm_time(64, 64, 32, 200)


def test_partition_meta_of_the_reference_prices_the_same():
    """A reference partition carried into the port prices identically."""
    csr, _, _, st = jax_dataset("cora", scale=0.2, seed=0)
    part, meta, _ = jax_partition(csr, JaxPartitionConfig(tile=64))
    _, tmeta = partition_from_numpy(part, meta)
    assert dataclasses.asdict(
        tcost.gcn_inference_time(tmeta, st.n_features, 128, 7)) == \
        dataclasses.asdict(jcost.gcn_inference_time(meta, st.n_features,
                                                    128, 7))


@pytest.mark.parametrize("batch,fanout,seed", [(8, (3, 2), 0),
                                               (16, (5,), 1),
                                               (4, (4, 3, 2), 2)])
def test_sampler_equals_reference(batch, fanout, seed):
    assert tsampler.max_sizes(batch, fanout) == jsampler.max_sizes(batch,
                                                                   fanout)
    s, r = random_edge_list(200, 1600, seed=seed)
    adj = sp.coo_matrix((np.ones(len(s)), (r, s)), shape=(200, 200)).tocsr()
    ts = tsampler.NeighborSampler(adj, batch, fanout, seed=seed)
    js = jsampler.NeighborSampler(adj, batch, fanout, seed=seed)
    for _ in range(3):
        a, b = ts.sample(), js.sample()
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    seeds = np.arange(batch)
    np.testing.assert_array_equal(ts.sample(seeds).senders,
                                  js.sample(seeds).senders)


def test_configs_equal_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    for name in tconfigs.ARCHS:
        a, b = tconfigs.get_arch(name), jconfigs.get_arch(name)
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
        assert dataclasses.asdict(a.smoke) == dataclasses.asdict(b.smoke)
        assert [dataclasses.asdict(c) for c in a.shapes] == \
            [dataclasses.asdict(c) for c in b.shapes]
        assert a.family == b.family
    assert [(a.name, c.name) for a, c in tconfigs.all_cells(True)] == \
        [(a.name, c.name) for a, c in jconfigs.all_cells(True)]
    with pytest.raises(KeyError):
        tconfigs.get_arch("nope")
