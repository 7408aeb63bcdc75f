"""The port's roofline and collective summary against the reference's
pure functions (``repro.analysis.roofline``, ``repro.analysis.hlo``).

``Roofline`` given the reference's TPU constants and the same fields has
the reference's ``to_dict()``; ``merge_cost_analysis`` (the four cases
of ``tests/test_roofline.py``), ``fmt_seconds`` and ``save_json`` agree;
and the collectives that ``OpCounter`` records on a fake process group
of 8 ranks summarize (``collective_summary``) exactly as the reference
summarizes an HLO text written for the same ops: all five kinds, a
tuple all-reduce, an async all-reduce (``-start``/``-done``) and a
point-to-point exchange (a send and a receive: one collective-permute).
"""
import json

import pytest
import torch

from repro_torch.analysis import op_trace
from repro_torch.analysis import roofline as troof

FIELDS = {
    "compute": dict(hlo_flops=4e15, hlo_bytes=1e9, collective_bytes=1e6,
                    model_flops=3e17),
    "memory": dict(hlo_flops=1e9, hlo_bytes=5e12, collective_bytes=1e6,
                   model_flops=2e11),
    "collective": dict(hlo_flops=1e9, hlo_bytes=1e9, collective_bytes=9e11,
                       model_flops=1e11),
    "empty": dict(hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=0.0,
                  model_flops=0.0),
}


@pytest.mark.parametrize("case", list(FIELDS))
def test_roofline_with_the_reference_constants_is_the_reference(case):
    from repro.analysis import roofline as jroof

    kw = dict(arch="a", cell="c", mesh="16x16", chips=256,
              per_device_memory=3e9,
              collectives={"by_kind": {}, "n_ops": 0}, **FIELDS[case])
    want = jroof.Roofline(**kw).to_dict()
    got = troof.Roofline(**kw, peak_flops=jroof.PEAK_FLOPS,
                         hbm_bw=jroof.HBM_BW, nvlink_bw=jroof.ICI_BW,
                         ib_bw=jroof.ICI_BW).to_dict()
    assert got == want


def test_h100_peaks_are_the_defaults():
    """Data-sheet figures (H100 SXM, 700 W); the two that
    ``Engine.latency_prior`` reads keep their names and values."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW) == (67e12, 3.35e12)
    r = troof.Roofline("a", "c", "1x1", 1, 989e12, 3.35e12, 0.0, 0.0, 0.0,
                       {})
    assert (r.peak_flops, r.hbm_bw, r.nvlink_bw, r.ib_bw) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)


CA_DICT = {"flops": 1024.0, "bytes accessed": 768.0, "utilization0{}": 1.0}
MERGES = {
    "dict_passthrough": (CA_DICT, CA_DICT),
    "single_element_list": ([dict(CA_DICT)], CA_DICT),
    "multi_sums_numeric": ([{"flops": 10.0, "bytes accessed": 5.0},
                            {"flops": 3.0, "tag": "x"}],
                           {"flops": 13.0, "bytes accessed": 5.0,
                            "tag": "x"}),
    "degenerate_none": (None, {}),
    "degenerate_empty": ([], {}),
    "degenerate_empty_entries": ([None, {}], {}),
}


@pytest.mark.parametrize("case", list(MERGES))
def test_merge_cost_analysis(case):
    from repro.analysis.roofline import merge_cost_analysis

    ca, want = MERGES[case]
    assert troof.merge_cost_analysis(ca) == want
    assert troof.merge_cost_analysis(ca) == merge_cost_analysis(ca)


@pytest.mark.parametrize("t", [0.0, 3e-7, 4.2e-5, 1e-3, 0.0567, 1.0,
                               12.345])
def test_fmt_seconds(t):
    from repro.analysis.roofline import fmt_seconds

    assert troof.fmt_seconds(t) == fmt_seconds(t)


def test_save_json(tmp_path):
    from repro.analysis import roofline as jroof

    kw = dict(arch="a", cell="c", mesh="4x2", chips=8,
              per_device_memory=1.0, collectives={}, **FIELDS["memory"])
    recs = [{"arch": "x", "status": "skip"}]
    troof.save_json(recs + [troof.Roofline(**kw, peak_flops=jroof.PEAK_FLOPS,
                                           hbm_bw=jroof.HBM_BW,
                                           nvlink_bw=jroof.ICI_BW,
                                           ib_bw=jroof.ICI_BW)],
                    tmp_path / "port.json")
    jroof.save_json(recs + [jroof.Roofline(**kw)], tmp_path / "ref.json")
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())


def test_links_and_compute_peak():
    """A group within one node of 8 (row-major ranks) crosses NVLink,
    one across nodes InfiniBand; the compute peak follows the dtype of
    the products."""
    assert troof.link_of((0, 1, 2, 7)) == "nvlink"
    assert troof.link_of((8, 15)) == "nvlink"
    assert troof.link_of((7, 8)) == "ib"
    assert troof.link_of((0, 16, 32)) == "ib"
    assert troof.compute_peak({"bfloat16": 10, "float32": 5})[0] == 989e12
    assert troof.compute_peak({"float32": 5})[0] == 67e12
    assert troof.compute_peak({})[0] == 67e12
    r = troof.Roofline("a", "c", "m", 16, 0.0, 0.0, 0.0, 0.0, 0.0,
                       {"by_link": {"nvlink": 450e9, "ib": 50e9}})
    assert r.t_collective == pytest.approx(2.0)


# each case: (the ops run on a fake group of 8 ranks, the same ops as the
# HLO text of an 8-device program)
HLO = {
    "all_reduce": "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "tuple_all_reduce": "%tar = (f32[16,8]{1,0}, f32[4]{0}) all-reduce("
                        "f32[16,8]{1,0} %a, f32[4]{0} %b), to_apply=%add",
    "async_all_reduce": "%ars = f32[256]{0} all-reduce-start(f32[256]{0} "
                        "%y), to_apply=%add\n  %ard = f32[256]{0} "
                        "all-reduce-done(f32[256]{0} %ars)",
    "all_gather": "%ag = bf16[64,32]{1,0} all-gather(bf16[8,32]{1,0} %x), "
                  "dimensions={0}",
    "reduce_scatter": "%rs = f32[4,32]{1,0} reduce-scatter(f32[32,32]{1,0} "
                      "%x), dimensions={0}, to_apply=%add",
    "all_to_all": "%a2a = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %x), "
                  "dimensions={0}",
    "permute": "%cp = f32[128]{0} collective-permute(f32[128]{0} %x), "
               "source_target_pairs={{0,1}}",
}


def _run(case):
    import torch.distributed as dist

    g4 = dist.new_group([0, 1, 2, 3])
    if case == "all_reduce":
        dist.all_reduce(torch.ones(1024), group=g4)
    elif case == "tuple_all_reduce":
        dist.all_reduce_coalesced([torch.ones(16, 8), torch.ones(4)])
    elif case == "async_all_reduce":
        dist.all_reduce(torch.ones(256), async_op=True).wait()
    elif case == "all_gather":
        dist.all_gather_into_tensor(torch.empty(64, 32, dtype=torch.bfloat16),
                                    torch.ones(8, 32, dtype=torch.bfloat16))
    elif case == "reduce_scatter":
        dist.reduce_scatter_tensor(torch.empty(4, 32), torch.ones(32, 32))
    elif case == "all_to_all":
        dist.all_to_all_single(torch.empty(8, 16), torch.ones(8, 16))
    else:
        ops = [dist.P2POp(dist.isend, torch.ones(128), 1),
               dist.P2POp(dist.irecv, torch.empty(128), 7)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()


@pytest.fixture(scope="module")
def fake8():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cases", [[c] for c in HLO] + [list(HLO)],
                         ids=list(HLO) + ["all"])
def test_collective_summary_equals_the_reference(cases, fake8):
    from repro.analysis.hlo import collective_summary

    counter = op_trace.OpCounter()
    with counter:
        for case in cases:
            _run(case)
    text = "\n".join("  " + HLO[c] for c in cases)
    assert op_trace.collective_summary(counter.records) == \
        collective_summary(text)
