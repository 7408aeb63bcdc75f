"""The bfloat16 ``tile_matmul`` instances (``csrc/wgmma_tile.cuh``) on the
CPU: their launch contracts and their plain version.

The card runs the wgmma instances (``tests/test_torch_bf16_kernels.py``
holds them to the plain version there). Here:

  * the contract at the three graphs' layer-1 shapes fills a 132-SM card
    (at least 128 blocks), within 227 KB of shared memory a block and a
    cluster of at most 8;
  * K's split points depend on K alone: every configuration, M, N and B
    alignment splits at the same points (the bits across configurations
    rest on it), on 64-element chunk boundaries, and the Python mirror's
    constants are the source's;
  * ``kernel_pass.check_contract`` finds every bfloat16 configuration
    legal, with B's rows aligned and staged;
  * the plain version, which a CPU tensor takes, against the Pallas
    kernel (``interpret=True``) at K = 1, 3, 5 and 7 (mod 8), N = 3, 6, 7
    and 130, with A, B and C views 0, 1, 3 and 7 elements into larger
    buffers, to the bfloat16 bound (``ref.bf16_tolerance``).
"""
import functools
import importlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.tile_matmul import tile_matmul as jax_matmul
from repro_torch.analysis.static.kernel_pass import (CLUSTER_MAX,
                                                     SMEM_PER_BLOCK,
                                                     check_contract)
from repro_torch.kernels import _build

from test_torch_bf16 import assert_bf16_close, as_f64
from test_torch_static import _errors, _log_for

torch.set_num_threads(2)

# the module (``repro_torch.kernels.tile_matmul`` is also its function)
tm = importlib.import_module("repro_torch.kernels.tile_matmul")
BF16 = torch.bfloat16
H100_SMS = 132
LAYER1 = {"cora": (4096, 1433, 128), "citeseer": (4096, 3703, 128),
          "pubmed": (32768, 500, 128)}
LAYER2 = {"cora": (4096, 128, 7), "citeseer": (4096, 128, 6),
          "pubmed": (32768, 128, 3)}


@pytest.mark.parametrize("graph", sorted(LAYER1))
def test_bf16_contract_fills_the_card(graph):
    c = tm.matmul_contract(*LAYER1[graph], dtype=BF16, n_sms=H100_SMS)
    assert c["kernel"] == "wgmma_matmul_kernel"
    assert int(np.prod(c["grid"])) >= 128
    assert c["dyn_smem"] + c["static_smem"] <= SMEM_PER_BLOCK == 227 * 1024
    assert int(np.prod(c["cluster"])) <= CLUSTER_MAX == 8
    assert c["grid"][2] == c["cluster"][2]      # one cluster a block's splits


@pytest.mark.parametrize("k", [0, 1, 8, 64, 500, 863, 864, 1433, 3703,
                               4099, 20000])
def test_bf16_split_points_depend_on_k_alone(k):
    per, splits = tm.wg_split_k(k), tm.wg_splits(k)
    contracts = [tm.matmul_contract(m, k, n, config=c, dtype=BF16,
                                    b_aligned=al)
                 for c in tm.CONFIGS for m, n in ((64, 8), (4096, 128),
                                                   (257, 130))
                 for al in (True, False)]
    assert {c["split_k"] for c in contracts} == {per if k else 1}
    assert {c["grid"][2] for c in contracts} == {splits}
    assert {c["cluster"] for c in contracts} == {(1, 1, splits)}
    assert 1 <= splits <= tm.WG_MAX_SPLITS
    if k:
        # split points on the ring's 64-element chunks (and so on the k16
        # grid), the last split holding what is left
        assert per % 64 == 0 and (splits - 1) * per < k <= splits * per


def test_bf16_mirror_is_the_source():
    src = (_build.CSRC_DIR / "tile_matmul.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kWg\w+) = (\d+);", src))
    assert (int(consts["kWgSplitK"]), int(consts["kWgSplitAlign"]),
            int(consts["kWgMaxSplits"])) == (
        tm.WG_SPLIT_K, tm.WG_SPLIT_ALIGN, tm.WG_MAX_SPLITS)
    tiles = dict(re.findall(r"using Wg(\w+) = wgmma_tile::Tile<([\d, ]+)>;",
                            src))
    assert {name.lower(): tuple(int(v) for v in t.split(","))
            for name, t in tiles.items()} == tm.WG_TILES
    for case, config in (("0", "wide"), ("1", "fill"), ("2", "narrow")):
        assert re.search(rf"case {case}: return launch_wgmma<Wg"
                         rf"{config.capitalize()}>", src)


@pytest.mark.parametrize("config", tm.CONFIGS)
@pytest.mark.parametrize("b_aligned", [True, False])
@pytest.mark.parametrize("shape", [*LAYER1.values(), *LAYER2.values(),
                                   (257, 129, 65), (1, 8, 3), (4099, 3703,
                                                               136)])
def test_bf16_contracts_legal(config, b_aligned, shape):
    c = tm.matmul_contract(*shape, config=config, dtype=BF16,
                           b_aligned=b_aligned)
    m, k, n = shape
    assert c["tma"] == (config != "narrow" and b_aligned and n % 8 == 0
                        and n >= 64 and k >= 64)
    assert c["ptxas_name"].endswith(f"Lb{int(c['tma'])}E")
    assert _errors(check_contract(c, ptxas_log=_log_for(c, 0))) == []
    # a spill of the instance is refused
    assert _errors(check_contract(c, ptxas_log=_log_for(c, 8)))


@functools.lru_cache(maxsize=None)
def _pallas(m, k, n):
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    return a, b, jax_matmul(ja, jb, bm=128, bn=128, bk=128, interpret=True)


def _view(x: np.ndarray, off: int):
    buf = torch.zeros(x.size + off + 8, dtype=BF16)
    view = buf[off:off + x.size].view(x.shape)
    return view.copy_(torch.from_numpy(x).to(BF16))


@pytest.mark.parametrize("m,k,n", [(70, 33, 5), (65, 131, 7), (130, 133, 6),
                                   (33, 135, 3), (129, 257, 130)])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 7), (7, 1, 3)])
def test_plain_bf16_views_match_pallas(m, k, n, off):
    a, b, want = _pallas(m, k, n)
    pa, pb = _view(a, off[0]), _view(b, off[1])
    out = _view(np.zeros((m, n), np.float32), off[2])
    got = tm.tile_matmul(pa, pb, out=out, device="cpu")
    assert got is out and got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_bf16_close(got, want, np.abs(as_f64(pa)) @ np.abs(as_f64(pb)))


def test_out_is_checked():
    a, b = torch.ones(4, 3, dtype=BF16), torch.ones(3, 2, dtype=BF16)
    with pytest.raises(ValueError, match="out must be"):
        tm.tile_matmul(a, b, out=torch.empty(4, 3, dtype=BF16), device="cpu")
    with pytest.raises(ValueError, match="out must be"):
        tm.tile_matmul(a, b, out=torch.empty(4, 2), device="cpu")
