"""Kernel pass — the Hopper launch-contract audit (the legality oracle).

Port of ``repro.analysis.static.kernel_pass``. The reference audits
Pallas launch contracts against a TPU core's VMEM; the port's kernels
are CUDA C++ for sm_90a, so the contract is a CUDA launch's: the dicts
``repro_torch.kernels`` launches from (``ragged_ell_contract``,
``ell_contract``, ``coo_rows_contract``, ``matmul_contract``), audited
WITHOUT launching anything:

- **grid**: every dimension >= 1, ``grid.x`` < 2^31, ``grid.y`` and
  ``grid.z`` <= 65535 (the ELL kernels put the group G on ``grid.y``);
  a cluster divides the grid and holds at most 8 blocks.
- **threads**: at most 1024 per block, a multiple of the lanes per row
  ``w`` (32, a warp, for kernels without lanes per row); ``kc <= w``
  (a chunk's cols/vals are spread over the row's lanes).
- **instance**: the launch shape is one of the kernel instances the
  source is built with (a candidate outside them would fail to launch);
  the ELL and COO kernels' instances end with their (vals, B) types, and
  the pass audits every pair (float32 or bfloat16 each) and both matmul
  types, so the bfloat16 instances' registers and spills are read too.
- **index-extent**: what the kernel numbers in 32 bits (entries, units,
  plan positions, M/N/K) stays below 2^31.
- **shared-memory**: dynamic plus static shared memory at most 227 KiB
  per block, and above 48 KiB only with the opt-in attribute set.
- **vec-align**: 16-byte rows (``vec`` 4) only where F % 4 == 0 and
  both pointers are 16-byte aligned.
- **index-bounds**: worst-case stand-ins of the index operands
  (``tile_col < nct``, ``cols < T``, ``unit_k <= Kmax``, ``bucket_k <=
  Kmax``) lie in range.
- **bands**: the ELL kernels' band table (the ragged kernel's K bands,
  the fixed-K kernel's buckets): Ks strictly descending, each in
  [0, Kmax], the units' counts summing to U; the ragged kernel's
  ``max_bands`` at least 1, at most ``VALUE_BANDS`` bands by value
  (``ell_rows_kernel``), and a plan of more as a [U] table
  (``ell_rows_table_kernel``, ``band_k`` of length U).
- **registers**: where the build's ``-Xptxas -v`` log holds the
  instance, its registers times the block's threads must fit the SM's
  64 K registers, and it must not spill: any spill store or spill load
  rejects the instance. (The ELL kernels declare a minimum of one block
  per SM so that ptxas does not spill to reach an occupancy step:
  ``csrc/ell_rows.cuh``.) Without a log (the CPU, nothing built) the
  rule reports "not checked" as a warning.
- **class-fit / mac-amortization**: an independent restatement of the
  shape-class waste bound (``repro_torch.engine.shape_class
  .class_fits``), unchanged from the reference.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.static.report import Finding
from repro_torch.engine.shape_class import (ClassNeed, ShapeClass,
                                           ShapePolicy, class_fits)
from repro_torch.kernels import _build
from repro_torch.kernels.bands import VALUE_BANDS, band_mode, unit_bounds
from repro_torch.kernels import gat_coef
from repro_torch.kernels.coo_spmm import SHAPES as COO_SHAPES
from repro_torch.kernels.coo_spmm import (coo_rows_contract,
                                          coo_rows_heads_contract)
from repro_torch.kernels.ell_spmm import (INDEX_LIMIT, TUNE_KC, TUNE_THREADS,
                                          TUNE_VEC, TUNE_W, ell_contract,
                                          ragged_ell_contract,
                                          ragged_ell_heads_contract)
from repro_torch.kernels.tile_matmul import (CONFIGS, TILES, WG_TILES,
                                             matmul_contract)

# sm_90 per-block limits (NVIDIA's Hopper tuning guide).
MAX_THREADS = 1024
SMEM_PER_BLOCK = 227 * 1024    # dynamic + static, with the opt-in
SMEM_NO_OPTIN = 48 * 1024      # without cudaFuncAttributeMaxDynamic...
REGISTERS_PER_SM = 64 * 1024
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
CLUSTER_MAX = 8                # portable thread-block cluster size
# A width that is not a multiple of 4 (cora's class count), audited so
# that a tuned vec = 4 is seen clamped to 1.
CLAMP_F = 7

# The (vals, B) type pairs the ELL kernels are built for, and the
# operand types of the dense matmul.
ELL_DTYPES = tuple(itertools.product(("float32", "bfloat16"), repeat=2))
MATMUL_DTYPES = (torch.float32, torch.bfloat16)

# The kernel instances each source is built with (the ELL kernels' launch
# shapes followed by their (vals, B) type names; the multi-head instances'
# default shapes followed by the head count).
_RAGGED_BUILT = {shape + types for shape in itertools.product(
    TUNE_W, TUNE_VEC, TUNE_KC, TUNE_THREADS) for types in ELL_DTYPES}
_HEADS_BUILT = {(w, vec, h) for w, vec in ((8, 1), (16, 1), (32, 1), (32, 4))
                for h in _build.HEADS}
# The multi-head widths audited for each head count: a head of 256
# features (16-byte rows) and one of 41 (one element a lane), the
# served GAT's two.
HEAD_WIDTHS = (256, 41)
BUILT = {
    "ell_rows_kernel": _RAGGED_BUILT,
    "ell_rows_table_kernel": _RAGGED_BUILT,
    "ell_band_kernel": {shape + types for shape in itertools.product(
        TUNE_W, TUNE_VEC) for types in ELL_DTYPES},
    "coo_rows_kernel": {shape + types for shape in COO_SHAPES
                        for types in ELL_DTYPES},
    "ell_rows_heads_kernel": _HEADS_BUILT,
    "ell_rows_heads_table_kernel": _HEADS_BUILT,
    "coo_rows_heads_kernel": {shape + (h,) for shape in COO_SHAPES
                              for h in _build.HEADS},
    "gat_row_stats_kernel": {(h,) for h in _build.HEADS},
    "gat_edge_coef_kernel": {(h,) for h in _build.HEADS},
    "matmul_kernel": set(TILES.values()),
    "wgmma_matmul_kernel": set(WG_TILES.values()),
}


def _log_of(source: str) -> str:
    return _build.BUILD_LOG.get(source, {}).get("log", "")


def check_contract(contract: dict, *, scalar_args: Sequence = (),
                   ptxas_log: Optional[str] = None) -> List[Finding]:
    """All checks for one launch contract (errors mean illegal).

    ``scalar_args`` are worst-case stand-ins for the index operands
    named in ``contract["index_bounds"]``, in that order. ``ptxas_log``
    is the source's ``-Xptxas -v`` output; None reads the last build's
    (``repro_torch.kernels._build.BUILD_LOG``).
    """
    name = contract["name"]
    grid = tuple(contract["grid"])
    threads = contract["threads"]
    w = contract.get("w", 32)
    findings: List[Finding] = []

    def err(rule: str, msg: str, severity: str = "error") -> None:
        findings.append(Finding("kernel", rule, severity, name, msg))

    if any(g < 1 for g in grid):
        err("grid", f"grid {grid} has a non-positive dimension")
        return findings
    if grid[0] > GRID_X_MAX or any(g > GRID_YZ_MAX for g in grid[1:]):
        err("grid", f"grid {grid} exceeds sm_90's limits (x < 2^31, "
            f"y and z <= {GRID_YZ_MAX}; the group G is grid.y)")
    cluster = tuple(contract.get("cluster", (1, 1, 1)))
    if int(np.prod(cluster)) > CLUSTER_MAX or any(
            g % c for g, c in zip(grid, cluster)):
        err("grid", f"cluster {cluster} over grid {grid}: at most "
            f"{CLUSTER_MAX} blocks, dividing every grid dimension")
    if not 1 <= threads <= MAX_THREADS or threads % w:
        err("threads", f"{threads} threads per block: want 1..{MAX_THREADS}"
            f" and a multiple of the {w} lanes per row")
    if "kc" in contract and contract["kc"] > w:
        err("chunk", f"kc={contract['kc']} > w={w}: a chunk's cols/vals "
            "are spread over the row's lanes (static_assert KC <= W)")
    built = BUILT.get(contract["kernel"])
    if built is not None and tuple(contract["instance"]) not in built:
        err("instance", f"{contract['kernel']} instance "
            f"{tuple(contract['instance'])} is not built from "
            f"{contract['source']}.cu")
    for what, n in contract["extents"].items():
        if n >= INDEX_LIMIT:
            err("index-extent", f"{what}: {n} >= 2^31, numbered in 32 "
                "bits by the kernel")
    smem = contract["dyn_smem"] + contract["static_smem"]
    if smem > SMEM_PER_BLOCK:
        err("shared-memory", f"{smem} bytes of shared memory per block > "
            f"{SMEM_PER_BLOCK} (227 KiB)")
    elif smem > SMEM_NO_OPTIN and not contract["smem_optin"]:
        err("shared-memory", f"{smem} bytes of shared memory per block > "
            "48 KiB without the opt-in attribute")
    if contract.get("vec") == 4 and (contract["f"] % 4
                                     or not contract["aligned16"]):
        err("vec-align", f"vec=4 at F={contract['f']} (aligned "
            f"{contract['aligned16']}): 16-byte rows need F % 4 == 0 and "
            "16-byte aligned B and output")

    if "bands" in contract:
        findings.extend(check_bands(contract))

    bounds = contract["index_bounds"]
    if len(scalar_args) != len(bounds):
        err("index-bounds", f"contract names {len(bounds)} index "
            f"operand(s) {tuple(bounds)} but {len(scalar_args)} "
            "stand-in(s) were supplied")
    else:
        for (op, hi), arr in zip(bounds.items(), scalar_args):
            arr = np.asarray(arr)
            want = contract["shapes"].get(op)
            if want is not None and tuple(arr.shape) != tuple(want):
                err("index-bounds", f"{op} stand-in {tuple(arr.shape)} "
                    f"vs operand {tuple(want)}")
            elif arr.size and (arr.min() < 0 or arr.max() >= hi):
                err("index-bounds", f"{op} values in [{arr.min()}, "
                    f"{arr.max()}] exceed [0, {hi}): the kernel would "
                    "read past its operand")

    log = _log_of(contract["source"]) if ptxas_log is None else ptxas_log
    if not log:
        err("registers", f"not checked: no ptxas log of "
            f"{contract['source']}.cu (nothing built)", "warn")
        return findings
    entries = [e for e in _build.ptxas_entries(log)
               if contract["ptxas_name"] in e["name"]]
    if not entries:
        err("registers", f"instance {contract['ptxas_name']} not in the "
            f"ptxas log of {contract['source']}.cu")
    for e in entries:
        if e["spill_stores"] or e["spill_loads"]:
            err("registers", f"{e['name']} spills {e['spill_stores']} "
                f"bytes and reloads {e['spill_loads']} bytes at "
                f"{e['registers']} registers")
        if e["registers"] * threads > REGISTERS_PER_SM:
            err("registers", f"{e['name']}: {e['registers']} registers x "
                f"{threads} threads > {REGISTERS_PER_SM}")
    return findings


def check_bands(contract: dict) -> List[Finding]:
    """The band table of an ELL contract: Ks strictly descending, each
    in [0, Kmax], counts summing to the units; for the ragged kernel a
    ``max_bands`` of at least 1, and the mode its band count takes: at
    most ``VALUE_BANDS`` bands by value (``ell_rows_kernel``), more as a
    [U] table (``ell_rows_table_kernel``) of one entry a unit."""
    _, u, _, kmax = contract["shapes"]["cols"]
    bands = tuple(contract["bands"])
    ks = [k for k, _ in bands]
    msgs = []
    if any(a <= b for a, b in zip(ks, ks[1:])):
        msgs.append(f"band Ks {ks} do not descend")
    if any(not 0 <= k <= kmax for k in ks):
        msgs.append(f"band Ks {ks} outside [0, Kmax={kmax}]: a chain "
                    "would read past the slab's lanes")
    if sum(n for _, n in bands) != u or any(n <= 0 for _, n in bands):
        msgs.append(f"band counts {[n for _, n in bands]} do not cover "
                    f"the {u} units")
    if contract["name"] == "ragged_ell_rows":
        mb = contract.get("max_bands")
        if mb is not None and mb < 1:
            msgs.append(f"max_bands={mb}: the ragged kernel takes 1 or "
                        "more K bands")
        want = ("ell_rows_kernel" if band_mode(bands) == "value"
                else "ell_rows_table_kernel")
        if contract["kernel"] != want:
            msgs.append(f"{len(bands)} bands launched by "
                        f"{contract['kernel']}: the ragged kernel takes at "
                        f"most {VALUE_BANDS} by value (ell_rows_kernel), "
                        "more as a table (ell_rows_table_kernel)")
        table = contract["shapes"].get("band_k")
        if want == "ell_rows_table_kernel" and table != (u,):
            msgs.append(f"band table {table} for {u} units: the kernel "
                        "reads one entry a unit")
    return [Finding("kernel", "bands", "error", contract["name"], m)
            for m in msgs]


# ----------------------------------------------------------- class fit -----

def check_class_fit(need: ClassNeed, sc: ShapeClass,
                    policy: ShapePolicy = ShapePolicy()) -> List[Finding]:
    """Legality oracle: may ``need`` be served out of class ``sc``?

    Deliberately re-derives the waste bounds instead of delegating to
    `class_fits`, then ALSO cross-checks against it — if the two ever
    disagree, the runtime fit logic regressed (or this oracle did), and
    either way the lint should fail loudly.
    """
    loc = sc.summary()
    findings: List[Finding] = []

    def err(rule: str, msg: str) -> None:
        findings.append(Finding("kernel", rule, "error", loc, msg))

    slack = policy.fit_slack
    if need.ell_units > sc.ell_units or need.ell_kmax > sc.ell_kmax:
        err("class-capacity",
            f"need (Kmax={need.ell_kmax}, units={need.ell_units}) "
            f"overflows class (Kmax={sc.ell_kmax}, units={sc.ell_units})")
    if need.ell_units:
        if sc.ell_kmax > slack * need.ell_kmax:
            err("slab-width",
                f"class slab Kmax={sc.ell_kmax} > {slack}x the member's "
                f"widest unit K={need.ell_kmax}: every unit's masked "
                f"tail becomes dead trips")
        # padded-MAC amortization: the banded kernel executes each
        # capacity slot at its band's K width, so banded MACs beyond
        # slack*Kmax*need_units + granule*Kmax is work the member can
        # never amortize
        class_macs = sum(k * n for k, n in sc.bands)
        budget = (slack * sc.ell_kmax * need.ell_units
                  + policy.unit_granule * sc.ell_kmax)
        if class_macs > budget:
            err("mac-amortization",
                f"class runs {class_macs} banded MAC slots/row for a "
                f"member needing {need.ell_units} units: padded-MAC "
                f"budget allows at most {budget:.0f} (slack={slack}, "
                f"granule={policy.unit_granule})")
        # band slot dominance: unit i of the member must fit the K of
        # class slot i (pad_to_class keeps unit order)
        profile = (need.ell_band_profile
                   or ((need.ell_kmax, need.ell_units),))
        slots = np.repeat([k for k, _ in sc.bands],
                          [n for _, n in sc.bands]).astype(np.int64)
        needs = np.repeat([k for k, _ in profile],
                          [n for _, n in profile]).astype(np.int64)
        if needs.size > slots.size:
            err("band-slot",
                f"member has {needs.size} units but the class bands "
                f"expose {slots.size} slots")
        elif needs.size and not (needs <= slots[: needs.size]).all():
            bad = int(np.flatnonzero(needs > slots[: needs.size])[0])
            err("band-slot",
                f"member unit {bad} (K={int(needs[bad])}) exceeds class "
                f"band slot K={int(slots[bad])}")
    oracle_ok = not findings
    runtime_ok = class_fits(need, sc, policy)
    # The oracle only covers the ELL waste bounds; runtime class_fits
    # also checks tile/dense/coo fields. Disagreement in the direction
    # "oracle rejects but runtime accepts" is the dangerous one.
    if not oracle_ok and runtime_ok:
        err("fit-oracle-drift",
            "class_fits accepts a fit the static waste bounds reject — "
            "runtime fit logic and the lint oracle have drifted")
    return findings


# ------------------------------------------------------ repo-level run -----

def contracts_for_class(sc: ShapeClass, f_widths: Sequence[int],
                        tune: Optional[dict] = None) -> List[tuple]:
    """(contract, scalar_args) pairs the engine would launch for one
    member of ``sc`` at each feature width, with worst-case index
    stand-ins (``repro_torch.kernels.autotune.class_stand_ins``: every
    unit on the LAST column tile at its band slot's FULL K): the COO row
    kernel over the class's COO capacity (every entry on B's last row,
    every output row live), the ragged kernel with the class's bands in
    the launch shape ``tune`` (clamped at each width; None = the
    defaults), which is how the autotuner audits its candidates, and the
    fixed-K kernel over the class's buckets (one launch a layer); for
    each (vals, B) type pair of ``ELL_DTYPES``."""
    from repro_torch.kernels.autotune import class_stand_ins
    out = []
    nb = sc.n_col_tiles * sc.tile
    for f, (vt, bt) in itertools.product(f_widths, ELL_DTYPES):
        if sc.coo_nnz:
            out.append((coo_rows_contract(
                1, sc.coo_nnz, nb, sc.n_row_tiles * sc.tile, f,
                vals_dtype=getattr(torch, vt), b_dtype=getattr(torch, bt)),
                (np.full((1, sc.coo_nnz), nb - 1, np.int32),)))
    if not (sc.ell_units and sc.ell_kmax):
        return out
    tile_col, cols, unit_k = class_stand_ins(sc)
    for f, (vt, bt) in itertools.product(f_widths, ELL_DTYPES):
        types = dict(vals_dtype=getattr(torch, vt),
                     b_dtype=getattr(torch, bt))
        shape = (1, sc.ell_units, sc.r_block, sc.ell_kmax, sc.n_col_tiles,
                 sc.tile, f)
        out.append((ragged_ell_contract(*shape, segments=sc.bands,
                                        tune=tune, **types),
                    (tile_col, cols, unit_k)))
        out.append((ell_contract(*shape, segments=sc.bands, **types),
                    (tile_col, cols, unit_bounds(sc.bands))))
    return out


def heads_contracts_for_class(sc: ShapeClass, heads: int,
                              f: int) -> List[tuple]:
    """(contract, scalar_args) pairs a GAT layer of ``heads`` heads and
    ``f`` features (H * F') launches for one member of ``sc``: the
    multi-head COO row kernel and ragged ELL kernel (worst-case index
    stand-ins as ``contracts_for_class``), the row statistics over every
    padded row and the edge coefficients over the class's slots."""
    from repro_torch.kernels.autotune import class_stand_ins
    out = []
    nb = sc.n_col_tiles * sc.tile
    p = sc.n_row_tiles * sc.tile
    if sc.coo_nnz:
        out.append((coo_rows_heads_contract(1, sc.coo_nnz, nb, p, f, heads),
                    (np.full((1, sc.coo_nnz), nb - 1, np.int32),)))
    if sc.ell_units and sc.ell_kmax:
        out.append((ragged_ell_heads_contract(
            1, sc.ell_units, sc.r_block, sc.ell_kmax, sc.n_col_tiles,
            sc.tile, f, heads, segments=sc.bands), class_stand_ins(sc)))
    slots = (sc.n_dense_tiles * sc.tile * sc.tile
             + sc.ell_units * sc.r_block * sc.ell_kmax + sc.coo_nnz)
    out.append((gat_coef.row_stats_contract(p, heads), ()))
    out.append((gat_coef.edge_coef_contract(slots, heads), ()))
    return out


def run_kernel_pass(engine=None, *, device="cuda",
                    policy: Optional[ShapePolicy] = None,
                    f_widths: Optional[Sequence[int]] = None
                    ) -> List[Finding]:
    """Repo-level entry: audit every contract the engine's registered
    classes imply at each of ``f_widths`` (ragged kernel in each class's
    applied tuning at that width, fixed-K kernel over the buckets, the COO
    row kernel over the class's COO capacity; each for every (vals, B)
    type pair of ``ELL_DTYPES``), the dense matmul
    contract in every configuration and operand type, and every
    (member, class) fit in the engine.
    ``engine`` None builds the fixture engine on ``device``; on a card
    the kernels are built first, so the registers rule reads the real
    ptxas logs. ``f_widths`` None: the fixture's widths, 128 and
    ``CLAMP_F``."""
    from repro_torch.analysis.static.fixtures import (FIXTURE_F_HID,
                                                      FIXTURE_F_IN,
                                                      FIXTURE_F_OUT,
                                                      fixture_engine)
    if engine is None:
        engine = fixture_engine(device=device)
    if engine.device.type == "cuda":
        _build.build_all()
    policy = policy or engine.policy
    findings: List[Finding] = []
    if f_widths is None:
        f_widths = (FIXTURE_F_IN, FIXTURE_F_HID, FIXTURE_F_OUT, 128,
                    CLAMP_F)
    seen = set()
    for h in engine._graphs.values():
        if h.sclass not in seen:
            seen.add(h.sclass)
            for f in f_widths:
                tune = engine.executors.tuned_for(h.sclass, f) or None
                for contract, scalars in contracts_for_class(
                        h.sclass, (f,), tune):
                    findings.extend(check_contract(contract,
                                                   scalar_args=scalars))
            # the multi-head instances a GAT over this class launches
            for heads, width in itertools.product(_build.HEADS,
                                                  HEAD_WIDTHS):
                for contract, scalars in heads_contracts_for_class(
                        h.sclass, heads, heads * width):
                    findings.extend(check_contract(contract,
                                                   scalar_args=scalars))
        if h.need is not None:
            findings.extend(check_class_fit(h.need, h.sclass, policy))
    # the dense matmul contract in every configuration, at the
    # reference's two audit sizes; the bfloat16 instances with B's rows
    # 16-byte aligned and not (the staged instances)
    for (m, k, n), config, dtype in itertools.product(
            ((512, 512, 512), (2048, 1024, 256)), CONFIGS, MATMUL_DTYPES):
        for b_aligned in (True, False) if dtype == torch.bfloat16 else (
                True,):
            findings.extend(check_contract(matmul_contract(
                m, k, n, config=config, dtype=dtype,
                b_aligned=b_aligned)))
    return findings
