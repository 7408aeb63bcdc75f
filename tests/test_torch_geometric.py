"""The port's geometric GNNs (DimeNet, NequIP and their SO(3) machinery)
and the random molecules against the reference.

Weights are made by the reference's initializers and carried into the
port (``convert.tree_from_numpy``); molecules come from a seed. Host
arrays (molecules, triplets, coupling tensors) must be exactly equal;
energies agree within ``FWD_TOL`` (float32; the port contracts the
three-operand einsums in one fixed order of its own, XLA in another),
gradients within ``GRAD_TOL`` (``tests/test_torch_grad.py``'s rule) and
one AdamW step within ``STEP_TOL`` (``tests/test_torch_train.py``'s).
The port's own equivariance checks mirror ``tests/test_models_gnn.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import special_ortho_group

from repro.configs import get_arch as jax_get_arch
from repro.data.graphs import random_molecules as jax_random_molecules
from repro.models import dimenet as jdimenet
from repro.models import nequip as jnequip
from repro.models import so3 as jso3
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.data.graphs import random_molecules
from repro_torch.models import dimenet, nequip, so3
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
FWD_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol_frac=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
# the nequip smoke config has l_max 1; its full config (l_max 2, every
# path of the tensor product) is small enough for the CPU too
SIZES = [("dimenet", "smoke"), ("dimenet", "config"), ("nequip", "smoke"),
         ("nequip", "config")]
FIELDS = {"dimenet": jdimenet.MoleculeBatch._fields[:-1],
          "nequip": jnequip.AtomGraph._fields[:-1]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def case(arch, size="smoke", n_mols=3, atoms=8, seed=0):
    """(reference cfg, port cfg, reference params, numpy batch with
    seeded energies)."""
    jcfg = getattr(jax_get_arch(arch), size)
    tcfg = getattr(get_arch(arch), size)
    init = jdimenet.dimenet_init if arch == "dimenet" else \
        jnequip.nequip_init
    mols = jax_random_molecules(n_mols, atoms, seed=seed)
    batch = {k: mols[k] for k in FIELDS[arch]}
    batch["energy"] = np.random.default_rng(seed + 7).standard_normal(
        n_mols).astype(np.float32)
    return jcfg, tcfg, _np(init(jcfg, KEY)), batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_forward(arch, params, batch, cfg):
    n = batch["energy"].shape[0]
    b = jax_batch(batch)
    if arch == "dimenet":
        return jdimenet.dimenet_forward(params, jdimenet.MoleculeBatch(
            *(b[k] for k in FIELDS[arch]), n), cfg)
    return jnequip.nequip_forward(params, jnequip.AtomGraph(
        *(b[k] for k in FIELDS[arch]), n), cfg)


def port_forward(arch, params, batch, cfg, **kw):
    n = batch["energy"].shape[0]
    b = torch_batch(batch) if isinstance(batch["z"], np.ndarray) else batch
    if arch == "dimenet":
        return dimenet.dimenet_forward(params, dimenet.MoleculeBatch(
            *(b[k] for k in FIELDS[arch]), n), cfg, **kw)
    return nequip.nequip_forward(params, nequip.AtomGraph(
        *(b[k] for k in FIELDS[arch]), n), cfg, **kw)


def port_loss(arch):
    return (tsteps.energy_loss_dimenet if arch == "dimenet"
            else tsteps.energy_loss_nequip)


def jax_loss(arch):
    return (jsteps.energy_loss_dimenet if arch == "dimenet"
            else jsteps.energy_loss_nequip)


def grads_close(got, want) -> bool:
    for a, b in zip(got, want):
        a = a.detach().cpu().numpy()
        b = np.asarray(b)
        atol = GRAD_TOL["atol_frac"] * float(np.abs(b).max())
        if not np.all(np.abs(a - b) <= atol + GRAD_TOL["rtol"] * np.abs(b)):
            return False
    return True


# ------------------------------------------------------- host arrays -------
@pytest.mark.parametrize("cutoff", [1.55, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_molecules_equal(seed, cutoff):
    want = jax_random_molecules(6, 10, cutoff=cutoff, seed=seed)
    got = random_molecules(6, 10, cutoff=cutoff, seed=seed)
    assert got.keys() == want.keys()
    assert got["n_mols"] == want["n_mols"] == 6
    for k in want:
        if k == "n_mols":
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["trip_kj"].size > 0


def test_build_triplets_equal_and_exclude_backtracking():
    mols = jax_random_molecules(4, 12, cutoff=2.0, seed=3)
    src, dst = mols["edge_src"], mols["edge_dst"]
    kj, ji = dimenet.build_triplets(src, dst)
    want = jdimenet.build_triplets(src, dst)
    np.testing.assert_array_equal(kj, want[0])
    np.testing.assert_array_equal(ji, want[1])
    assert kj.dtype == ji.dtype == np.int32
    # edge ji starts where kj ends; never returns to kj's source
    np.testing.assert_array_equal(dst[kj], src[ji])
    assert not np.any(dst[ji] == src[kj])
    kj, ji = dimenet.build_triplets(np.array([0, 1, 1, 2]),
                                    np.array([1, 0, 2, 1]))
    assert list(zip(kj, ji)) == [(0, 2), (3, 1)]


def test_real_cg_equal_for_every_path():
    for l1, l2, l3 in nequip._paths(2):
        np.testing.assert_allclose(so3.real_cg(l1, l2, l3),
                                   jso3.real_cg(l1, l2, l3), atol=1e-12)
    assert nequip._paths(2) == jnequip._paths(2)


def test_cg_tensor_is_built_once_per_device():
    a = so3.cg_tensor(1, 2, 1, "cpu")
    assert so3.cg_tensor(1, 2, 1, "cpu") is a
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(),
                                  so3.real_cg(1, 2, 1).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_spherical_harmonics_match(seed):
    v = np.random.default_rng(seed).standard_normal((50, 3)).astype(
        np.float32)
    want = jso3.spherical_harmonics(jnp.asarray(v), 2)
    got = so3.spherical_harmonics(torch.from_numpy(v), 2)
    assert got.keys() == want.keys()
    for l in want:
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]),
                                   atol=1e-6)


# ------------------------------------------------ forward and gradient -----
@pytest.mark.parametrize("arch,size", SIZES)
def test_energy_matches_reference(arch, size):
    jcfg, tcfg, jp, batch = case(arch, size)
    want = np.asarray(jax_forward(arch, jp, batch, jcfg))
    got = port_forward(arch, tree_from_numpy(jp, "cpu"), batch, tcfg)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("arch,size", SIZES)
def test_loss_and_gradients_match_value_and_grad(arch, size):
    jcfg, tcfg, jp, batch = case(arch, size)
    jloss, jgrads = jax.value_and_grad(jax_loss(arch))(
        jax.tree.map(jnp.asarray, jp), jax_batch(batch), jcfg)
    loss, grads = tsteps.value_and_grad(
        lambda p, b: port_loss(arch)(p, b, tcfg),
        tree_from_numpy(jp, "cpu"), torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    assert grads_close(got, want)
    # the leaves JAX gives an all-zero gradient are exactly the port's
    assert [bool(torch.all(g == 0)) for g in got] == [
        not np.any(np.asarray(w)) for w in want]


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_adamw_step_matches_reference(arch):
    jcfg, tcfg, jp, batch = case(arch)
    jo, to = jopt.AdamW(lr=1e-3), topt.AdamW(lr=1e-3)
    jstep = jsteps.make_gnn_train_step(jcfg, jo)
    tstep = tsteps.make_gnn_train_step(tcfg, to)
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = tree_from_numpy(jp, "cpu")
    jnew, _, jm = jstep(jparams, jo.init(jparams), jax_batch(batch))
    tnew, _, tm = tstep(tparams, to.init(tparams), torch_batch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_serve_step_matches_reference(arch):
    jcfg, tcfg, jp, batch = case(arch, n_mols=4, seed=2)
    want = jsteps.make_gnn_serve_step(jcfg, n_mols=4)(jp, jax_batch(batch))
    serve = tsteps.make_gnn_serve_step(tcfg, n_mols=4)
    got = serve(tree_from_numpy(jp, "cpu"), torch_batch(batch))
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_remat_is_bitwise(arch):
    """``remat=True`` recomputes each block in the backward: the same
    loss and gradients, bit for bit."""
    _, tcfg, jp, batch = case(arch)
    params, tb = tree_from_numpy(jp, "cpu"), torch_batch(batch)
    outs = [tsteps.value_and_grad(
        lambda p, b: port_loss(arch)(p, b, tcfg, remat=remat), params, tb)
        for remat in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


# ------------------------------------------- the port's own equivariance ---
class TestSO3:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sh_equivariance(self, seed):
        rng = np.random.default_rng(seed)
        rot = special_ortho_group.rvs(3, random_state=seed)
        v = rng.standard_normal((7, 3))
        sh = so3.spherical_harmonics(torch.from_numpy(v), 2)
        sh_r = so3.spherical_harmonics(torch.from_numpy(v @ rot.T), 2)
        for l in (1, 2):
            d = so3.wigner_d_from_rotation(rot, l)
            np.testing.assert_allclose(sh_r[l].numpy(), sh[l].numpy() @ d.T,
                                       atol=1e-6)

    def test_cg_intertwiner_all_paths(self):
        rot = special_ortho_group.rvs(3, random_state=7)
        for l1, l2, l3 in nequip._paths(2):
            c = so3.real_cg(l1, l2, l3)
            if np.abs(c).max() < 1e-12:
                continue
            d1, d2, d3 = (so3.wigner_d_from_rotation(rot, l)
                          for l in (l1, l2, l3))
            lhs = np.einsum("xa,yb,xyc->abc", d1, d2, c)
            rhs = np.einsum("abd,cd->abc", c, d3)
            np.testing.assert_allclose(lhs, rhs, atol=1e-12)

    def test_cg_11_1_is_cross_product_like(self):
        c = so3.real_cg(1, 1, 1)
        np.testing.assert_allclose(c, -np.transpose(c, (1, 0, 2)),
                                   atol=1e-12)


class TestNequIP:
    def _setup(self):
        jcfg, tcfg, jp, batch = case("nequip", "config")
        g = nequip.AtomGraph(*(torch.from_numpy(batch[k])
                               for k in FIELDS["nequip"]), 3)
        return tcfg, g, tree_from_numpy(jp, "cpu")

    def test_energy_invariance(self):
        cfg, g, params = self._setup()
        e0 = nequip.nequip_forward(params, g, cfg)
        for seed in range(3):
            rot = special_ortho_group.rvs(3, random_state=seed)
            shift = np.random.default_rng(seed).standard_normal(3) * 4
            pos2 = torch.from_numpy(
                (g.pos.numpy() @ rot.T + shift).astype(np.float32))
            e1 = nequip.nequip_forward(params, g._replace(pos=pos2), cfg)
            np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4,
                                       atol=1e-7)

    def test_force_covariance(self):
        cfg, g, params = self._setup()
        rot = special_ortho_group.rvs(3, random_state=3)

        def forces(pos):
            pos = pos.clone().requires_grad_(True)
            e = nequip.nequip_forward(params, g._replace(pos=pos), cfg)
            return torch.autograd.grad(e.sum(), pos)[0].numpy()

        f0 = forces(g.pos)
        f1 = forces(torch.from_numpy(
            (g.pos.numpy() @ rot.T).astype(np.float32)))
        np.testing.assert_allclose(f1, f0 @ rot.T,
                                   atol=1e-9 + 1e-4 * np.abs(f0).max())


class TestDimeNet:
    def test_energy_invariance(self):
        _, cfg, jp, batch = case("dimenet", n_mols=2, seed=1)
        mb = dimenet.MoleculeBatch(*(torch.from_numpy(batch[k])
                                     for k in FIELDS["dimenet"]), 2)
        params = tree_from_numpy(jp, "cpu")
        e0 = dimenet.dimenet_forward(params, mb, cfg)
        rot = special_ortho_group.rvs(3, random_state=5)
        pos2 = torch.from_numpy(
            (mb.pos.numpy() @ rot.T + 2.0).astype(np.float32))
        e1 = dimenet.dimenet_forward(params, mb._replace(pos=pos2), cfg)
        np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_init_trees_have_the_references_structure():
    """The port's seeded initializers give the reference's tree: the
    same keypaths and leaf shapes, on the generator's device."""
    for arch in ("dimenet", "nequip"):
        jcfg, tcfg, jp, _ = case(arch, "config")
        init = dimenet.dimenet_init if arch == "dimenet" else \
            nequip.nequip_init
        tp = init(tcfg, torch.Generator().manual_seed(0), device="cpu")
        got = tree_leaves(tp)
        want = jax.tree_util.tree_leaves(jp)
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        assert all(t.dtype == torch.float32 and t.device.type == "cpu"
                   for t in got)
