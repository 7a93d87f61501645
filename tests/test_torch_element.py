"""The port's element-path operator against the JAX package (CPU): the
dof-incidence tables the CUDA kernel reads, the plain element matvec (the
kernel's plain version) on quad4, a renumbered quad4 mesh and hex8, and the
kernel wrapper's checks. The kernel itself runs only on the GPU
(chip_smoke.py holds it against the plain version there)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import SectionCard as JaxSectionCard
from vbicm_tpu.mesh import MeshData as JaxMeshData
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.assembly import element_matvec as jax_element_matvec
from vbicm_tpu.ops.assembly import make_sorted_scatter as jax_make_sorted_scatter
from vbicm_tpu.ops.element_matvec_pallas import make_fused_affine_matvec
from vbicm_tpu_torch.config import SectionCard
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh, renumber_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.assembly import (
    dof_incidence,
    element_affine_matvec,
    jacobi_diagonal,
    make_sorted_scatter,
)
from vbicm_tpu_torch.ops.element_kernel import (
    MAXE,
    ElementOperator,
    element_affine_matvec_kernel,
)
from vbicm_tpu_torch.utils import trace

# (name, port mesh factory, section): quad4 Cook's, the same mesh with its
# nodes and elements randomly renumbered, and a hex8 box
MESHES = {
    "quad4_8x4": (lambda: cooks_membrane_mesh(8, 4), SectionCard()),
    "quad4_20x10_renumbered": (lambda: renumber_mesh(cooks_membrane_mesh(20, 10), seed=3),
                               SectionCard()),
    "hex8_4x2x2": (lambda: beam_hex8_mesh(4, 2, 2), SectionCard(stype=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=list(MESHES))
def models(request):
    """(port model, JAX model) of one mesh, matrix-free, float64."""
    make, sec = MESHES[request.param]
    mesh = make()
    jsec = JaxSectionCard(**dataclasses.asdict(sec))
    return (build_fem_model(mesh, sec, device="cpu", dense=False),
            jax_build_fem_model(JaxMeshData(**dataclasses.asdict(mesh)), jsec, dense=False))


def _inputs(B, ndof, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5.0, 15.0, (B, 2)).astype(dtype),
            rng.standard_normal((B, ndof)).astype(dtype))


def test_renumbered_mesh_is_unstructured_and_the_same_problem():
    mesh = cooks_membrane_mesh(20, 10)
    ren = renumber_mesh(mesh, seed=3)
    assert not np.array_equal(ren.conn, mesh.conn)
    # the same element geometry, in another order
    assert np.allclose(np.sort(ren.coords[ren.conn].sum(1), axis=0),
                       np.sort(mesh.coords[mesh.conn].sum(1), axis=0))


def test_incidence_tables_are_the_jax_sort(models):
    model, jmodel = models
    lm = np.asarray(jmodel.lm)
    assert np.array_equal(model.lm.numpy(), lm)
    row_ptr, ent = dof_incidence(model.lm, model.ndof)
    assert row_ptr.dtype == ent.dtype == np.int32
    flat = lm.reshape(-1)
    # ent is the JAX package's stable sort of the dof map ...
    assert np.array_equal(ent, np.argsort(flat, kind="stable"))
    # ... and row_ptr its segment boundaries
    assert np.array_equal(row_ptr, np.searchsorted(flat[ent], np.arange(model.ndof + 1)))
    # a pull through the tables is JAX's sorted segment-sum scatter, in f64
    qe = np.random.default_rng(1).standard_normal(lm.shape)
    pulled = np.add.reduceat(qe.reshape(-1)[ent], row_ptr[:-1])
    want = np.asarray(jax_make_sorted_scatter(lm, model.ndof)(jnp.asarray(qe)))
    assert np.abs(pulled - want).max() <= 1e-12 * np.abs(want).max()


def test_kernel_pull_form_on_the_tables_matches_plain(models):
    """The kernel's arithmetic in NumPy, one dof at a time over its
    incidence list (the sums in the kernel's order), against the plain
    version: the tables carry everything the kernel reads."""
    model, _ = models
    row_ptr, ent = dof_incidence(model.lm, model.ndof)
    coeffs, u = _inputs(3, model.ndof, seed=2)
    ke = np.stack([model.ke_lam.numpy(), model.ke_mu.numpy()])
    lm = model.lm.numpy()
    edof = lm.shape[1]
    e, i = np.divmod(ent, edof)
    rows = ke[:, e, i, :]  # (2, nnz, edof): the entries' block rows, in pull order
    ue = u[:, lm[e]]  # (B, nnz, edof)
    parts = np.einsum("pkj,bkj->bpk", rows, ue)
    q = np.stack([np.add.reduceat(coeffs[:, p:p + 1] * parts[:, p], row_ptr[:-1], axis=1)
                  for p in range(2)]).sum(0)
    want = element_affine_matvec(torch.stack([model.ke_lam, model.ke_mu]), model.lm,
                                 torch.as_tensor(coeffs), torch.as_tensor(u), model.ndof).numpy()
    # float64, sums in another order: 1e-12 of max |q|
    assert np.abs(q - want).max() <= 1e-12 * np.abs(want).max()


def _emulate_quad4_kernel(ke, lm, row_ptr, ent, coeffs, u, groups, step=4, pad=True):
    """The quad4 kernel's arithmetic in NumPy, all dofs at once: the samples
    cut into ``groups`` balanced runs; in each run the rows of a dof's first
    MAXE entries are gathered once ("registers"; with ``pad``, as the kernel
    does, an entry the dof does not have is zero weights on columns of its
    own node), the samples walked ``step`` at a time, each sample's two sums
    taken over the register entries and then over the further entries, whose
    rows are gathered inside the sample loop -- in both, entry by entry and
    column by column, the kernel's order."""
    B, ndof = u.shape
    edof = lm.shape[1]
    n = np.diff(row_ptr)
    e, i = np.divmod(ent, edof)
    own = (np.arange(ndof) & ~1)[:, None] + (np.arange(edof) & 1)  # a dof's node's columns

    def entry(k, padded):  # the dofs that take a k-th entry, its rows and columns
        has = np.arange(ndof) if padded else np.nonzero(n > k)[0]
        idx = row_ptr[has] + np.minimum(k, n[has] - 1)
        real = n[has] > k
        rows = np.where(real[:, None], ke[:, e[idx], i[idx], :], 0.0)
        return has, rows, np.where(real[:, None], lm[e[idx]], own[has])

    def pull(a, ss, has, rows, cols):
        for j in range(edof):
            x = u[ss][:, cols[:, j]]  # (samples, dofs)
            a[:, :, has] += rows[:, None, :, j] * x[None]

    q = np.full_like(u, np.nan)
    for g in range(groups):
        s_begin, s_end = g * B // groups, (g + 1) * B // groups
        registers = [entry(k, pad) for k in range(MAXE)]
        for s in range(s_begin, s_end, step):
            ss = np.arange(s, min(s + step, s_end))
            a = np.zeros((2, len(ss), ndof), dtype=u.dtype)
            for has, rows, cols in registers:
                pull(a, ss, has, rows, cols)
            for k in range(MAXE, n.max(initial=0)):
                pull(a, ss, *entry(k, False))
            q[ss] = coeffs[ss, :1] * a[0] + coeffs[ss, 1:] * a[1]
    return q


@pytest.mark.parametrize("name", ["quad4_8x4", "quad4_20x10_renumbered"])
@pytest.mark.parametrize("groups", [1, 3])
def test_register_then_overflow_pull_on_doubled_elements_f64(name, groups):
    """Every element listed twice (dofs with up to 2 MAXE entries, so the
    entries beyond the registers run): the kernel's pull order against the
    plain version on the doubled tables and against twice the JAX package's
    element matvec, float64, 1e-12 of max |q| (sums in other orders)."""
    make, sec = MESHES[name]
    mesh = make()
    model = build_fem_model(mesh, sec, device="cpu", dense=False)
    jmodel = jax_build_fem_model(JaxMeshData(**dataclasses.asdict(mesh)), dense=False)
    ke2 = torch.stack([model.ke_lam, model.ke_mu]).repeat(1, 2, 1, 1)
    lm2 = model.lm.repeat(2, 1)
    row_ptr, ent = dof_incidence(lm2, model.ndof)
    assert np.diff(row_ptr).max() == 2 * MAXE
    coeffs, u = _inputs(7, model.ndof, seed=11)
    q = _emulate_quad4_kernel(ke2.numpy(), lm2.numpy(), row_ptr, ent, coeffs, u, groups)
    plain = element_affine_matvec(ke2, lm2, torch.as_tensor(coeffs), torch.as_tensor(u),
                                  model.ndof).numpy()
    assert np.abs(q - plain).max() <= 1e-12 * np.abs(plain).max()
    for b in range(u.shape[0]):
        ke = coeffs[b, 0] * jmodel.ke_lam + coeffs[b, 1] * jmodel.ke_mu
        want = 2 * np.asarray(jax_element_matvec(ke, jmodel.lm, jnp.asarray(u[b]), jmodel.ndof))
        assert np.abs(q[b] - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zero_weight_register_entries_change_no_bit(dtype):
    """The kernel gives a dof with fewer than MAXE entries zero-weight
    entries on its own node's columns instead of a branch: for finite u that
    adds +0 to sums that are never -0, so q's bits are those of the
    unpadded order (Cook's 8x4: dofs with 1, 2 and 4 entries)."""
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
    ke = np.stack([model.ke_lam.numpy(), model.ke_mu.numpy()]).astype(dtype)
    lm = model.lm.numpy()
    row_ptr, ent = dof_incidence(lm, model.ndof)
    assert set(np.diff(row_ptr)) == {1, 2, 4}
    coeffs, u = _inputs(6, model.ndof, seed=13, dtype=dtype)
    u[0, :4] = 0.0  # zero and -0 inputs too
    u[1, 4:8] = -0.0
    padded, plain_order = (_emulate_quad4_kernel(ke, lm, row_ptr, ent, coeffs, u, 2, pad=p)
                           for p in (True, False))
    assert padded.dtype == dtype
    assert np.array_equal(padded.view(np.uint8), plain_order.view(np.uint8))


@pytest.mark.parametrize("make,most", [
    (lambda: cooks_membrane_mesh(8, 4), MAXE),
    (lambda: cooks_membrane_mesh(32, 16), MAXE),
    (lambda: cooks_membrane_mesh(160, 80), MAXE),
    (lambda: renumber_mesh(cooks_membrane_mesh(20, 10), seed=3), MAXE),
    (lambda: renumber_mesh(cooks_membrane_mesh(160, 80), seed=3), MAXE),
    (lambda: beam_hex8_mesh(4, 2, 2), 8),
    (lambda: beam_hex8_mesh(32, 8, 8), 8),
], ids=["8x4", "32x16", "160x80", "20x10_renumbered", "160x80_renumbered", "hex8_4x2x2",
        "hex8_32x8x8"])
def test_incidence_entries_a_dof(make, most):
    """The quad4 meshes the kernel is timed and checked on have at most MAXE
    incidence entries a dof, so their rows all sit in registers (a node in
    at most 4 elements: 1, 2 or 4 entries); hex8 has up to 8."""
    mesh = make()
    model = build_fem_model(mesh, SectionCard(stype=4) if mesh.conn.shape[1] == 8
                            else SectionCard(), device="cpu", dense=False)
    row_ptr, _ = dof_incidence(model.lm, model.ndof)
    n = np.diff(row_ptr)
    assert n.max() == most and n.min() >= 1
    if most == MAXE:
        assert set(np.unique(n)) <= {1, 2, 4}


def test_jacobi_diagonal_is_the_pull_of_the_jax_scatter(models):
    """The Jacobi diagonal, summed on the host in the incidence order,
    against JAX's sorted segment-sum of the block diagonals and the port's
    index_add_ scatter (f64, sums in other orders: 1e-12 of the max); a dof
    that no element touches gets 0."""
    model, jmodel = models
    ke = model.ke_lam
    d = jacobi_diagonal(ke, model.lm, model.ndof)
    want = np.asarray(jax_make_sorted_scatter(np.asarray(jmodel.lm), model.ndof)(
        jnp.diagonal(jmodel.ke_lam, axis1=-2, axis2=-1)))
    assert d.dtype == ke.dtype and d.device == ke.device
    assert np.abs(d.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    plain = make_sorted_scatter(model.lm, model.ndof)(torch.diagonal(ke, dim1=-2, dim2=-1))
    assert float((d - plain).abs().max()) <= 1e-12 * float(plain.abs().max())
    padded = jacobi_diagonal(ke, model.lm, model.ndof + 1)
    assert torch.equal(padded[:-1], d) and float(padded[-1]) == 0.0


def test_plain_matches_jax_element_matvec_f64(models):
    model, jmodel = models
    coeffs, u = _inputs(4, model.ndof, seed=4)
    op = ElementOperator(torch.stack([model.ke_lam, model.ke_mu]), model.lm, model.ndof)
    q = op.affine(torch.as_tensor(coeffs), torch.as_tensor(u)).numpy()
    for b in range(4):
        ke = coeffs[b, 0] * jmodel.ke_lam + coeffs[b, 1] * jmodel.ke_mu
        want = np.asarray(jax_element_matvec(ke, jmodel.lm, jnp.asarray(u[b]), jmodel.ndof))
        # float64 on both sides, one element sum order: 1e-12 of max |q|
        assert np.abs(q[b] - want).max() <= 1e-12 * np.abs(want).max()


def test_plain_matches_jax_fused_pallas_kernel_f32():
    """The plain version in float32 against the JAX package's Pallas kernel
    (interpret mode) at 8x4, as the JAX package's own test runs it."""
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
    jmodel = jax_build_fem_model(JaxMeshData(**dataclasses.asdict(cooks_membrane_mesh(8, 4))),
                                 dense=False)
    coeffs, u = _inputs(3, model.ndof, seed=0, dtype=np.float32)
    want = np.asarray(make_fused_affine_matvec(jmodel, interpret=True, tile_e=128)(
        jnp.asarray(coeffs), jnp.asarray(u)))
    op = ElementOperator(torch.stack([model.ke_lam, model.ke_mu]), model.lm, model.ndof)
    q = op.affine(torch.as_tensor(coeffs), torch.as_tensor(u)).numpy()
    assert q.dtype == np.float32
    # float32 products summed in two orders: the JAX package's own tolerance
    np.testing.assert_allclose(q, want, rtol=2e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
    ke = torch.stack([model.ke_lam, model.ke_mu])
    row_ptr, ent = (torch.as_tensor(t) for t in dof_incidence(model.lm, model.ndof))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(3, model.ndof, seed=9))
    before = trace.counters().get("element_affine.launches", 0)
    q = element_affine_matvec_kernel(ke, model.lm.int(), row_ptr, ent, coeffs, u)
    assert torch.equal(q, element_affine_matvec(ke, model.lm, coeffs, u, model.ndof))
    assert trace.counters().get("element_affine.launches", 0) == before


def test_wrapper_on_cpu_runs_plain_on_doubled_elements_and_counts_no_launch():
    """Dofs with more entries than the kernel holds in registers: on the CPU
    the wrapper still runs the plain version and counts no launch."""
    model = build_fem_model(renumber_mesh(cooks_membrane_mesh(20, 10), seed=3), device="cpu",
                            dense=False)
    ke2 = torch.stack([model.ke_lam, model.ke_mu]).repeat(1, 2, 1, 1)
    lm2 = model.lm.repeat(2, 1).int()
    row_ptr, ent = (torch.as_tensor(t) for t in dof_incidence(lm2, model.ndof))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(5, model.ndof, seed=12))
    before = trace.counters().get("element_affine.launches", 0)
    q = element_affine_matvec_kernel(ke2, lm2, row_ptr, ent, coeffs, u)
    once = element_affine_matvec(ke2[:, :model.nele], model.lm, coeffs, u, model.ndof)
    assert float((q - 2 * once).abs().max()) <= 1e-12 * float(once.abs().max())
    assert trace.counters().get("element_affine.launches", 0) == before


def _meta_args(nele=6, edof=8, ndof=20, B=3, dtype=torch.float32):
    """Well-formed arguments on the meta device (no data, no CPU)."""
    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return dict(ke_parts=m((2, nele, edof, edof), dtype), lm=m((nele, edof), torch.int32),
                row_ptr=m((ndof + 1,), torch.int32), ent=m((nele * edof,), torch.int32),
                coeffs=m((B, 2), dtype), u=m((B, ndof), dtype))


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "CUDA device"),  # not on a CUDA device
    ({"u": torch.empty((3, 20), dtype=torch.float16, device="meta")}, TypeError, None),
    ({"coeffs": torch.empty((3, 2), dtype=torch.float64, device="meta")}, TypeError, None),
    ({"lm": torch.empty((6, 8), dtype=torch.int64, device="meta")}, TypeError, None),
    ({"row_ptr": torch.empty((20,), dtype=torch.int32, device="meta")}, ValueError, None),
    ({"ent": torch.empty((47,), dtype=torch.int32, device="meta")}, ValueError, None),
    ({"ke_parts": torch.empty((3, 6, 8, 8), device="meta")}, ValueError, None),
    ({"coeffs": torch.empty((3, 2), device="meta").T.contiguous().T}, ValueError, None),
    ("edof 4", ValueError, None),
    # quad4 rows are read as 16-byte vectors: a block array that starts 4
    # bytes in
    ({"ke_parts": torch.empty(2 * 6 * 64 + 1, device="meta")[1:].view(2, 6, 8, 8)},
     ValueError, "16-byte"),
], ids=["device", "u-dtype", "coeffs-dtype", "lm-dtype", "row_ptr-shape", "ent-shape",
        "three-parts", "noncontiguous", "edof", "misaligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error, match):
    args = _meta_args(edof=4) if change == "edof 4" else {**_meta_args(), **change}
    before = trace.counters().get("element_affine.launches", 0)
    with pytest.raises(error, match=match):
        element_affine_matvec_kernel(**args)
    assert trace.counters().get("element_affine.launches", 0) == before
