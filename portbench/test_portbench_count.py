"""The work counts against counts worked by hand at small shapes, and the
counted operands against the port's own at a small grid."""
import numpy as np
import pytest

from portbench.count import work
from portbench.count.peaks import PEAKS, peaks_for
from portbench.reference import fem

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_stencil_by_hand():
    # 2 lanes of 10 dofs, 50 coefficients, one call, float32:
    # bytes (50 + 2 * (10 + 10 + 2)) * 4, flops 2 * (2 * 50 + 3 * 10)
    w = work.stencil(2, 1, 10, 50, 4)
    assert (w.nbytes, w.flops, w.unit) == (376, 260, "fp32")
    one_part = work.stencil(2, 1, 10, 50, 8, combine=False)
    assert (one_part.nbytes, one_part.flops, one_part.unit) == (752, 200, "fp64")


def test_spectral_by_hand():
    # n = 4, 3 lanes, float64 with coordinates: V, g once, each lane's
    # (c0, c1), b, x, a: (16 + 4 + 3 * (2 + 3 * 4)) * 8; 3 * (4 * 16 + 3 * 4)
    w = work.spectral(3, 1, 4, 8, coords=True)
    assert (w.nbytes, w.flops, w.unit) == (496, 228, "fp64_tc")
    assert work.spectral(3, 1, 4, 4, coords=False).nbytes == (20 + 3 * (2 + 8)) * 4
    assert work.spectral(3, 1, 4, 4, coords=False).unit == "tf32x3_tc"


def test_hat_transfer_by_hand():
    from vbicm_tpu_torch.ops.multigrid import hat_matrix

    assert work.hat_nnz(2, 4) == 3 + 2 * 6 == np.count_nonzero(hat_matrix(9, 3, 4))
    assert work.hat_nnz(40, 4) == np.count_nonzero(hat_matrix(161, 41, 4))
    # (ny_c, nx_c) = (1, 2) at ratio 2: fine 3 x 5, coarse 2 x 3 nodes, 2 dofs;
    # weights 4 (y) and 7 (x); x first: 7 * 3 + 4 * 3 = 33 multiply-adds a dof
    w = work.hat_transfer(1, 1, (1, 2), 2, 4)
    assert (w.nbytes, w.flops) == ((2 * (15 + 6) + 11) * 4, 2 * 2 * 33)


def test_vector_and_least_time():
    w = work.vector(2, 5, 3, 1, 2, 8)
    assert (w.nbytes, w.flops, w.unit) == (2 * 5 * 4 * 8, 20, "fp64")
    p = {"hbm_bytes_per_s": 10.0, "fp32": 2.0, "fp64": 1.0, "tf32x3_tc": 4.0, "fp64_tc": 4.0}
    works = [work.Work("stencil", 100.0, 10.0, "fp32"), work.Work("vector", 10.0, 40.0, "fp64")]
    assert work.least_time_s(works, p) == 10.0 + 40.0
    assert work.least_time_s(works, p, "stencil") == 10.0


def test_cg_run_counts_needed_lanes():
    g = work.TwoLevel(ndof=100, nnz_parts=(300, 400), cells_c=(1, 2), ratio=2, n_coarse=10)
    runs = work.cg_run(g, np.array([2, 4]), 4)
    # 6 lane-iterations in 4 batched matvecs; 8 preconditioner applies in 5
    assert runs[0] == work.stencil(6, 4, 100, 700, 4)
    assert runs[2] == work.spectral(8, 5, 10, 4, coords=False)
    assert runs[-1] == work.vector(6, 100, 11, 3, 12, 4)
    assert work.cg_run(g, np.array([], dtype=np.int64), 4) == []
    solve = work.two_level_solve(g, [np.array([2, 4]), np.array([1, 1])])
    assert solve[len(runs)] == work.stencil(2, 1, 100, 700, 8)


def test_peaks_have_no_cpu_entry():
    assert peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        peaks_for("cpu")


def test_counted_nonzeros_are_the_ports_coefficients():
    """The reference's assembled nonzeros are the stencil kernel's nonzero
    coefficients (its packed planes), at 16x8."""
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.stencil import build_stencil_tables
    from vbicm_tpu_torch.ops.stencil_kernel import pack_w_interleaved

    cfg = {"mesh": {"nx": 16, "ny": 8}, "probe": {"node_id": 153, "ele_id": 67,
                                                   "nipt_id": [1, 3]},
           "theta_map": {"mean": [np.log(20.0), 0.0], "std": [0.1, 0.015]}}
    problem = fem.build_problem(cfg, "cpu")
    model = build_fem_model(cooks_membrane_mesh(16, 8), device="cpu", dense=False)
    planes = pack_w_interleaved(build_stencil_tables(model, 16, 8))
    assert sum(problem.nnz_parts) == np.count_nonzero(planes)


def test_full_size_step_bound_matches_the_kernel_table():
    """At (256, 160x80) float32 the stencil's least time is PERF.md's 0.0171
    ms and the coarse apply's at (256, 1680) its 3xTF32 bound 0.0175 ms."""
    cfg = {"mesh": {"nx": 160, "ny": 80}, "probe": {"node_id": 13041, "ele_id": 6412,
                                                     "nipt_id": [1, 3]},
           "theta_map": {"mean": [np.log(20.0), 0.0], "std": [0.1, 0.015]}}
    nnz = sum(fem.build_problem(cfg, "cpu").nnz_parts)
    t = work.least_time_s([work.stencil(256, 1, 26082, nnz, 4)], H100)
    assert abs(t * 1e3 - 0.0171) < 0.0005
    t = work.least_time_s([work.spectral(256, 1, 1680, 4, coords=True)], H100)
    assert abs(t * 1e3 - 0.0175) < 0.0005


def _box_config(mesh):
    import json
    import os

    from portbench.conftest import tiny_config
    from portbench.harness import manifest

    with open(os.path.join(manifest.BENCH_DIR, "configs", "box_32x8x8.json")) as f:
        return tiny_config(json.load(f), mesh)


def _exact_box_nonzeros(nx, ny, nz, lx, ly, lz):
    """The nonzero coefficients of the assembled K_lam and K_mu of the
    uniform hex8 box over all dofs, tallied in exact rationals: a hex8
    entry is a product of 1-D integrals of the linear hats on [0, h] (mass
    h/3, h/6; stiffness 1/h, -1/h; a derivative against a hat -1/2 or 1/2),
    which the 2x2x2 Gauss rule integrates exactly, and K_lam[(a,i),(b,j)] =
    int N_a,i N_b,j, K_mu[(a,i),(b,j)] = delta_ij grad N_a . grad N_b +
    int N_a,j N_b,i."""
    from collections import defaultdict
    from fractions import Fraction as F

    hs = [F(lx) / nx, F(ly) / ny, F(lz) / nz]
    loc = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1),
           (0, 1, 1)]

    def one_d(h, s, t, ds, dt):
        if ds and dt:
            return 1 / h if s == t else -1 / h
        if ds or dt:
            return F(1, 2) if (s if ds else t) == 1 else F(-1, 2)
        return h / 3 if s == t else h / 6

    def grad_grad(a, b, k, l):
        out = F(1)
        for ax in range(3):
            out *= one_d(hs[ax], loc[a][ax], loc[b][ax], ax == k, ax == l)
        return out

    ke = {}
    for a in range(8):
        for b in range(8):
            gg = {(k, l): grad_grad(a, b, k, l) for k in range(3) for l in range(3)}
            lap = sum(gg[(k, k)] for k in range(3))
            for i in range(3):
                for j in range(3):
                    ke[(a, i, b, j)] = (gg[(i, j)], (lap if i == j else 0) + gg[(j, i)])
    K = [defaultdict(F), defaultdict(F)]

    def node(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                nodes = [node(i + p[0], j + p[1], k + p[2]) for p in loc]
                for (a, di, b, dj), parts in ke.items():
                    for p in range(2):
                        K[p][(3 * nodes[a] + di, 3 * nodes[b] + dj)] += parts[p]
    return tuple(sum(v != 0 for v in Kp.values()) for Kp in K)


@pytest.mark.parametrize("mesh", [{"nx": 4, "ny": 2, "nz": 2}, {"nx": 6, "ny": 4, "nz": 2}],
                         ids=["4x2x2", "6x4x2"])
def test_box_nonzeros_are_an_exact_tally_and_the_ports(mesh):
    """The box reference's nonzeros by part (its coefficients over 1e-12 of
    the largest) are the exact tally's, and the 3-D stencil kernel's tables
    hold as many over round-off."""
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.stencil3d import build_stencil_tables_3d

    from portbench.reference import fem_box

    cfg = _box_config(mesh)
    m = cfg["mesh"]
    problem = fem_box.build_problem(cfg, "cpu")
    assert problem.nnz_parts == _exact_box_nonzeros(m["nx"], m["ny"], m["nz"], m["lx"],
                                                    m["ly"], m["lz"])
    model = build_fem_model(beam_hex8_mesh(m["nx"], m["ny"], m["nz"], tip_force=(0, 0, -1)),
                            SectionCard(stype=4), device="cpu", dense=False)
    W = build_stencil_tables_3d(model, m["nx"], m["ny"], m["nz"])
    held = tuple(int(np.count_nonzero(np.abs(Wp) > fem_box.ZERO_SHARE * np.abs(Wp).max()))
                 for Wp in W)
    assert problem.nnz_parts == held


def test_3d_hat_transfer_by_hand():
    from vbicm_tpu_torch.ops.multigrid import hat_matrix

    # (nz_c, ny_c, nx_c) = (1, 1, 2) at ratio 2: fine 3 x 3 x 5, coarse 2 x 2 x 3
    # nodes, 3 dofs; weights 4 (z), 4 (y), 7 (x), each the port's hat matrix's;
    # cheapest order x, then y (or z), then the last:
    # 7 * 3 * 3 + 4 * 3 * 3 + 4 * 2 * 3 = 123 multiply-adds a dof
    assert [np.count_nonzero(hat_matrix(n * 2 + 1, n + 1, 2)) for n in (1, 1, 2)] == [4, 4, 7]
    w = work.hat_transfer(2, 1, (1, 1, 2), 2, 8, ndof_node=3)
    assert (w.nbytes, w.flops, w.unit) == ((2 * 3 * (45 + 12) + 15) * 8, 2 * 2 * 3 * 123,
                                           "fp64_tc")


def test_box_geometry_is_the_ports():
    """The counted grid of the box at 32x8x8 and 6x4x2: fine dofs, coarse
    cells and free coarse dofs (the spectral coarse solve's n) as the port's
    models have them, and the nonzeros at 32x8x8."""
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model

    from portbench.harness import runners
    from portbench.reference import fem_box

    for mesh in ({"nx": 32, "ny": 8, "nz": 8}, {"nx": 6, "ny": 4, "nz": 2}):
        cfg = _box_config(mesh)
        problem = fem_box.build_problem(cfg, "cpu")
        g = runners._geometry(cfg, problem)
        r = cfg["solver"]["coarse_ratio"]
        cells = (mesh["nx"], mesh["ny"], mesh["nz"])
        fine = build_fem_model(beam_hex8_mesh(*cells), SectionCard(stype=4), device="cpu",
                               dense=False)
        coarse = build_fem_model(beam_hex8_mesh(*(n // r for n in cells)),
                                 SectionCard(stype=4), device="cpu", dense=False)
        assert (g.ndof, g.n_coarse, g.ndof_node, g.ratio) == (fine.ndof, coarse.nfree, 3, r)
        assert g.cells_c == tuple(n // r for n in cells[::-1])
        assert g.nnz_parts == problem.nnz_parts
    assert (g.ndof, g.n_coarse) == (315, 3 * 4 * 3 * 2 - 3 * 3 * 2)
    cfg = _box_config({"nx": 32, "ny": 8, "nz": 8})
    g = runners._geometry(cfg, fem_box.build_problem(cfg, "cpu"))
    assert (g.ndof, g.n_coarse, g.cells_c, g.nnz) == (8019, 1200, (4, 4, 16), 727062)
