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
