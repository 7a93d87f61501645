"""The port's banded tensor-core stencil (table packing, windows and
bfloat16 splits, plain version, the wrapper on the CPU) against the JAX
package's ``ops/stencil_mxu.py``.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py. 12x6 has one
128-lane tile a row (2NX = 26); 64x4 has two (2NX = 130), so the tile seam
is crossed. Inputs are made with numpy from fixed seeds. The band rule
(``band_ksteps``: which k-step blocks of a table can be nonzero) is checked
on both packages' tables: the kernel multiplies and reads only those blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.stencil import build_stencil_tables as jax_build_stencil_tables
from vbicm_tpu.ops.stencil import make_stencil_part_matvec as jax_make_stencil_part_matvec
from vbicm_tpu.ops.stencil_mxu import KDIM as JAX_KDIM
from vbicm_tpu.ops.stencil_mxu import LPAD as JAX_LPAD
from vbicm_tpu.ops.stencil_mxu import WIN as JAX_WIN
from vbicm_tpu.ops.stencil_mxu import pack_w_bands as jax_pack_w_bands
from vbicm_tpu.ops.stencil_mxu import stencil_affine_matvec_mxu as jax_stencil_affine_matvec_mxu
from vbicm_tpu_torch.ops.stencil_mxu import (
    KDIM,
    KSTEP,
    LPAD,
    MODES,
    WIN,
    band_flops,
    band_ksteps,
    band_table_bytes,
    band_windows,
    check_launch_rules,
    n_tiles,
    pack_w_bands,
    split_bf16,
    stencil_affine_matvec_mxu,
    stencil_affine_mxu_reference,
)
from vbicm_tpu_torch.utils import trace

GRIDS = [(12, 6), (64, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grid(request):
    """(nx, ny, JAX matrix-free model, its float64 stencil tables W)."""
    nx, ny = request.param
    model = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    return nx, ny, model, jax_build_stencil_tables(model, nx, ny)


def _inputs(B, ndof, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5.0, 15.0, (B, 2)).astype(np.float32),
            rng.standard_normal((B, ndof)).astype(np.float32))


def _bits(x):
    """bfloat16 tensor or array -> uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _exact(model, W, nx, ny, coeffs, u):
    """c0 K_lam u + c1 K_mu u in float64 through JAX's part matvec."""
    pm, _ = jax_make_stencil_part_matvec(model, nx, ny, W=W)
    ju = jnp.asarray(u, jnp.float64)
    return sum(coeffs[:, p:p + 1].astype(np.float64) * np.asarray(jax.vmap(lambda v: pm(p, v))(ju))
               for p in range(2))


def test_constants_are_jax_constants():
    assert (LPAD, WIN, KDIM) == (JAX_LPAD, JAX_WIN, JAX_KDIM) == (8, 136, 416)
    assert [n_tiles(nx + 1) for nx, _ in GRIDS] == [1, 2]


def test_pack_w_bands_bit_identical_to_jax(grid):
    nx, ny, _, W = grid
    f32 = pack_w_bands(W, "f32")
    assert f32.dtype == torch.float32 and f32.shape == ((ny + 1) * n_tiles(nx + 1) * KDIM, 256)
    np.testing.assert_array_equal(f32.numpy(), np.asarray(jax_pack_w_bands(W, "f32")))
    hi, lo = pack_w_bands(W, "bf16x3")
    jhi, jlo = jax_pack_w_bands(W, "bf16x3")
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), _bits(jhi))
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    assert lo.any()  # the low half carries bits: the table is not bfloat16-exact


def test_windows_and_splits_bit_identical_to_jax(grid):
    """The port's (B, KDIM) operands and their bfloat16 splits are the JAX
    kernel's: its padding and window slices (``stencil_affine_matvec_mxu``
    and ``_row_kernel_bf16x3``) in jnp, then ``astype``."""
    nx, ny, model, _ = grid
    NY, NX = ny + 1, nx + 1
    NX2, T = 2 * NX, n_tiles(NX)
    _, u = _inputs(3, model.ndof, seed=nx)
    XL = -(-(JAX_LPAD + T * 128) // 128) * 128
    g = jnp.asarray(u).reshape(3, NY, NX2)
    upad = jnp.pad(g, ((0, 0), (1, 1), (JAX_LPAD, XL - NX2 - JAX_LPAD)))
    zpad = jnp.zeros((3, 8), jnp.float32)
    want = np.stack([np.asarray(jnp.concatenate(
        [upad[:, y + dy, JAX_LPAD - 3 + t * 128:JAX_LPAD - 3 + t * 128 + JAX_WIN]
         for dy in range(3)] + [zpad], axis=1)) for y in range(NY) for t in range(T)])
    uw = band_windows(torch.as_tensor(u), NY, NX)
    assert uw.shape == (NY * T, 3, KDIM)
    np.testing.assert_array_equal(uw.numpy(), want)
    uh, ul = split_bf16(uw)
    jw = jnp.asarray(want)
    juh = jw.astype(jnp.bfloat16)
    jul = (jw - juh.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(uh), _bits(juh))
    np.testing.assert_array_equal(_bits(ul), _bits(jul))


@pytest.mark.parametrize("mode", MODES)
def test_plain_banded_matches_jax_interpret_and_the_exact_operator(grid, mode):
    nx, ny, model, W = grid
    NY, NX = ny + 1, nx + 1
    coeffs, u = _inputs(4, model.ndof, seed=nx + 1)
    jm = jax_pack_w_bands(W, mode)
    want = np.asarray(jax_stencil_affine_matvec_mxu(jm, jnp.asarray(coeffs), jnp.asarray(u),
                                                    NY=NY, NX=NX, interpret=True, mode=mode))
    q = stencil_affine_mxu_reference(pack_w_bands(W, mode), torch.as_tensor(coeffs),
                                     torch.as_tensor(u), NY, NX, mode).numpy()
    exact = _exact(model, W, nx, ny, coeffs, u)
    scale = np.abs(exact).max()
    # the same products summed in float32 in another order: 1e-6 of max|q|
    # (1.5e-7 measured)
    assert np.abs(q - want).max() <= 1e-6 * scale
    # tests/test_pallas.py's bounds against the exact operator
    assert np.abs(q - exact).max() <= {"f32": 5e-6, "bf16x3": 5e-5}[mode] * scale


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    nx, ny = 12, 6
    W = jax_build_stencil_tables(jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False), nx, ny)
    coeffs, u = (torch.as_tensor(a) for a in _inputs(2, 2 * (nx + 1) * (ny + 1), seed=5))
    before = trace.counters().get("stencil_mxu.launches", 0)
    for mode in MODES:
        mb = pack_w_bands(W, mode)
        q = stencil_affine_matvec_mxu(mb, coeffs, u, ny + 1, nx + 1, mode)
        assert torch.equal(q, stencil_affine_mxu_reference(mb, coeffs, u, ny + 1, nx + 1, mode))
    assert trace.counters().get("stencil_mxu.launches", 0) == before


def test_wrapper_and_packing_refuse_bad_input():
    rows = 5 * KDIM
    m = torch.empty((rows, 256), device="meta")
    c, u = torch.empty((3, 2), device="meta"), torch.empty((3, 5 * 18), device="meta")
    before = trace.counters().get("stencil_mxu.launches", 0)
    with pytest.raises(ValueError):
        stencil_affine_matvec_mxu(m, c, u, 5, 9, "f32")
    with pytest.raises(ValueError):
        stencil_affine_matvec_mxu(m, c, u, 5, 9, "bf16")
    with pytest.raises(ValueError):
        pack_w_bands(np.zeros((3, 2, 2, 3, 3, 2, 2)), "f32")
    with pytest.raises(ValueError):
        pack_w_bands(np.zeros((2, 2, 2, 3, 3, 2, 2)), "f16")
    assert trace.counters().get("stencil_mxu.launches", 0) == before


# the band rule's grids: T = 1 with 2NX = 18 and 26 lanes, 2NX = 128 (one full
# tile), 2NX = 130 (T = 2, 2 lanes in the last tile)
BAND_GRIDS = [(8, 4), (12, 6), (63, 4), (64, 4)]


def _band_mask(NY, NX, kstep):
    """(NY*T*KDIM, 256) bool: True on the blocks band_ksteps lists."""
    T = n_tiles(NX)
    mask = np.zeros((T, KDIM, 256), bool)
    for t in range(T):
        for n0 in range(0, 128, 8):
            for ks in sum(band_ksteps(NX, t, n0, kstep), ()):
                for p in range(2):
                    mask[t, ks * kstep:(ks + 1) * kstep, p * 128 + n0:p * 128 + n0 + 8] = True
    return np.broadcast_to(mask, (NY, T, KDIM, 256)).reshape(NY * T * KDIM, 256)


@pytest.mark.parametrize("kstep", sorted(KSTEP.values()))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nxy", BAND_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_tables_are_zero_outside_the_band_blocks(nxy, mode, kstep):
    """Both packages' packed tables (every bfloat16 half) hold no nonzero
    outside the blocks band_ksteps lists, at either k-step size: the
    kernel's skip of the other blocks is exact."""
    nx, ny = nxy
    W = jax_build_stencil_tables(jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False), nx, ny)
    outside = ~_band_mask(ny + 1, nx + 1, kstep)
    port = pack_w_bands(W, mode)
    jax_tables = jax_pack_w_bands(W, mode)
    if mode == "f32":
        port, jax_tables = (port,), (jax_tables,)
    for table in (*port, *jax_tables):
        values = (table.to(torch.float32).numpy() if isinstance(table, torch.Tensor)
                  else np.asarray(table).astype(np.float32))
        assert values.any()
        assert not values[outside].any()


@pytest.mark.parametrize("nxy", BAND_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_a_rows_outside_a_slices_band_meet_only_zeros(nxy):
    """For each 32-lane slice (lanes col0 .. col0 + 31 of a tile, both column
    halves), the table rows other than w = col0 .. col0 + 37 of each window
    (row dy*WIN + w) are zero in the slice's columns: the kernel stages u
    only for those rows and reads zeros for the others, which changes no
    product. Both packages' tables, every bfloat16 half."""
    nx, ny = nxy
    NY, NX = ny + 1, nx + 1
    W = jax_build_stencil_tables(jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False), nx, ny)
    port = pack_w_bands(W, "bf16x3")
    tables = [*port, pack_w_bands(W, "f32"), *jax_pack_w_bands(W, "bf16x3"),
              jax_pack_w_bands(W, "f32")]
    T = n_tiles(NX)
    rows = np.arange(KDIM)
    for table in tables:
        values = (table.to(torch.float32).numpy() if isinstance(table, torch.Tensor)
                  else np.asarray(table).astype(np.float32)).reshape(NY, T, KDIM, 256)
        for col0 in range(0, 128, 32):
            w = rows - (rows // WIN) * WIN
            band = (rows < 3 * WIN) & (w >= col0) & (w <= col0 + 37)
            cols = np.r_[col0:col0 + 32, 128 + col0:128 + col0 + 32]
            assert not values[:, :, ~band][..., cols].any()


@pytest.mark.parametrize("NX", [5, 13, 64, 65, 161, 200])
def test_band_ksteps_per_window_and_past_the_grid(NX):
    """At most 2 k-steps a window in BF16 (16 rows) and 3 in TF32 (8 rows),
    ascending and inside the table; none for an n-tile past 2NX; each inside
    the slice union the kernel stages (3 BF16 or 5 TF32 k-steps a window
    from (dy*WIN + s*32) // kstep for the 32-lane slice s), 18 BF16 and 24
    TF32 blocks a column half of a full slice."""
    for kstep, most, union in ((16, 2, 3), (8, 3, 5)):
        for t in range(n_tiles(NX) + 1):
            for s in range(4):
                blocks = 0
                for j in range(4):
                    n0 = 32 * s + 8 * j
                    lists = band_ksteps(NX, t, n0, kstep)
                    if t * 128 + n0 >= 2 * NX:
                        assert lists == ((), (), ())
                        continue
                    for dy, ks in enumerate(lists):
                        first = (dy * WIN + 32 * s) // kstep
                        assert 1 <= len(ks) <= most and list(ks) == sorted(ks)
                        assert first <= ks[0] and ks[-1] < first + union
                        assert ks[-1] < KDIM // kstep
                        blocks += len(ks)
                if t * 128 + 32 * s + 31 < 2 * NX:
                    assert blocks == {16: 18, 8: 24}[kstep]
    with pytest.raises(ValueError):
        band_ksteps(NX, 0, 4, 16)
    with pytest.raises(ValueError):
        band_ksteps(NX, 0, 8, 32)


def test_band_counts_bytes_and_flops_at_160x80():
    """The study's shape (NY = 81, 2NX = 322, T = 3): 366 of 2,496 BF16 and
    486 of 4,992 TF32 (k-step, n-tile) blocks a grid row are band blocks;
    their bytes at 32-byte sectors and the kernel's MMA flops at B = 256."""
    NY, NX = 81, 161
    for mode, blocks, dense in (("bf16x3", 366, 2496), ("f32", 486, 4992)):
        step = KSTEP[mode]
        n = 2 * sum(len(sum(band_ksteps(NX, t, n0, step), ()))
                    for t in range(3) for n0 in range(0, 128, 8))
        assert (n, 3 * 32 * KDIM // step) == (blocks, dense)
        assert band_flops(256, NY, NX, mode) == 3 * 2.0 * 256 * step * 8 * blocks * NY
    assert band_table_bytes(NY, NX, "bf16x3") == 20_404_224
    assert band_table_bytes(NY, NX, "f32") == 10_077_696


def _launch_case(mode, NY=5, NX=9, B=3):
    """Aligned tables, coeffs and u for the launch-rule checks, on the CPU."""
    rows = NY * n_tiles(NX) * KDIM
    dt = torch.bfloat16 if mode == "bf16x3" else torch.float32
    tables = tuple(torch.zeros((rows, 256), dtype=dt) for _ in range(2 if mode == "bf16x3" else 1))
    return tables, torch.zeros((B, 2)), torch.zeros((B, NY * 2 * NX))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rule", ["u", "coeffs", "table", "grid"])
def test_launch_rules_raise_naming_the_rule(mode, rule):
    """The launcher refuses misaligned tables (16 bytes), coeffs and u (8
    bytes) and grids past 65535 blocks with a CUDA error; the wrapper's
    check raises a ValueError that names the rule first. Offset views of
    CPU tensors stand in for the card's; the grid rule is checked with
    NY * ceil(2NX / 32) arithmetic on a small case."""
    tables, coeffs, u = _launch_case(mode)
    NY, NX = 5, 9
    check_launch_rules(tables, coeffs, u, NY, NX)  # the aligned case passes
    if rule == "u":
        u = torch.zeros(u.numel() + 1)[1:].view(u.shape)
        match = "u must start on an 8-byte boundary"
    elif rule == "coeffs":
        coeffs = torch.zeros(coeffs.numel() + 1)[1:].view(coeffs.shape)
        match = "coeffs must start on an 8-byte boundary"
    elif rule == "table":
        t = tables[-1]
        # two values on: 4 bytes (bfloat16) or 8 (float32) past the boundary
        shifted = torch.zeros(t.numel() + 2, dtype=t.dtype)[2:].view(t.shape)
        tables = (*tables[:-1], shifted)
        match = f"table {len(tables) - 1} must start on a 16-byte boundary"
    else:
        # 2NX = 2 * 1024 lanes: 64 slices a row, 1024 rows -> 65,536 blocks
        NY, NX = 1024, 1024
        match = "65536 blocks exceeds CUDA's 65535"
    assert u.is_contiguous() and coeffs.is_contiguous() and all(t.is_contiguous() for t in tables)
    with pytest.raises(ValueError, match=match):
        check_launch_rules(tables, coeffs, u, NY, NX)
    # one block fewer is within the limit
    if rule == "grid":
        check_launch_rules(*_launch_case(mode), 1023, 1024)
