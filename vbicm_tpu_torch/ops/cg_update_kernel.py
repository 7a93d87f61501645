"""CG's vector updates a loop step: the CUDA kernel pair's wrapper and the
plain PyTorch version (the loop of ``ops.solve.pcg``).

A step of the batched preconditioned CG is ``kp = matvec(p)``, the alpha
step, ``z = prec(r)``, the beta step. Per lane (one right-hand side), on the
lanes the previous step left active (``active = ~(rr <= thresh) & ~dead``,
so a NaN residual stays active):

- alpha step: ``denom = p.kp``, ``bad = ~(denom > 0)``, ``alpha = 0 if bad
  else rz / denom``, ``x += alpha p``, ``r_n = r - alpha kp``;
- beta step: ``rz_n = r_n.z``, ``dead_n = dead | bad | ~(rz_n > 0)``,
  ``beta = 0 if dead_n else rz_n / rz``, ``p = z + beta p``, ``r = r_n``,
  ``rz = rz_n`` unless ``dead_n``, ``rr = r.r``, ``it += 1``, ``dead =
  dead_n``, and the next step's ``active``.

A breakdown freezes its lane for good; converged and frozen lanes keep
their state.

:class:`CgUpdatePlain` runs the plain version, the loop's PyTorch ops as
they were (:func:`cg_update_reference_alpha`,
:func:`cg_update_reference_beta`); ``pcg`` takes it on CPU tensors.
:class:`CgUpdateKernel` launches ``cg_alpha_step_kernel`` and
``cg_beta_step_kernel`` (``csrc/cg_update.cu``), two launches a loop step in
place of ~37, the state updated in place on the device; ``pcg`` takes it on
CUDA tensors. It writes r in place on the active lanes alone, so the
preconditioner sees a frozen lane's old residual where the plain version
hands it that lane's throwaway ``r_n``: every use of it is masked by
``active``, so nothing changes. Counter (``utils.trace.count``):
``cg_update.launches``, one a launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from ..utils.trace import count

THREADS = 256  # a block's threads (csrc/cg_update.cu, kThreads)
PAIRS = 8  # pairs of values a thread holds in registers (kPairs)
# blocks a lane at most; above 8 a non-portable cluster size. The plan holds
# slices in registers up to this: on the H100 held slices beat streamed ones
# and a block a lane at the lane lengths of the cells, the 3-D boxes and the
# field grid (PERF.md)
MAX_CLUSTER = 16


def dot(a, b):
    """Per-lane dot products of (B, n) tensors."""
    return torch.einsum("bi,bi->b", a, b)


def cg_update_reference_alpha(x, r, p, kp, rz, active):
    """The alpha step's plain version: x += alpha p on the active lanes, in
    place. Returns (r_n, bad): every lane's new residual ``r - alpha kp``
    and the breakdown flags."""
    denom = dot(p, kp)
    bad = ~(denom > 0)  # catches <= 0 and NaN
    alpha = torch.where(bad, 0.0, rz / torch.where(denom == 0, 1.0, denom))
    # the state is updated in place, and only on active lanes
    torch.where(active[:, None], x + alpha[:, None] * p, x, out=x)
    return r - alpha[:, None] * kp, bad


def cg_update_reference_beta(r, p, r_n, z, rz, it, dead, active, bad, thresh):
    """The beta step's plain version, z = prec(r_n): p and r on the active
    lanes and ``it`` in place. Returns the new (rz, rr, dead, active)."""
    rz_n = dot(r_n, z)
    dead_n = dead | (active & (bad | ~(rz_n > 0)))
    beta = torch.where(dead_n, 0.0, rz_n / torch.where(rz == 0, 1.0, rz))
    a = active[:, None]
    torch.where(a, z + beta[:, None] * p, p, out=p)
    torch.where(a, r_n, r, out=r)
    rz = torch.where(active & ~dead_n, rz_n, rz)
    rr = dot(r, r)
    it += active
    dead = torch.where(active, dead_n, dead)
    return rz, rr, dead, ~(rr <= thresh) & ~dead  # a NaN residual stays active


class CgUpdatePlain:
    """The loop's state and its two steps in plain PyTorch, on any device:
    x, r, p (B, n) and ``it`` in place; rz, rr, dead and ``active`` anew
    each step."""

    def __init__(self, x, r, p, rz, rr, thresh, it, dead):
        self.x, self.r, self.p, self.rz, self.rr = x, r, p, rz, rr
        self.thresh, self.it, self.dead = thresh, it, dead
        self.active = ~(rr <= thresh) & ~dead

    def alpha(self, kp):
        """The alpha step after ``kp = matvec(p)``; returns the residual to
        precondition."""
        self._r_n, self._bad = cg_update_reference_alpha(self.x, self.r, self.p, kp, self.rz,
                                                         self.active)
        return self._r_n

    def beta(self, z):
        """The beta step after ``z = prec(r_n)``."""
        self.rz, self.rr, self.dead, self.active = cg_update_reference_beta(
            self.r, self.p, self._r_n, z, self.rz, self.it, self.dead, self.active, self._bad,
            self.thresh)


@dataclasses.dataclass(frozen=True)
class CgPlan:
    """A lane's launch: ``cluster`` blocks of ``THREADS`` threads, each
    taking a contiguous slice of ``slice`` values (even; the last block the
    rest, an empty one past n) in register tiles of ``PAIRS`` pairs a
    thread, ``tiles`` of them (1: held in registers and read once; more:
    read twice)."""

    cluster: int
    slice: int
    tiles: int


@functools.lru_cache(maxsize=None)
def launch_plan(n: int) -> CgPlan:
    """The launch of lanes of n values, either dtype: the fewest blocks a
    lane that hold its slices in registers, at most ``MAX_CLUSTER`` (a
    longer lane streams its slices). The plan depends on n alone, so a
    lane's bits do not depend on the batch. Raises ``ValueError`` on what
    the kernels do not take."""
    if n < 1 or n > 2 ** 30:
        raise ValueError(f"cg_update: n={n}; the kernels take 1 <= n <= 2**30")
    pairs = -(-n // 2)
    cluster = min(MAX_CLUSTER, -(-pairs // (THREADS * PAIRS)))
    per_block = -(-pairs // cluster)
    return CgPlan(cluster, 2 * per_block, -(-per_block // (THREADS * PAIRS)))


class _CgHost(ctypes.Structure):
    """A loop's state for the C entry points (csrc/cg_update.cu, CgHost)."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("x", "r", "p", "rz", "rr", "thresh", "it", "dead", "active", "bad", "part")] + \
               [(name, ctypes.c_int) for name in ("lanes", "n", "cluster", "slice")]


class CgUpdateKernel:
    """The loop's state on a CUDA device and its two steps as one kernel
    launch each (``csrc/cg_update.cu``): x, r, p (B, n) float32 or float64,
    rz, rr, thresh (B,) of their type, ``it`` (B,) int64 and dead (B,) bool,
    all contiguous on one device, updated in place. The state is checked
    here, once; each step checks only its new input (kp, z); the launch is
    :func:`launch_plan`'s."""

    def __init__(self, x, r, p, rz, rr, thresh, it, dead):
        dtype, device = x.dtype, x.device
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"cg_update: dtype {dtype}; the kernels take float32 or float64")
        if x.ndim != 2:
            raise ValueError(f"cg_update: x {tuple(x.shape)}; expected (B, n)")
        B, n = x.shape
        want = {"x": (x, (B, n), dtype), "r": (r, (B, n), dtype), "p": (p, (B, n), dtype),
                "rz": (rz, (B,), dtype), "rr": (rr, (B,), dtype),
                "thresh": (thresh, (B,), dtype), "it": (it, (B,), torch.int64),
                "dead": (dead, (B,), torch.bool)}
        for name, (t, shape, dt) in want.items():
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"cg_update: {name} {tuple(t.shape)} {t.dtype}; expected "
                                 f"{shape} {dt}")
        _build.check_operands("cg_update", tuple(want), tuple(t for t, _, _ in want.values()))
        self.plan = launch_plan(n)
        self.x, self.r, self.p, self.rz, self.rr = x, r, p, rz, rr
        self.thresh, self.it, self.dead = thresh, it, dead
        self.active = ~(rr <= thresh) & ~dead
        self.bad = torch.zeros(B, dtype=torch.bool, device=device)
        self.part = torch.zeros((B, self.plan.cluster), dtype=dtype, device=device)
        self._alpha = _build.entry("cg_alpha_step", dtype)
        self._beta = _build.entry("cg_beta_step", dtype)
        self._host = _CgHost(*(t.data_ptr() for t in (x, r, p, rz, rr, thresh, it, dead,
                                                      self.active, self.bad, self.part)),
                             B, n, self.plan.cluster, self.plan.slice)
        self._addr = ctypes.addressof(self._host)
        self._shape, self._dtype, self._index = x.shape, dtype, device.index
        # pairs load as one 2-value load where every row is aligned to it
        self._align = 2 * x.element_size()
        self._vec = n % 2 == 0 and all(t.data_ptr() % self._align == 0 for t in (x, r, p))
        self._stream = torch._C._cuda_getCurrentRawStream

    def _launch(self, fn, v, name):
        if (v.shape != self._shape or v.dtype != self._dtype or not v.is_contiguous()
                or v.get_device() != self._index):
            raise ValueError(f"cg_update: {name} {tuple(v.shape)} {v.dtype} on {v.device}; "
                             f"expected a contiguous {tuple(self._shape)} {self._dtype} on "
                             f"cuda:{self._index}")
        ptr = v.data_ptr()
        err = fn(self._addr, ptr, self._vec and ptr % self._align == 0,
                 self._stream(self._index))
        if err != 0:
            raise RuntimeError(f"cg_{name} step kernel launch failed with CUDA error {err} "
                               f"({tuple(self._shape)}, {self._dtype}, {self.plan})")
        count("cg_update.launches")

    def alpha(self, kp):
        """The alpha step after ``kp = matvec(p)``; returns r, updated in
        place, to precondition."""
        self._launch(self._alpha, kp, "alpha")
        return self.r

    def beta(self, z):
        """The beta step after ``z = prec(r)``."""
        self._launch(self._beta, z, "beta")


def kernel_fit(dtype, beta: bool, cluster: int):
    """(clusters resident at once, registers a thread, local-memory bytes a
    thread) of the alpha or beta kernel in ``dtype`` on the current device;
    None where it cannot launch that cluster."""
    return _build.kernel_fit(_build.entry("cg_fit", dtype), 3, int(beta), cluster)
