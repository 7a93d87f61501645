"""The kernel wrappers' one launch path (``vbicm_tpu_torch._build``) on the
CPU: the operand check every wrapper runs before a launch raises the errors
the wrappers raise, and ``launch`` passes the current stream, counts the call
in ``utils.trace`` and raises with the wrapper's account on a CUDA error."""
import pytest
import torch

from vbicm_tpu_torch import _build
from vbicm_tpu_torch.utils import trace


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("tensors,floats,align,error,match", [
    ((torch.zeros(3, 8), torch.zeros(3, 8)), 2, (), ValueError, "CUDA device"),
    ((torch.zeros(3, 8), _meta((3, 8))), 2, (), ValueError, "CUDA device"),
    ((_meta((3, 8)), _meta((3, 8), torch.float64)), 2, (), TypeError, "float32"),
    ((_meta((3, 8), torch.int32), _meta((3, 8), torch.int32)), 2, (), TypeError, "float32"),
    ((_meta((3, 8)), _meta((8, 3)).T), 2, (), ValueError, "b must be contiguous"),
    ((_meta((3, 8)), _meta(25)[1:].view(3, 8)), 2, (0, 8), ValueError,
     "b must be 8-byte aligned"),
], ids=["cpu", "two-devices", "mixed-dtype", "int-dtype", "noncontiguous", "misaligned"])
def test_operand_check_raises_the_wrappers_errors(tensors, floats, align, error, match):
    with pytest.raises(error, match=match):
        _build.check_operands("wrapper", ("a", "b"), tensors, floats=floats, align=align)


def test_launch_passes_the_stream_counts_and_raises_with_the_account(monkeypatch):
    """A stand-in entry point on device 0, the current one: the call gets
    the arguments and the current stream; a nonzero CUDA error raises with
    the wrapper's account and counts nothing."""
    calls, errs = [], [0, 700]
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(_build, "entry", lambda name, kind: (
        lambda *a: calls.append((name, kind, a)) or errs.pop(0)))
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1234 + index,
                        raising=False)
    dev = torch.device("cuda", 0)
    before = trace.counters()
    _build.launch("fake_kernel", torch.float32, dev, (1, 2), lambda: "(B=1)", "fake_family")
    assert calls == [("fake_kernel", torch.float32, (1, 2, 1234))]
    after = trace.counters()
    assert after.get("fake_family.launches", 0) - before.get("fake_family.launches", 0) == 1
    with pytest.raises(RuntimeError, match=r"fake_kernel kernel launch failed with CUDA error "
                                           r"700 \(B=1\)"):
        _build.launch("fake_kernel", torch.float32, dev, (1, 2), lambda: "(B=1)", "fake_family")
    assert trace.counters().get("fake_family.launches", 0) == after["fake_family.launches"]
