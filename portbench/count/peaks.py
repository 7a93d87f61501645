"""Data-sheet peaks of the card, keyed on ``torch.cuda.get_device_name``.

NVIDIA H100 SXM (the "80GB HBM3" part), dense rates without sparsity, at
its 700 W limit: HBM 3.35 TB/s; CUDA cores 67 TFLOP/s in FP32 and 34 in
FP64; tensor cores 494.7 TFLOP/s in TF32 and 67 in FP64. A float32 matrix
product at float32 accuracy on the tensor cores takes three TF32 products
(3xTF32), so its rate is a third of TF32's: ``tf32x3_tc``. A card set below
700 W runs below these; the benchmark prints the limit beside its shares.
There is no entry for a CPU: a share is only ever a device number.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32": 67e12,
        "fp64": 34e12,
        "tf32x3_tc": 494.7e12 / 3,
        "fp64_tc": 67e12,
    },
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the named card; ``KeyError`` for a card with no entry,
    since a wrong peak would make every share wrong."""
    for key, peaks in PEAKS.items():
        if device_name.startswith(key):
            return peaks
    raise KeyError(f"no data-sheet peaks for {device_name!r}; known: {sorted(PEAKS)}")
