"""vbicm_tpu_torch — the PyTorch and CUDA port of ``vbicm_tpu``.

Same module paths and public names as the JAX package, which stays the
reference this package is tested against. It imports torch, numpy and
scipy, never JAX.

Idiom: every function that makes tensors takes an explicit ``device=``;
random draws come from explicit ``torch.Generator``s; dtypes are explicit
(the reference runs float64, torch defaults to float32); ``jax.vmap``
becomes a batch dimension written out; ``jax.custom_vjp`` becomes
``torch.autograd.Function``. The
batched spectral solve runs through a hand-written CUDA kernel
(``csrc/spectral_apply.cu``) on the GPU.

Precision: float32 matrix products and convolutions run in full float32, not
TF32, so that the float32 apply plus one float64 refinement keeps the
accuracy the JAX package's policy assumes. The two switches below are
PyTorch's process-wide settings and are set on import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from . import config  # noqa: E402
from .config import MaterialCard, ProblemConfig, SectionCard, TrainConfig  # noqa: E402
from .model import FemModel, build_fem_model  # noqa: E402
from .solver import FemSolution, fea_solution, make_fh_fun  # noqa: E402

__all__ = [
    "config",
    "MaterialCard",
    "SectionCard",
    "ProblemConfig",
    "TrainConfig",
    "FemModel",
    "build_fem_model",
    "FemSolution",
    "fea_solution",
    "make_fh_fun",
]
