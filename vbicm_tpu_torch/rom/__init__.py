from .reduced_basis import (
    ReducedBasis,
    build_reduced_basis,
    make_fh_fun_rom,
    reduced_solve,
    residual_norm,
)

__all__ = ["ReducedBasis", "build_reduced_basis", "make_fh_fun_rom", "reduced_solve",
           "residual_norm"]
