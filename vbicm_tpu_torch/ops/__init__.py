from . import element, quadrature, solve, spectral_kernel, vonmises

__all__ = ["element", "quadrature", "solve", "spectral_kernel", "vonmises"]
