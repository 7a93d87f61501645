"""Evaluation (counterpart of ``vbicm_tpu/eval``): MCMC and HMC reference
posteriors, MAP + Laplace, densities and KLD, the proposed-vs-classical
comparison, and the analytic cases' quadrature references. The XDMF export
is not ported yet (ROADMAP Queue 1 item 10)."""
from .laplace import LaplaceResult, laplace_posterior
from .mcmc import MetropolisResult, hmc, make_fem_logpost, metropolis, posterior_predictive_z
from .postprocess import (
    gaussian_kde_pdf,
    kld_gaussian_kde,
    lognormal_pdf_2d,
    plot_deformed_mesh,
)

__all__ = [
    "LaplaceResult",
    "laplace_posterior",
    "MetropolisResult",
    "hmc",
    "make_fem_logpost",
    "metropolis",
    "posterior_predictive_z",
    "gaussian_kde_pdf",
    "kld_gaussian_kde",
    "lognormal_pdf_2d",
    "plot_deformed_mesh",
]
