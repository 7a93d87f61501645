"""Evaluation and postprocessing: densities, KLD, mesh plots (counterpart of
``vbicm_tpu/eval/postprocess.py``).

The quantitative pieces work on numpy arrays on the host, as in the JAX
package: a Gaussian KDE with scipy's defaults, the lognormal VI predictive
density, KL(MCMC || VI) between them, and 1-D densities. The plots import
matplotlib inside the function. Comparisons are against real MCMC samples,
never against scaled VI output.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def gaussian_kde_pdf(samples: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Gaussian KDE (Scott's rule), scipy.stats.gaussian_kde's defaults.

    samples: (n, d); points: (m, d). Returns (m,).
    """
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(samples.T)
    return kde(points.T)


def lognormal_pdf_2d(z_points: np.ndarray, logz_mean, logz_sig) -> np.ndarray:
    """VI predictive density: an independent lognormal in each dimension,
    ``logz_sig`` the log-z variances."""
    logz_mean = np.asarray(logz_mean).reshape(-1)
    logz_sig = np.asarray(logz_sig).reshape(-1)
    lz = np.log(z_points)
    quad = -0.5 * ((lz - logz_mean) ** 2 / logz_sig).sum(axis=-1)
    norm = np.sqrt((2 * np.pi) ** logz_mean.size * np.prod(logz_sig))
    return np.exp(quad) / norm / np.prod(z_points, axis=-1)


def kld_gaussian_kde(p_samples: np.ndarray, q_pdf, n_eval: int = 2000, seed: int = 0):
    """KL(p || q) estimated by evaluating log p (KDE) - log q at p-samples."""
    from scipy.stats import gaussian_kde

    rng = np.random.default_rng(seed)
    idx = rng.choice(p_samples.shape[0], size=min(n_eval, p_samples.shape[0]), replace=False)
    pts = p_samples[idx]
    kde = gaussian_kde(p_samples.T)
    logp = np.log(np.maximum(kde(pts.T), 1e-300))
    logq = np.log(np.maximum(q_pdf(pts), 1e-300))
    return float(np.mean(logp - logq))


def plot_deformed_mesh(model, u, *, mag: float = 1.0, path: Optional[str] = None,
                       show_initial: bool = True):
    """Initial and deformed 2-D mesh polygons for one displacement field u
    (ndof,). Returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection

    coords = model.coords.cpu().numpy()
    conn = model.conn.cpu().numpy()
    u = u.detach().cpu().numpy() if hasattr(u, "detach") else np.asarray(u)
    disp = u.reshape(-1, 2)
    fig, ax = plt.subplots(figsize=(6, 7))
    if show_initial:
        ax.add_collection(
            PolyCollection(coords[conn], facecolor="none", edgecolor="0.7", lw=0.5)
        )
    deformed = coords + mag * disp
    ax.add_collection(
        PolyCollection(deformed[conn], facecolor="none", edgecolor="tab:blue", lw=0.7)
    )
    ax.autoscale()
    ax.set_aspect("equal")
    ax.set_title(f"deformed shape (x{mag:g})")
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    return fig


def von_mises_field(model, sol, lam=None, mu=None) -> np.ndarray:
    """Element-average reference-convention von Mises over the mesh, from
    ``solver.fea_solution``'s stresses. Returns (nele,)."""
    from ..ops.vonmises import von_mises_reference

    vm = von_mises_reference(sol.stress)  # (nele, nqpt)
    return vm.mean(dim=1).cpu().numpy()


def lognormal_pdf_1d(z_points: np.ndarray, logz_mean: float, logz_sig: float) -> np.ndarray:
    """1-D lognormal predictive density (variance parameterization, as the
    step-2 nets output)."""
    z = np.asarray(z_points)
    return np.exp(-0.5 * (np.log(z) - logz_mean) ** 2 / logz_sig) / (
        z * np.sqrt(2 * np.pi * logz_sig)
    )


def normal_pdf_1d(x_points: np.ndarray, mean: float, var: float) -> np.ndarray:
    x = np.asarray(x_points)
    return np.exp(-0.5 * (x - mean) ** 2 / var) / np.sqrt(2 * np.pi * var)


def plot_pdf_comparison_1d(points: np.ndarray, curves, *, xlabel: str = "z",
                           path: Optional[str] = None, samples: Optional[np.ndarray] = None):
    """Overlay of named 1-D density curves ``{label: (m,) densities}`` on
    ``points``, with an optional sample histogram and its KDE. Returns the
    matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    if samples is not None:
        ax.hist(samples, bins=60, density=True, alpha=0.25, color="0.5", label="samples")
        kde = gaussian_kde_pdf(np.asarray(samples)[:, None], np.asarray(points)[:, None])
        ax.plot(points, kde, "k--", lw=1, label="sample KDE")
    for label, pdf in curves.items():
        ax.plot(points, pdf, lw=1.5, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("PDF")
    ax.legend()
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    return fig
