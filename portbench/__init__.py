"""The benchmark of ``vbicm_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell once and prints the result line; everything a
cell needs is found by name under this folder (``harness/manifest.py``).
Nothing here imports JAX or the JAX package ``vbicm_tpu``; ``reference/``
and ``count/`` import nothing of ``vbicm_tpu_torch`` either.
"""
