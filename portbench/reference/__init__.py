"""The plain reference the benchmark holds the port to: quad4 plane-strain
FEM of Cook's membrane (``fem``) and hex8 solid FEM of the 3-D cantilever
(``fem_box``) with float64 solves, and the step-1 VI update (``vi``), in
NumPy, SciPy and plain PyTorch. It imports nothing of ``vbicm_tpu_torch``
and takes nothing the port made: it builds its own mesh, stiffness and
solver from the configuration file."""
