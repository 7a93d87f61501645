"""The plain reference the benchmark holds the port to: quad4 plane-strain
FEM with float64 solves (``fem``) and the step-1 VI update (``vi``), in
NumPy, SciPy and plain PyTorch. It imports nothing of ``vbicm_tpu_torch``
and takes nothing the port made: it builds its own mesh, stiffness and
solver from the configuration file."""
