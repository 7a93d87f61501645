"""The harness: discovery by name (``manifest``), the run's environment
(``env``), the port's objects built from a configuration (``system``), the
cells' windows and checks (``runners``) and the reduction of a profiler
trace (``trace``)."""
