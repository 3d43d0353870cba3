"""Telemetry: trajectory plots of warm starts, the training set's analysis
and the training-loss plots (the port's twins of the JAX package's root
``telemetry/`` scripts).  matplotlib is imported only where a figure is
drawn; without it the numbers are still computed and one line says the
figures were skipped."""
