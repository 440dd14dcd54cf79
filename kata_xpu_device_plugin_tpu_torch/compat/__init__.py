"""Runtime contracts of the port (counterpart of the JAX package's
``compat``): strict mode and the steady-state tripwire
(:mod:`.torchapi`)."""
