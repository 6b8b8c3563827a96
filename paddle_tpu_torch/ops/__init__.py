"""Op functions of the port, called like their JAX twins: fn(attrs, ins)."""
