"""Small host-side helpers copied from the JAX package."""
