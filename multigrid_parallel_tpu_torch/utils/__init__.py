"""Helpers around the solver (state conversion to and from the JAX
package's layout)."""
