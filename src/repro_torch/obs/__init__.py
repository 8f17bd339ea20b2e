"""Observability: copies of the JAX package's ``repro.obs.trace`` and
``repro.obs.metrics``, kept here so the port loads no module of that
package."""
