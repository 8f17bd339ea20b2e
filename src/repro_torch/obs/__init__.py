"""Observability: copies of the JAX package's ``repro.obs.trace``,
``repro.obs.metrics``, ``repro.obs.log`` and ``repro.obs.perfetto``, kept
here so the port loads no module of that package."""
