"""mira_tpu: Mira's folding schemes, IVC driver and decider in JAX (see
SURVEY.md).  routes.py says which implementation each operation takes on
each platform."""
