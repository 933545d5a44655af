"""Analysis of the port: analytic model math (`model_math`, a copy of the
JAX package's) and the per-device counts of a traced step (`trace`, the
counterpart of `repro/analysis/hlo.py`)."""
