"""Data-parallel process groups (JAX twin: idvs/morec_tpu/parallel/)."""
