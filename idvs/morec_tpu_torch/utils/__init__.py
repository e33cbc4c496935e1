"""Run logging (JAX twin: idvs/morec_tpu/utils/)."""
