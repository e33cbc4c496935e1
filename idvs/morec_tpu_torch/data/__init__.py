"""Host-side data: item and behavior readers, batchers, the image store and
its batch pipeline (JAX twin: idvs/morec_tpu/data/)."""
