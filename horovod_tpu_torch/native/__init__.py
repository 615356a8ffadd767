"""The port's control plane: name negotiation, the response cache, the
stall inspector, fusion, the background runtime that launches the
negotiated collectives, and its timeline and autotuner (counterpart of
``horovod_tpu/native/``)."""
