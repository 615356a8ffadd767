"""The port's control plane: name negotiation, the response cache, the
stall inspector, fusion and the background runtime that launches the
negotiated collectives (counterpart of ``horovod_tpu/native/``)."""
