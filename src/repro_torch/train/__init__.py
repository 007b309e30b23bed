"""Training substrate of the port: optimizer (AdamW + WSD), trainer loop,
checkpointing, fault tolerance, gradient compression — the counterparts of
``repro.train``, over the port's nested parameter dicts."""
