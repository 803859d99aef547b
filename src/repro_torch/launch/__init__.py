"""Launch layer of the port: the train, prefill and decode steps, the
training driver and the serving loop (counterpart of the reference's
``repro.launch``)."""
