"""Launch layer of the port: the decode step and the serving loop
(counterpart of the reference's ``repro.launch``)."""
