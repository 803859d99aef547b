"""The model zoo of the port: configuration, layers, the prefill forward,
the LM loss and the serving decode step (counterpart of the reference's
``repro.models``). It trains and serves the decoder-only attention
architectures (GQA, MLA, MoE); see :mod:`.model`."""
