"""The model zoo of the port: configuration, layers, the prefill forward,
the LM loss and the serving decode step (counterpart of the reference's
``repro.models``). It trains and serves every architecture of the zoo
(GQA, MLA, MoE, the recurrences, Whisper's encoder-decoder and
Phi-3-vision's patch prefix); see :mod:`.model`. The modality frontends
are stubs (:mod:`.frontend`), as in the reference."""
