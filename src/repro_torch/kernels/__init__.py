"""Kernels of the port: plain PyTorch versions (:mod:`.ref`), the
hand-written Hopper kernels behind them (``csrc/``, bound by
:mod:`.native` and the wrappers :mod:`.fused_step`, :mod:`.gather_rows`,
:mod:`.frontier_unique`, :mod:`.score_update`, :mod:`.gather_mean`,
:mod:`.segment_sum` and :mod:`.mla_decode`), and the device-routed
dispatchers (:mod:`.ops`, the only public import surface)."""
