"""Kernels of the port: plain PyTorch versions (:mod:`.ref`), the
hand-written Hopper kernels behind them (``csrc/``, bound by
:mod:`.native` and :mod:`.fused_step`), and the device-routed
dispatchers (:mod:`.ops`, the only public import surface)."""
