"""PyTorch/CUDA port of the Rudder reproduction.

Same module layout as the JAX package ``repro``: each module here is the
counterpart of the file of the same path there, which stays the
reference it is tested against. This package imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Entry point: :class:`repro_torch.gnn.DistributedTrainer`, which runs on
the card by default (``device="cuda"``); ``device="cpu"`` runs the same
device-resident loop on CPU tensors through the kernels' plain versions.
"""
