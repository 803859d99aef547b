"""Sharded feature-store data plane.

Port of the reference's ``store`` package. The :class:`FeatureStore`
holds the partitioned feature shards (partition-major layout) as a host
numpy table or as a torch tensor on a device, and serves the batched
miss and admission sets of :class:`repro_torch.runtime.stage.FusedFetchStage`
with real gathers (:func:`repro_torch.kernels.ops.gather_rows_batch` on
the kernel path); admissions place real rows into the
:class:`repro_torch.runtime.engine.DeviceEngine` payload. The training
step's rows come from the same table by one flat gather on the device
(:func:`repro_torch.kernels.ops.gather_rows` through the node -> row map).

The contract: with the store enabled, the hit/miss/byte/decision
streams are bit-identical to the modeled path — the store only moves the
bytes the accounting already counted — while the trace gains measured
fields (``bytes_measured`` vs ``bytes_modeled``, wall-clock
``fetch_time_measured``, content-sensitive ``feat_sums``).
"""

from .feature_store import FeatureStore, StoreGather

__all__ = ["FeatureStore", "StoreGather"]
