"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: the twins of ``tests/test_roofline.py`` (collective
bytes from records in place of the HLO sample), the report's terms and
row, ``model_flops_for`` on every (arch x shape), the counter's rules,
and ``measure_corrected``'s probe algebra against full-depth counts.

These counts run on unplaced ``meta`` tensors, with no process group: the
placed counts on fake meshes are ``tests/test_torch_dryrun.py``'s.
"""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_worlds as W
from repro import roofline as jroof
from repro.configs import all_arch_ids as jall_arch_ids
from repro.configs import get_config as jget_config
from repro.launch.steps import SHAPES as JSHAPES
from repro_torch import roofline as rl
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models.model import _scan_groups_raw

HLO_SAMPLE = """
  %all-gather.3 = f32[36,8,32768,8,128]{4,2,1,0,3} all-gather(%x), dimensions={3}
  %all-reduce.5 = bf16[1024,512]{1,0} all-reduce(%y), replica_groups={}
  %ar.start = f32[16]{0} all-reduce-start(%z)
  %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%p, %q)
  %cp = u8[100]{0} collective-permute(%w)
  %dot.1 = f32[128,128]{1,0} dot(%a, %b)
"""
#: The same collectives as records: (kind, result bytes).
RECORDS = [
    ("all-gather", 36 * 8 * 32768 * 8 * 128 * 4),
    ("all-reduce", 1024 * 512 * 2),
    ("all-reduce", 16 * 4),
    ("all-to-all", 128),
    ("collective-permute", 100),
]
#: The reference's TPU peaks, passed explicitly to both reports.
TPU_PEAKS = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


class TestCollectiveRecords:
    def test_kinds_and_wire_factor(self):
        out = rl.collective_bytes(RECORDS)
        assert out["all-gather"] == 36 * 8 * 32768 * 8 * 128 * 4
        assert out["all-reduce"] == (1024 * 512 * 2 + 16 * 4) * 2.0
        assert out["all-to-all"] == 128
        assert out["collective-permute"] == 100
        assert out == jroof.collective_bytes(HLO_SAMPLE)

    def test_no_records_no_bytes(self):
        out = rl.collective_bytes([])
        assert sum(out.values()) == 0
        assert out == jroof.collective_bytes("%dot = f32[8,8]{1,0} dot(%a, %b)")
        assert tuple(out) == jroof._COLLECTIVES


REPORTS = [
    dict(chips=4, flops=197e12, hbm_bytes=819e9 * 2, coll_bytes=50e9 * 0.5,
         model_flops=4 * 197e12 * 0.25),
    dict(chips=256, flops=3e15, hbm_bytes=1e12, coll_bytes=1e11, model_flops=5e17),
    dict(chips=512, flops=1e9, hbm_bytes=1e9, coll_bytes=1e12, model_flops=0.0),
    dict(chips=1, flops=0.0, hbm_bytes=0.0, coll_bytes=0.0, model_flops=1.0),
]


class TestReport:
    def test_bottleneck_and_terms(self):
        r = rl.RooflineReport(arch="a", shape="s", mesh_desc="m", **REPORTS[0], **TPU_PEAKS)
        assert r.t_compute == pytest.approx(1.0)
        assert r.t_memory == pytest.approx(2.0)
        assert r.t_collective == pytest.approx(0.5)
        assert r.bottleneck == "memory"
        assert r.useful_flops_ratio == pytest.approx(0.25)

    @pytest.mark.parametrize("case", range(len(REPORTS)))
    @pytest.mark.parametrize("peaks", ["tpu", "h100"])
    def test_terms_and_row_equal_the_reference(self, case, peaks):
        from repro_torch.launch import mesh as tmesh

        given = TPU_PEAKS if peaks == "tpu" else dict(
            peak_flops=tmesh.PEAK_FLOPS_BF16, hbm_bw=tmesh.HBM_BW, ici_bw=tmesh.ICI_BW)
        kw = dict(arch="qwen3-8b", shape="train_4k", mesh_desc="data=16xmodel=16",
                  **REPORTS[case], **given)
        port, ref = rl.RooflineReport(**kw), jroof.RooflineReport(**kw)
        assert (port.t_compute, port.t_memory, port.t_collective) == (
            ref.t_compute, ref.t_memory, ref.t_collective)
        assert port.bottleneck == ref.bottleneck
        assert port.useful_flops_ratio == ref.useful_flops_ratio
        assert port.row() == ref.row()

    def test_peaks_default_to_one_h100(self):
        from repro_torch.launch import mesh as tmesh

        r = rl.RooflineReport(arch="a", shape="s", mesh_desc="m", chips=1, flops=989e12,
                              hbm_bytes=3.35e12, coll_bytes=450e9)
        assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (989e12, 3.35e12, 450e9)
        assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (
            tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW)
        assert r.t_compute == r.t_memory == r.t_collective == 1.0


class TestModelFlops:
    def test_train_vs_decode_scaling(self):
        cfg = get_config("qwen3-8b")
        train = rl.model_flops_for(cfg, "train_4k", 256, 4096)
        dec = rl.model_flops_for(cfg, "decode_32k", 128, 32768)
        assert train / dec == pytest.approx(3 * 256 * 4096 / 128)

    def test_moe_uses_active_params(self):
        cfg = get_config("deepseek-v3-671b")
        total = rl.model_flops_for(cfg, "train_4k", 256, 4096)
        dense_equiv = 6 * cfg.param_count() * 256 * 4096
        assert total < 0.1 * dense_equiv

    @pytest.mark.parametrize("arch", jall_arch_ids())
    def test_equal_to_the_reference_on_every_shape(self, arch):
        assert list(steps.SHAPES) == list(JSHAPES)
        for shape, info in steps.SHAPES.items():
            port = rl.model_flops_for(get_config(arch), shape, info["batch"], info["seq"])
            ref = jroof.model_flops_for(jget_config(arch), shape, info["batch"], info["seq"])
            assert port == pytest.approx(ref, rel=1e-12, abs=0)


class TestCounter:
    def test_products_bytes_and_views(self):
        a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
        b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
        with rl.CostCounter() as c:
            out = a @ b
            out.view(16, 64).t()        # views move nothing
            torch.empty((1 << 20,), device="meta")
        assert c.flops == 2 * 64 * 32 * 16
        assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 2
        assert c.collectives == []
        assert c.by_op == {"mm": [2 * 64 * 32 * 16, c.bytes]}

    def test_formulas_agree_with_flop_counter_mode(self):
        """The two added formulas, through the counter and through
        ``FlopCounterMode(custom_mapping=FLOP_FORMULAS)``."""
        bf16 = dict(dtype=torch.bfloat16, device="meta")
        x = torch.empty((96, 64), **bf16)
        w = torch.empty((4, 64, 48), **bf16)
        offs = torch.empty((4,), dtype=torch.int32, device="meta")
        acc = torch.empty((96, 48), device="meta")
        y = torch.empty((48, 64), device="meta")
        xf = torch.empty((96, 64), device="meta")

        def run():
            torch._grouped_mm(x, w, offs=offs)
            acc.addmm_(xf, y.t())

        with rl.CostCounter() as c:
            run()
        with FlopCounterMode(display=False, custom_mapping=rl.FLOP_FORMULAS) as fc:
            run()
        assert c.flops == fc.get_total_flops() == 2 * (96 * 64 * 48) * 2
        assert c.by_op["_grouped_mm"][0] == c.by_op["addmm_"][0] == 2 * 96 * 64 * 48

    def test_peak_of_live_temporaries(self):
        a = torch.empty((1024,), device="meta")
        with rl.CostCounter() as c:
            b = a * 2            # 4 KiB live
            d = b + 1            # 8 KiB live
            del b
            e = d * 3            # 8 KiB live again
            del d, e
        assert c.peak == 2 * 4096
        assert c.live == 0

    def test_a_fill_reads_nothing(self):
        like = torch.empty((64, 16), dtype=torch.bfloat16, device="meta")
        with rl.CostCounter() as c:
            like.new_zeros((8,))
            torch.zeros_like(like).fill_(1.0)
        assert c.bytes == 8 * 2 + 2 * 64 * 16 * 2

    def test_a_host_transfer_is_not_device_work(self):
        host = torch.ones(8)
        with rl.CostCounter() as c:
            host.to("meta")
        assert c.bytes == 0


# --------------------------------------------------------------------- #
# measure_corrected
# --------------------------------------------------------------------- #
#: A mesh of one as the specs read it: no process group.
ONE = types.SimpleNamespace(shape={"data": 1, "model": 1})
SMALL = {
    "t_train": dict(kind="train", seq=320, batch=4),
    "t_prefill": dict(kind="prefill", seq=320, batch=4),
    "t_decode": dict(kind="decode", seq=96, batch=2),
}
#: (arch, layers, shapes): every kind of layer group, the encoder's probe
#: and the sequence-length probes of the step-loop kinds.
CASES = [
    ("qwen3-8b", 3, ("t_train", "t_prefill", "t_decode")),
    ("gemma2-2b", 4, ("t_prefill",)),
    ("phi3.5-moe-42b-a6.6b", 3, ("t_train", "t_prefill")),
    ("deepseek-v3-671b", 10, ("t_train",)),
    ("whisper-large-v3", 3, ("t_train", "t_prefill")),
    ("zamba2-1.2b", 4, ("t_train",)),
    ("xlstm-350m", 2, ("t_prefill",)),
]


@pytest.fixture
def small_shapes(monkeypatch):
    for name, info in SMALL.items():
        monkeypatch.setitem(steps.SHAPES, name, info)


@pytest.mark.parametrize("arch,layers,shapes", CASES, ids=[c[0] for c in CASES])
def test_measure_corrected_equals_the_full_count(small_shapes, arch, layers, shapes):
    """The probe algebra (layer counts, the encoder's, and for the
    step-loop kinds the sequence length) gives the full-depth count
    exactly: FLOPs, bytes and every collective's bytes."""
    cfg = get_smoke_config(arch).with_overrides(num_layers=layers)
    probed = max(c for _, c in _scan_groups_raw(cfg)) > 1 or cfg.encoder_layers > 1
    assert probed or rl.seq_probes(cfg, shapes[0], ONE)
    for shape in shapes:
        W.plain_step(cfg, shape, ONE, seq=64)()      # the once-per-process constants
        full = rl.count(W.plain_step(cfg, shape, ONE))
        corr = rl.measure_corrected(cfg, shape, ONE, W.plain_step)
        loops = rl.seq_probes(cfg, shape, ONE)
        assert (loops is not None) == (arch in ("zamba2-1.2b", "xlstm-350m")
                                      and shape != "t_decode"), loops
        for key in full:
            if key != "temp":
                assert corr[key] == full[key], (shape, key)
        assert full["flops"] > 0 and full["bytes"] > 0


def test_moe_counts_the_grouped_products(small_shapes):
    """The dropless MoE layer's experts (``torch._grouped_mm``) count
    their FLOPs: forward and, in a training step, the two gradients."""
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(num_layers=2)
    with rl.CostCounter() as c:
        W.plain_step(cfg, "t_prefill", ONE)()
    tokens = SMALL["t_prefill"]["batch"] * SMALL["t_prefill"]["seq"]
    m = cfg.moe
    per_layer = 3 * 2 * tokens * m.experts_per_token * cfg.d_model * m.d_ff_expert
    assert c.by_op["_grouped_mm"][0] == 2 * per_layer
    with rl.CostCounter() as c:
        W.plain_step(cfg, "t_train", ONE)()
    assert c.by_op["_grouped_mm"][0] > 3 * 2 * per_layer * SMALL["t_train"]["batch"] // 4


def test_sequence_probes_follow_the_embedding_rows(monkeypatch):
    """The probes start where the embedding backward's worst-case rows
    take the full length's branch, at two chunks at least, and a shape
    too short to probe is counted whole."""
    cfg = get_config("xlstm-350m")
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    # 16 sequences a rank, 50304 / 16 = 3144 vocabulary rows: 4 chunks.
    assert rl.seq_probes(cfg, "train_4k", mesh) == [256, 320, 384]
    assert rl.seq_probes(cfg, "prefill_32k", mesh) == [128, 192, 256]
    assert rl.seq_probes(cfg, "decode_32k", mesh) is None
    assert rl.seq_probes(get_config("qwen3-8b"), "train_4k", mesh) is None
    monkeypatch.setitem(steps.SHAPES, "t_short", dict(kind="train", seq=256, batch=4))
    assert rl.seq_probes(get_smoke_config("xlstm-350m"), "t_short", ONE) is None
