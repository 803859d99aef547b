#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

0. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
1. build every hand-written kernel from ``src/repro_torch/kernels/csrc``
   (eight libraries, one ``nvcc`` per source, all started together);
2. every kernel against its plain PyTorch version on the card, bit for bit,
   on the seeded scenario sets of the CPU tests: ``fused_frontier_step``
   (with and without a feature-store table), ``fused_step``,
   ``gather_rows_batch`` and ``gather_rows``; ``fused_frontier_step_wide``
   and ``fused_step_wide`` on the wide sets (int64 ids at bases past 2^31
   and 2^32, ids ending at ``WIDE_ID_MAX``, a sparse set spread over 2^40),
   each in both index modes of the kernels (direct maps and sorted), the
   frontier sets with padding other than -1, a hub row and an odd packed
   stride among them;
   ``frontier_unique_batch`` and its int64 twin on the frontier-dedup set,
   and ``score_policy_update_batch``, ``score_update_batch`` and
   ``score_update`` on the scoring set (every policy, weights on and off);
   ``gather_mean`` and ``segment_sum_equal`` on theirs (float32 and
   bfloat16, K in {1, 3, 10, 25} and at the loops' unroll edges, F in
   {1, 3, 64, 100, 128, 600}, int32 and int64 indices, every lane-group
   width, a gather past one pass of its grid, views off the 16-byte grid,
   B = 0 and S = 0); and ``mla_flash_decode`` to
   allclose (1e-4 float32, 3e-2 bfloat16) on the reference test's three
   shapes, phase 9's, H 72, r 32 with rr 4, r 512 with rr 128 and r 512
   with rr 672, inputs from a numpy seed with near-uniform and with peaked
   scores (bfloat16 on peaked scores also within 1e-2 of the plain
   output's largest value), pos at 0, mid-tile, the tile and split edges
   and S - 1, and on caches
   whose rows past pos are NaN (finite, equal to the plain version on a
   zeroed tail); bfloat16 on the tensor-core kernel, float32 on the
   CUDA-core kernel (counted per kernel);
3. the raw main path: ``DistributedTrainer(device="cuda")`` on the products
   preset at ``scale=10`` (240k nodes), 4 trainers, batch 2000, fanouts
   (10, 25), 25% buffers, rudder variant, 3 epochs of GraphSAGE training,
   whose neighbour means run on ``gather_mean`` (the layer-2 mean, read
   from the feature table) and ``segment_sum_equal`` (the layer-1 mean);
   then ``fused_frontier_step`` and both aggregation kernels against their
   plain versions on the captured inputs of the run's own launches (full
   shape), and all timed, the frontier step also by its device operations
   a call (torch.profiler) and its wrapper's host time; both aggregation
   kernels (and ``fanout_mean``, the sum with ``1 / k`` in its epilogue)
   by their kernel alone (torch.profiler), device operations a call and
   wrapper host time, and the gather's L2 floor
   (``scripts/aggregation_ab.py``) beside its bound;
3b. the ragged path: the papers preset at ``scale=10`` (550k nodes, 1%
   train nodes, so every PE's seed block is shorter than the batch of
   2000), the same trainer with a ``FeatureStore(use_kernel=True)`` on the
   card, 8 epochs of one step each, both neighbour means on
   ``segment_sum_equal`` over the store's rows; ``fused_step``,
   ``gather_rows_batch`` (the store's per-home pulls of misses and
   admissions, one per store kernel gather), ``gather_rows`` (its flat
   gathers of each PE's training rows through the node -> row map, one
   per flat gather, P * steps + 1) and ``segment_sum_equal`` against their
   plain versions on the run's captured launches, all timed (``segment_sum_equal``
   on ``x_n2`` also alone, by its device operations and host time); the
   fused step in
   both of its forms (the engine's, gate words in and the packed readback
   out, and the reference's eleven outputs), each with its device
   operations a call (torch.profiler) and its wrapper's host time, and
   its kept maps clean (-1 / 0) after the run, the checks and the timings;
4. card vs CPU: the raw path at ``scale=1`` (batch 256), the same with the
   feature store (the in-launch payload scatter), a ragged store run
   (products ``scale=0.15``, batch 72), the raw path on the graph rebased
   past 2^31 (wide ids), on the readback cadence, and the staged fall-back
   (the graph rebased to ``WIDE_ID_MAX``): every integer and bool
   stream, the store streams, the buffer state and payload identical,
   losses allclose;
4b. the telemetry session: phase 4's raw run on the card with
   ``telemetry=True`` against the same run without: equal ``exact_digest``
   and logs, ``kernel.<name>.calls`` equal to each launched kernel's
   launches, a ``train``-plane span, the JSONL and Chrome trace written and
   loaded back; the aggregation dispatchers' seconds (count, p50);
5. the 8 committed golden traces re-recorded on the card, modeled and with
   the feature store: each ``exact_digest`` equals the golden's;
6. the wide raw loop: phase 3's graph rebased to id_base ``2**31 + 1000``,
   phase 3's run through ``fused_frontier_step_wide`` only: every stream,
   stat and buffer state equal to phase 3's (ids shifted), the kernel and
   both aggregation kernels bit-exact on every launch of the run, timed as
   in phase 3, stage times beside phase 3's;
6b. the wide ragged loop with the store: phase 3b's graph rebased, phase
   3b's run through ``fused_step_wide``, ``gather_rows_batch`` and
   ``gather_rows`` (launches as phase 3b's, each bit-exact): streams,
   ``feat_sums``, bytes, state and payload equal to phase 3b's; the fused
   step checked, timed and its maps checked as in phase 3b, and
   ``segment_sum_equal`` bit-exact on every launch of the run;
7. the readback cadence: phase 3's graph, narrow and rebased, the ``fixed``
   controller at ``readback_every=4`` against ``readback_every=1``: equal
   logs, one counter pull per 4 launches, the readback time per step;
8. the staged fall-back at full width: phase 3's graph rebased to
   ``WIDE_ID_MAX`` and phase 3's run on ``device="cuda"``: one warning,
   one ``frontier_unique_batch`` launch (the sampler's dedup, in its
   compact form: the raw block sorted on the card, the ids compacted
   there) and one ``score_policy_update_batch`` launch (the engine's
   scoring round) per step, every stream, stat and the buffer state equal
   to phase 3's (ids shifted), each kernel (and both aggregation kernels)
   bit-exact on every launch of the run; the sampler hook's split
   (``scripts/staged_hooks_ab.py``'s ``hook_split``: expansion, upload,
   sort, kernel, readback, host split); both forms of the dedup (the
   path's compact form and the reference's mask form) and the scoring
   round timed, each also by its kernel alone warm and cold, device
   operations a call and wrapper host ms, and the three entries no
   trainer path launches on their phase-2 sets;
8b. the staged loop on the host: ``device=False`` on phase 3's graph and
   run, equal to phase 3; then phase 8's ``sample`` and ``fetch.commit``
   medians beside 8b's and phase 3's in one line;
9. DeepSeek-V3's serving path at full width: ``serve_batch`` on
   ``CONFIG.with_overrides(num_layers=5)`` (the checkpoint's three dense
   layers and two MoE layers of 256 routed experts top-8 and one shared,
   128 heads, vocabulary 129,280, bf16, 54.6 GB of random weights from a
   seed), 4 requests, prompt 256, 32 generated tokens: exactly
   5 x 288 ``mla_flash_decode`` launches, all on the tensor-core kernel,
   and no other kernel, the kernel against its plain version on the
   captured inputs of a prefill step and the last step; tokens in range;
   decode time per step, tokens/s, peak memory, the distinct experts a
   MoE layer touches per step (its serve inputs routed again) and the MoE
   layers' share of the decode step (CUDA events around each
   ``moe_forward``); ``make_prefill_step`` on the same prompts (wall
   time, its last-position logits against the decode path's); one MoE
   layer alone at decode (4 tokens) and prefill (1024 tokens): ms, the
   expert bytes it reads, their HBM bound, and what a host read of its
   expert counts would cost (``moe_forward`` reads none);
9b. ``mla_flash_decode`` at the reference's ``decode_32k`` shape (batch
   128, cache 32768, bf16, peaked scores): the ``-Xptxas -v`` report of
   its kernels, against its plain version (3e-2, and within 1e-2 of the
   plain output's largest value), timed beside the plain version,
   ``scaled_dot_product_attention`` and its bound, the split kernel alone
   by torch.profiler and the share of the bound reached;
9c. card vs CPU: the smoke configs of the ten architectures
   (DeepSeek-V3, Phi-3.5-MoE, Qwen3-8B, Phi-3-mini, Minitron-4B,
   Gemma2-2B, xLSTM-350M, Zamba2-1.2B, Whisper-large-v3 with the same
   frames, Phi-3-vision-4.2B with the same patches in its prefill) in
   float32, served on both devices from the same weights:
   greedy tokens identical, decode and prefill logits allclose 1e-4, the
   MLA configs' launches all on the CUDA-core kernel and the GQA ones'
   none; ``forward`` vs token-by-token decode on the card within 1e-3 x
   max(|logits|, 1) (Gemma2 at S = 14, past its window of 8); the two MoE
   configs' decode twice on the card, bit-identical;
9d. Qwen3-8B whole (36 layers, 16.4 GB of bf16) served as phase 9 with
   no native kernel launched, printed as phase 9 (with its prefill step);
11. the legacy runtime (``runtime="legacy"``, the per-PE host loop, its
   GraphSAGE step on the card): phase 3's graph and run, every stream,
   ``epoch_times`` and the accuracy equal to phase 3's, the buffers' stats
   summing to its ``engine.stats``, the losses bit-identical (or, if not,
   allclose, and said so), only ``gather_mean`` and ``segment_sum_equal``
   launched (P * steps + 1 each), every launch bit-exact; phase 3b's graph
   and run with a ``FeatureStore(use_kernel=True)``: the store streams
   equal to phase 3b's, every ``gather_rows_batch`` launch (the store's
   kernel gathers) and ``gather_rows`` launch (its flat gathers) counted
   and bit-exact; the scale-1 legacy run with
   ``telemetry=True``: spans on PEs {-1, 0, 1, 2, 3} and phase 4b's
   digest; the legacy stage times beside phase 3's (phase 5 also
   re-records the 8 goldens on the legacy runtime);
12. the classifier plane: ``collect_traces`` on phase 3's graph on the
   card, ``X`` and ``y`` equal to the CPU's; all six classifiers fitted on
   the card and the CPU from the same initial arrays (tree models
   identical, logits allclose 1e-5, every decision identical; a flipped
   decision prints its logits); a rudder run with the fitted ``mlp`` as
   every PE's decider at phase 3's configuration on the raw device loop
   and on the legacy runtime, equal streams, the raw loop's
   ``fused_frontier_step`` bit-exact on every launch; the decision rate and
   the host µs per ``decide`` call on the card and the CPU;
13. the presets ``products_25pct_rudder`` and ``products_massivegnn`` at
   their scale on the card, equal to the CPU's; ``run_sweep(default_grid())``
   (16 cells) on the card, rows equal to the CPU's, ``validate_rows``
   empty, the prefetch-step launches counted and each bit-exact;
14. training at full width through ``launch.train.train``: DeepSeek-V3
   cut to its three dense layers with its MTP head (4.29 B parameters,
   128 MLA heads, d_model 7168, vocabulary 129,280, bf16 moments), batch 2
   x seq 512, lr 3e-5 (at 3e-4 it diverges: ``scripts/train_lr_probe.py``);
   Gemma2-2B whole (26 layers, float32 moments), 2 x 1024, lr 3e-4;
   Phi-3.5-MoE cut to two layers (16 experts top-2), 2 x 512, lr 3e-4; 6
   steps each from random weights (seed 0) on ``TokenPipeline(seed=0)``
   batches: every loss and metric (``ce``, ``aux``, ``mtp_ce``) finite,
   the last loss below the first, no native kernel launched; the first
   step's ms and the median of the rest, tokens/s, peak memory, and the
   model FLOPs a step (``train_flops``) against the 989 TFLOP/s dense bf16
   peak; then, from the trained parameters and fresh moments on the next
   batch, a ``remat=True`` step's loss within 1e-5 of the ``remat=False``
   gradient pass's, each with its peak memory;
14c. card vs CPU: the ten smoke configs in float32 from the same weights
   and batches, 3 steps of ``train``: losses within 1e-4 relative, step-1
   gradients within 1e-4 x each leaf's largest, no native launch; the
   card's checkpoint (``ckpt_path``) loaded on the CPU bit for bit equal to
   the card's parameters;
15. xLSTM-350M (24 layers) and Zamba2-1.2B (38 layers) whole in bf16,
   served as phase 9d (``SERVE``'s requests through ``serve_batch``, the
   decode step alone by host clock and CUDA events, ``make_prefill_step``
   against the decode path at position 255), with tokens/s, peak memory
   and the decode step's bound from the bytes it must move (parameters,
   the attention cache, the recurrent state read and written); no native
   kernel launched;
15b. ``shape_supported`` on every ported config and shape (the
   reference's rule: ``long_500k`` for xLSTM-350M, Zamba2-1.2B and
   Gemma2-2B only); both models at ``long_500k`` (batch 1, a cache of
   524,288, ``long_mode``): 8 greedy steps from position 524,280, logits
   finite, ms a step beside its bytes bound, the peak with Zamba2's 25.8 GB
   of shared-attention cache; xLSTM-350M's last step again at position 5
   from a copy of its state, bit-identical;
15c. both models trained whole through ``launch.train.train`` at batch 2 x
   seq 256, lr 3e-4, 6 steps (phase 14's checks, one ``remat=True`` step
   against the ``remat=False`` gradient), the predicted bytes the
   recurrences keep for backward beside the measured peaks, and the FLOP
   share by ``train_flops``;
16. Whisper-large-v3 whole in bf16 (32 encoder + 32 decoder layers,
   1,534,809,600 parameters from a seed) served with phase 9's requests,
   each with 1500 seeded frames (the encoder once, the cross cache
   filled, then the decode steps): the encoder's ms (host and CUDA
   events), the decode step alone by host clock and CUDA events against
   its bound (the decoder's parameters, the self-attention cache and
   0.98 GB of cross keys and values read), tokens/s, peak memory,
   ``make_prefill_step`` with the frames against the decode path at
   position 255; no native kernel launched;
16b. Phi-3-vision-4.2B whole in bf16 (3,824,225,280 parameters):
   ``forward`` on 2 x (576 patches + 256 tokens), logits (2, 832, 32064)
   finite, and ``make_prefill_step`` (wall s, peak memory); no native
   kernel launched;
16c. both trained whole through ``launch.train.train`` (Whisper 2 x 256
   tokens with 1500 frames at lr 3e-4, Phi-3-vision 2 x 256 tokens with
   576 patches each at lr 6e-5), 6 steps with phase 14's checks and
   split, two ``remat=True`` steps against the ``remat=False`` gradient;
17. expert parallelism on a mesh of one: a ``torch.distributed`` world of
   one over a ``FileStore`` (gloo for CPU tensors, NCCL for the card's),
   its (1, 1) mesh registered with ``moe.set_ep_mesh``; both MoE smoke
   configs in float32 through ``moe_apply`` with ``ep_axis="model"``, each
   combine (psum, a2a) at capacity 8 and 1.25: ``y``, ``aux`` and every
   gradient on the card within 1e-4 of the CPU's, two card runs
   bit-identical, the 1.25 cases dropping copies; then phases 9c's and
   14c's checks on both smoke models with each of those settings;
17b. one MoE layer at published width (DeepSeek-V3's 256 experts, 22.5 GB;
   Phi-3.5-MoE's 16, 2.5 GB) at decode (4 tokens) and prefill (2 x 256):
   ``moe_forward_ep`` (psum) at capacity E / k against ``moe_forward``
   within 3e-2 of max |y|, both timed beside their bytes bounds, the copies
   dropped at capacity 1.25;
17c. ``serve_batch`` on phase 9's DeepSeek-V3 cut with ``ep_axis="model"``
   (ms a step, greedy agreement with phase 9's tokens, the MLA launches;
   one decode step on one cache against the dropless step within 3e-2),
   and 2 steps of ``make_train_step`` on phase 14's Phi-3.5-MoE cut with
   it (losses, copies dropped, ms a step, peak);
18. the roofline's counts (``repro_torch.roofline.measure_corrected``) of
   phase 9d's Qwen3-8B decode step and phase 14's Gemma2-2B training step
   at those phases' shapes, placed on a mesh of one of a fake world
   (``meta`` tensors): FLOPs, bytes, ``t_compute`` and ``t_memory`` at the
   card's spec-sheet peaks and the bottleneck beside the same run's
   measured ms and the hand counts (``decode_bound``, ``train_flops``),
   the measured ms asserted at least ``t_compute``; 18b. ``python -m
   repro_torch.launch.dryrun`` for Qwen3-8B at ``decode_32k`` and
   DeepSeek-V3 at ``decode_32k --multi-pod`` (256 and 512 fake ranks) as
   two subprocesses at once, exit 0 and rows ``ok``; neither phase
   launches a kernel;
10. a ``kernels`` JSON line (the fused step's rows time the engine's form,
   the reference form's times beside them; the aggregation rows add their
   kernel alone, device operations a call, host ms, the gather's L2
   floor, ``fanout_mean``'s and ``x_n2``'s numbers and the median
   in-run device ms of phases 3, 3b, 6, 6b and 8; the staged rows their
   kernel alone, device operations and host ms, ``frontier_unique_batch``
   timing the path's compact form with the mask form and the hook's
   split beside it; rows 11-13 the legacy runs' launches, rows 1-2 the
   launches of phases 12 and 13; every row its launches in phase 14,
   in phases 15, 15b and 15c (``ssm_launches``) and in phases 16, 16b
   and 16c (``whisper_launches``), 0, and in phases 17-17c
   (``ep_launches``: ``mla_flash_decode`` serves 17c's decode steps),
   and as the last line
   the device JSON line. The aggregation kernels' in-run time (CUDA events
   around each dispatcher call) prints on phases 3, 3b, 6, 6b and 8.

Each path's launch counts are zeroed just before it runs and read just
after (the serving path launches ``mla_flash_decode`` only, phases 9d,
15-15b, 16, 16b and 18 none, training none); the device loops (phases 3, 3b, 6, 6b, 7) launch neither of the
staged pipeline's kernels, and every training run launches the two
aggregation kernels exactly once per PE, step and mean, plus the
accuracy pass. Every phase raises on failure, so any failure exits non-zero.
Without a CUDA card, or outside a checkout of the repository, the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's peaks, from the one place that holds them (NVIDIA H100 80GB
# HBM3, 700 W, spec sheet): HBM bandwidth; the float32 rate outside the
# tensor cores, the roof for the kernels' integer and compare work too; the
# bf16 rate of the tensor cores (dense), the roof of bf16 products.
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_TENSOR_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as SCALAR_OPS_PER_S  # noqa: E402

#: The raw main path (phase 3), the ragged path (3b) and the card-vs-CPU
#: runs (phase 4).
RUN = dict(
    variant="rudder",
    deciders=["gemma3-4b"],
    mode="async",
    batch_size=2000,
    fanouts=(10, 25),
    hidden_dim=64,
    buffer_frac=0.25,
    train_model=True,
    epochs=3,
)
RAGGED = dict(RUN, epochs=8)
SMALL = dict(RUN, batch_size=256, epochs=2)
SMALL_RAGGED = dict(RUN, batch_size=72, epochs=2)
MAIN_SCALE, RAGGED_SCALE, SMALL_SCALE, SMALL_RAGGED_SCALE = 10, 10, 1, 0.15
DEVICE = "cuda"
#: Phase 9: DeepSeek-V3's serving path at full width, cut in depth to its
#: first five layers (the checkpoint's three dense layers and two MoE
#: layers, 54.6 GB of bf16); 4 requests, prompt 256, 32 tokens.
ARCH = "deepseek-v3-671b"
SERVE_LAYERS = 5
SERVE = dict(requests=4, prompt_len=256, gen_len=32, seed=0)
#: Phase 9d: Qwen3-8B whole (36 layers, 16.4 GB of bf16), the same requests.
WHOLE_ARCH = "qwen3-8b"
#: Phases 9c and 14c: the smoke configs of the ten architectures on the
#: card and the CPU.
ZOO = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "phi3-mini-3.8b",
       "minitron-4b", "gemma2-2b", "xlstm-350m", "zamba2-1.2b", "whisper-large-v3",
       "phi-3-vision-4.2b")
SERVE_SMALL = dict(requests=3, prompt_len=12, gen_len=12, seed=1)
#: Phase 14: training at full width through ``launch.train.train`` (random
#: weights from seed 0, ``TokenPipeline(seed=0)`` batches, ``remat=False``):
#: the architecture, its depth cut (None: whole), batch, sequence and lr.
#: DeepSeek-V3's three dense layers with its MTP head (4.29 B parameters,
#: 34.3 GB of state with bf16 moments), at lr 3e-5: at 3e-4 an un-warmed
#: AdamW at d_model 7168 drives its loss from 17.13 to 90.88 in four steps
#: (``scripts/train_lr_probe.py``); Gemma2-2B whole (26 layers: local/global
#: GQA, the logit softcap, tied embeddings; 31.4 GB); Phi-3.5-MoE's first
#: two layers (16 experts top-2: ``_grouped_mm``'s backward at real
#: shapes; 34.4 GB).
TRAIN_RUNS = (("deepseek-v3-671b", 3, 2, 512, 3e-5), ("gemma2-2b", None, 2, 1024, 3e-4),
              ("phi3.5-moe-42b-a6.6b", 2, 2, 512, 3e-4))
TRAIN_STEPS = 6
#: Phase 14c: the six smoke configs in float32, card vs CPU: 3 steps at lr
#: 3e-3 on batches of 2 x 16; losses within 1e-4 relative, step-1 gradients
#: within 1e-4 x each leaf's largest.
TRAIN_SMALL = dict(steps=3, batch=2, seq=16, lr=3e-3, seed=4)
TRAIN_TOL = 1e-4
REMAT_TOL = 1e-5
#: Phases 15-15c: the SSM and hybrid architectures whole, bf16 (xLSTM-350M:
#: 24 layers, 3 x (7 mLSTM + sLSTM); Zamba2-1.2B: 38 layers, 6 x (5 Mamba2 +
#: shared attention) + 2 Mamba2): served with ``SERVE``'s requests (15), at
#: ``long_500k`` for ``LONG_STEPS`` steps (15b), trained at ``SSM_TRAIN``
#: for ``TRAIN_STEPS`` steps (15c; S = 256 puts mLSTM on its 64-step chunk
#: path). ``long_500k`` is allowed for these two and Gemma2-2B only
#: (``launch.steps.shape_supported``, the reference's rule).
SSM_ARCHES = ("xlstm-350m", "zamba2-1.2b")
LONG_STEPS = 8
SSM_TRAIN = dict(batch=2, seq=256, lr=3e-4)
LONG_500K_OK = ("gemma2-2b", "xlstm-350m", "zamba2-1.2b")
#: Phases 16-16c: the encoder-decoder and vision configs whole, bf16.
#: Whisper-large-v3 (32 encoder + 32 decoder layers, d_model 1280, 1500
#: frames) served with ``SERVE``'s requests (16); Phi-3-vision-4.2B
#: (Phi-3-mini's 32 layers, 576 patch tokens through ``vision_proj``):
#: ``make_prefill_step`` on ``VISION_PREFILL``'s batch of patches and text
#: (16b); both trained whole at their ``MEDIA_TRAIN`` row (arch, depth
#: cut, batch, text tokens, lr) for ``TRAIN_STEPS`` steps (16c). From
#: ``scripts/train_lr_probe.py --media``: Whisper learns at 3e-4, 1e-4 and
#: 3e-5 (2 x 256); Phi-3-vision at 1 x 256 spikes at 3e-4 and 1e-4 (to
#: 15.94 and 13.34 from 10.93) and stays within its batches' spread from
#: 6e-5 down to 1e-5, while at 2 x 256 and 6e-5 it falls from 11.01 to
#: 10.70 (peak 56.0 GB).
AUDIO_ARCH, VISION_ARCH = "whisper-large-v3", "phi-3-vision-4.2b"
#: Phases 17-17c: expert parallelism on a mesh of one (a torch.distributed
#: world of one: gloo for CPU tensors, NCCL for the card's). 17: both MoE
#: smoke configs in float32, each combine at capacity 8 (nothing can drop)
#: and 1.25 (the default: copies drop), the card against the CPU on inputs
#: of ``EP_X`` tokens with a common offset of ``EP_SKEW`` normals (routing
#: that favours some experts). 17b: one MoE layer at published width at
#: each of ``EP_SHAPES`` (batch, seq). 17c: phase 9's DeepSeek-V3 cut
#: served, and ``EP_TRAIN``'s Phi-3.5-MoE cut trained, with ``ep_axis``.
EP_ARCHES = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
EP_CASES = tuple((c, cf) for c in ("psum", "a2a") for cf in (8.0, 1.25))
EP_X = (4, 8)
EP_SKEW = 2.0
EP_TOL = 1e-4
EP_SHAPES = (("decode", 4, 1), ("prefill", 2, 256))
EP_TRAIN = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, batch=2, seq=512, lr=3e-4, steps=2)
#: Positions of phase 9's prompts that fill the cache before 17c's one
#: decode step, EP against dropless.
EP_FILL = 32
VISION_PREFILL = dict(batch=2, seq=256)
MEDIA_TRAIN = (("whisper-large-v3", None, 2, 256, 3e-4),
               ("phi-3-vision-4.2b", None, 2, 256, 6e-5))
#: Phase 2's MLA sweep, B, H, r, rr, S: the reference test's shapes,
#: phase 9's, H 72 (not a multiple of the tensor-core kernel's 64-head
#: block), r 32 with rr 4 (a 64-wide box over 32 columns; 8-byte kr rows,
#: which TMA cannot address), r 512 with rr 128 (a one-stage ring) and r 512
#: with rr 672 (r + rr = 1184, the widest row: queries streamed).
MLA_SHAPES = ((1, 4, 32, 8, 64), (2, 8, 64, 16, 700), (1, 16, 128, 64, 512),
              (4, 128, 512, 64, 289), (2, 72, 128, 64, 300), (2, 8, 32, 4, 100),
              (1, 8, 512, 128, 200), (1, 8, 512, 672, 200))
#: Phase 2's NaN-tail cases: every cache row past pos is NaN.
MLA_NAN_SHAPES = ((4, 128, 512, 64, 289), (2, 8, 32, 4, 100))
MLA_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: On scores that spread (``scenarios.PEAKED``), bfloat16 is also held to
#: max |diff| <= MLA_REL * max |plain|.
MLA_REL = 1e-2
#: Phases 6, 6b and 7: the wide runs rebase phase 3's and 3b's graphs to
#: this id base (just past int32); the cadence reads counters back every
#: CADENCE launches, with the ``fixed`` controller (the adaptive ones read
#: per-step metrics, which the cadence never materialises).
WIDE_BASE = 2**31 + 1000
CADENCE = 4
FIXED = dict(RUN, variant="fixed")
#: The staged pipeline's kernels, which no device loop launches.
STAGED_KERNELS = (
    "frontier_unique_batch", "frontier_unique_batch_wide", "score_update",
    "score_update_batch", "score_policy_update_batch",
)
FALLBACK_WARNING = "falling back to the staged pipeline"
#: The GraphSAGE step's kernels, and the dispatcher whose telemetry
#: counter counts each kernel's launches (the others have its name).
AGGREGATION_KERNELS = ("gather_mean", "segment_sum_equal")
DISPATCHER_OF = {
    "fused_frontier_step": "fused_frontier_step_batch",
    "fused_frontier_step_wide": "fused_frontier_step_wide_batch",
    "fused_step": "fused_step_readback_batch",
    "fused_step_wide": "fused_step_readback_batch",
}

#: Loss tolerance of the card-vs-CPU runs: the same float32 math, summed in
#: another order by the card's matmul and reduction kernels, over a few SGD
#: steps.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5

STREAMS = (
    "pct_hits", "comm_volume", "comm_missed", "unique_remote", "replaced",
    "decisions", "occupancy", "step_time",
)
STORE_STREAMS = ("bytes_measured", "bytes_modeled", "feat_sums")
STATS = (
    "lookups", "hits", "misses", "replaced_total", "replacement_rounds",
    "skipped_rounds",
)
FRONTIER_OUT = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "payload2",
    "cand_next", "packed", "counters",
)
STEP_OUT = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "hit", "hit_slot",
    "placed", "slot_pos", "n_placed", "n_valid",
)
READBACK_OUT = ("ids2", "scores2", "valid2", "accessed3", "weights2", "packed")
UNIQUE_OUT = ("first", "remote", "unique_count", "remote_count")
COMPACT_OUT = ("uniq", "rem", "unique_count", "remote_count")
SCORE_OUT = ("new", "stale")


# --------------------------------------------------------------------------- #
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare_outputs(got, want, names, what: str) -> float:
    """Raise unless two output tuples are bit-identical (floats compared as
    their bit patterns); returns the max abs difference (0.0)."""
    import torch

    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    err = 0.0
    for name, a, b in zip(names, got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: {name} is None on one side only")
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(
                f"{what}: {name} {tuple(a.shape)} {a.dtype} vs "
                f"{tuple(b.shape)} {b.dtype}"
            )
        if a.dtype in (torch.float32, torch.bfloat16):
            diff = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
            err = max(err, diff)
            bits = torch.int32 if a.dtype == torch.float32 else torch.int16
            a, b = a.view(bits), b.view(bits)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")
    return err


def to_device(arrays, device):
    import numpy as np
    import torch

    return [
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in arrays
    ]


class StageClock:
    """A telemetry session for the port's off-path hooks: host time per span,
    the dispatchers' device time by CUDA events, and the inputs of every
    launch of the ``capture`` dispatchers (kept on the card for the
    full-shape checks; tensors above 32M elements — the store's tables,
    which no launch writes — and the read-only tensors in ``by_ref`` — the
    trainer's feature table — are kept by reference, so that capturing
    allocates and copies no table inside the timed spans)."""

    profile_kernels = True

    def __init__(self, capture, by_ref=()):
        self.tracer = self
        self.registry = self
        self.capture = set(capture)
        self.by_ref = {id(t) for t in by_ref}
        self.host_s = defaultdict(list)  # span name -> seconds of each call
        self.starts = defaultdict(list)  # span name -> start of each call
        self.events = defaultdict(list)  # dispatcher -> [(start, end)]
        self.launches = defaultdict(list)  # dispatcher -> [(args, kwargs)]

    # tracer
    def span(self, name, pe=-1, plane="", nbytes=0):
        return _Span(self, name)

    def begin(self, name, pe=-1, plane=""):
        return _Span(self, name).__enter__()

    # registry
    def counter(self, name, shape=None):
        return self

    def add(self, value):
        pass

    def profile_call(self, name, fn, *args, **kwargs):
        import torch

        if name not in self.capture:
            return fn(*args, **kwargs)
        self.launches[name].append(
            (
                [
                    a.clone()
                    if isinstance(a, torch.Tensor) and a.numel() <= 2**25
                    and id(a) not in self.by_ref
                    else a
                    for a in args
                ],
                dict(kwargs),
            )
        )
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.events[name].append((start, end))
        return out

    def device_ms(self, name, drop_last=False) -> list[float]:
        import torch

        torch.cuda.synchronize()
        events = self.events[name][:-1] if drop_last else self.events[name]
        return [s.elapsed_time(e) for s, e in events]

    def ms(self, span, drop_last=False) -> list[float]:
        vals = self.host_s[span][:-1] if drop_last else self.host_s[span]
        return [1e3 * s for s in vals]

    def per_step(self, span) -> list[float]:
        """ms of ``span`` summed within each ``step`` span: for a span that
        runs more than once in a step (``device.readback`` is both the
        launch's readback and the payload's ``pull_rows``)."""
        calls = list(zip(self.starts[span], self.host_s[span]))
        return [
            1e3 * sum(d for s, d in calls if t0 <= s < t0 + dur)
            for t0, dur in zip(self.starts["step"], self.host_s["step"])
        ]


class _Span:
    def __init__(self, clock, name):
        self.clock, self.name = clock, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.clock.starts[self.name].append(self.t0)
        self.clock.host_s[self.name].append(time.perf_counter() - self.t0)
        return False


def timed_ms(fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, each timed alone by
    CUDA events after an L2 flush (the step's inputs arrive cold)."""
    import torch

    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_pair(kernel, plain, flush, reps=20, library=None):
    """Kernel and plain (and library) in turns — plain, kernel, kernel,
    plain — within one call; returns ``(kernel_ms, plain_ms, library_ms,
    raw)``."""
    for fn in (kernel, plain) + ((library,) if library else ()):
        fn()
    p1 = timed_ms(plain, reps, flush)
    k1 = timed_ms(kernel, reps, flush)
    k2 = timed_ms(kernel, reps, flush)
    p2 = timed_ms(plain, reps, flush)
    lib = timed_ms(library, reps, flush) if library else None
    return (k1 + k2) / 2, (p1 + p2) / 2, lib, (k1, k2, p1, p2)


def device_us(event) -> float:
    """Device time of a profiler row (the attribute's name varies across
    torch versions)."""
    for name in ("device_time_total", "cuda_time_total"):
        value = getattr(event, name, None)
        if value:
            return float(value)
    return 0.0


def tensor_bytes(*groups) -> int:
    """Bytes of every tensor in ``groups``: each input read once, each
    output written once."""
    return sum(
        t.numel() * t.element_size()
        for g in groups
        for t in g
        if t is not None and hasattr(t, "numel")
    )


def bound(nbytes: int, nops: int, ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def frontier_ops(args) -> int:
    """Operations of the frontier step on these inputs: the row sort (Mt
    log2 Mt compares per PE) and some ten integer operations per frontier
    position and per slot and candidate (masks, ranks, probe)."""
    ids, touched_aug, cand = args[0], args[6], args[8]
    P, C = ids.shape
    Mt = touched_aug.shape[1] - 1
    K = cand.shape[1]
    return int(P * (Mt * (math.log2(max(Mt, 2)) + 10) + 10 * (C + K)))


def step_ops(args) -> int:
    """Operations of the fused step: some ten integer operations per slot,
    candidate and query (masks, ranks, placement, probe)."""
    ids, queries, cand = args[0], args[6], args[7]
    P, C = ids.shape
    return int(P * 10 * (C + queries.shape[1] + cand.shape[1]))


def device_ops_a_call(fn, reps: int = 5) -> str:
    """The device operations (kernels, memsets, copies) a call of ``fn``
    puts on the card, from torch.profiler's chrome trace: ``reps`` calls,
    each in its own ``record_function`` range, their operations matched
    to it through the correlation ids of the runtime calls made inside
    the range. The profiler can miss operations (the event list more
    often than the trace, and at times a whole single-kernel call), so
    this reports the most any call showed, the count of each call, and
    the names of the fullest call's operations, in order."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
    ) as prof:
        for i in range(reps):
            with torch.profiler.record_function(f"chip_smoke_call_{i}"):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if str(e.get("name", "")).startswith("chip_smoke_call_")
              and e.get("cat") in ("user_annotation", "cpu_op")]
    call_of = {}  # correlation id of a runtime call -> its range
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        for r in ranges:
            if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                call_of[corr] = r["name"]
    calls = {r["name"]: [] for r in ranges}
    for e in sorted(events, key=lambda e: e["ts"]):
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and corr in call_of:
            calls[call_of[corr]].append(e["name"])
    counts = [len(calls.get(f"chip_smoke_call_{i}", [])) for i in range(reps)]
    fullest = max(calls.values(), key=len, default=[])
    return (f"{max(counts, default=0)} device operations a call (each of {reps} calls: "
            f"{counts}; {', '.join(n[:44] for n in fullest)})")


def host_ms(fn, reps: int = 20) -> float:
    """Mean host time of one call of ``fn`` (what it takes to enqueue its
    work: the card is synchronised before each call, not inside it)."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * total / reps


def profile_rows(fn, reps=3) -> str:
    import torch

    with torch.profiler.profile(
        activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=device_us, reverse=True)
    dev_rows = [
        f"{e.key[:60]}={device_us(e) / reps / 1e3:.4f}ms"
        for e in rows[:8]
        if device_us(e) > 0
    ]
    return "; ".join(dev_rows) if dev_rows else "not measured"


def print_stages(tag, stage_ms, steps, wall):
    import numpy as np

    # The mean carries the first step's one-off costs (library and
    # allocator warm-up); the median is the steady step.
    for stat, fn in (("mean", np.mean), ("median", np.median)):
        print(f"{tag}: ms per step by stage, {stat} over the run: " + json.dumps(
            {k: round(float(fn(v)), 3) for k, v in stage_ms.items() if len(v)}))
    print(f"{tag}: wall {1e3 * wall / steps:.3f} ms per step; first step "
          + json.dumps({k: round(v[0], 3) for k, v in stage_ms.items() if len(v)}))


def stage_medians(clock) -> dict:
    """Median ms per step of the raw loop's stages (the drained last
    launch left out), for the side-by-side prints of phases 6 and 7."""
    import numpy as np

    return {
        k: float(np.median(v)) for k, v in {
            "step": clock.ms("step"),
            "sample_host": clock.ms("sample"),
            "launch_host": clock.ms("device.launch", True),
            "readback": clock.ms("device.readback", True),
            "train": clock.ms("train"),
        }.items() if len(v)
    }


def no_staged_launches(what, launches) -> None:
    """Raise if a device loop launched a kernel of the staged pipeline."""
    bad = {k: launches[k] for k in STAGED_KERNELS if launches[k]}
    if bad:
        raise AssertionError(f"{what}: the device loop launched {bad}")


def check_aggregation(what, launches, trainer) -> dict:
    """Raise unless a run launched the GraphSAGE step's kernels exactly
    once per PE, step and mean, plus the accuracy pass: the layer-2 mean
    on ``gather_mean`` and the layer-1 mean on ``segment_sum_equal``
    without a store, both on ``segment_sum_equal`` with one; none without
    training. Returns the expected counts."""
    calls = trainer.parts.num_parts * trainer.epochs * trainer.mb_per_epoch + 1
    if not trainer.train_model:
        calls = 0
    store = trainer.feature_store is not None
    want = {"gather_mean": 0 if store else calls,
            "segment_sum_equal": (2 if store else 1) * calls}
    got = {k: launches[k] for k in AGGREGATION_KERNELS}
    if got != want:
        raise AssertionError(f"{what}: aggregation launches {got} != {want}")
    return want


def check_captured(what, clock, max_err) -> int:
    """Hold both aggregation kernels bit-exact against their plain versions
    on every launch a run's ``clock`` captured; returns the count."""
    from repro_torch.kernels import gather_mean as gm
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as ss

    n = 0
    for name, kernel, plain in (
        ("gather_mean", gm.gather_mean_cuda, ref.gather_mean),
        ("segment_sum_equal", ss.segment_sum_equal_cuda, ref.segment_sum_equal),
    ):
        for i, (args, kw) in enumerate(clock.launches[name]):
            got, want = kernel(*args, **kw), plain(*args, **kw)
            max_err[name] = max(
                max_err[name], compare_outputs(got, want, ["out"], f"{what} {name} {i}")
            )
            n += 1
    return n


def check_store_launches(what, launches, store, trainer) -> None:
    """Raise unless a store run's gathers went where they belong: the
    per-home ``gather_rows_batch`` launches are the store's kernel gathers
    (misses and admissions), and the ``gather_rows`` launches its flat
    gathers of the training rows, one per PE and step plus the accuracy
    pass."""
    if not 0 < launches["gather_rows_batch"] == store.kernel_gathers:
        raise AssertionError(
            f"{what}: gather_rows_batch launches {launches['gather_rows_batch']} != "
            f"store kernel gathers {store.kernel_gathers}"
        )
    calls = trainer.parts.num_parts * trainer.epochs * trainer.mb_per_epoch + 1
    if not launches["gather_rows"] == store.flat_gathers == calls:
        raise AssertionError(
            f"{what}: gather_rows launches {launches['gather_rows']}, store flat "
            f"gathers {store.flat_gathers}, want P * steps + 1 = {calls}"
        )


def check_store_gathers(what, clock, max_err) -> tuple[list, list]:
    """Hold both store routes bit-exact against their plain versions on
    every launch a run's ``clock`` captured: the per-home
    ``gather_rows_batch`` and the flat ``gather_rows`` with its map.
    Returns both lists of captured launches."""
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import ref

    caps = clock.launches["gather_rows_batch"], clock.launches["gather_rows"]
    for name, kernel, plain, launches in (
        ("gather_rows_batch", gr.gather_rows_batch_cuda, ref.gather_rows_batch, caps[0]),
        ("gather_rows", gr.gather_rows_cuda, ref.gather_rows, caps[1]),
    ):
        for i, (args, kw) in enumerate(launches):
            got = kernel(*args, **kw)
            max_err[name] = max(
                max_err[name],
                compare_outputs(got, plain(*args, **kw), ["out"], f"{what} {name} {i}"),
            )
    return caps


def check_compact(keys, part_of, what) -> float:
    """The sampler's compact form of the frontier dedup on ``keys`` (and
    ``part_of``) against its plain version, bit for bit: the kernel's used
    prefixes of its id buffers equal the plain version's ids."""
    import torch

    from repro_torch.kernels import frontier_unique as fu
    from repro_torch.kernels import ref

    want = ref.frontier_unique_compact(keys, part_of)
    uniq, rem, ucount, rcount = fu.frontier_unique_compact_cuda(keys, part_of)
    torch.cuda.synchronize()
    got = (uniq[: want[0].shape[0]], None if rem is None else rem[: want[1].shape[0]],
           ucount, rcount)
    return compare_outputs(got, want, COMPACT_OUT, what)


def aggregation_in_run(tag, clock) -> dict:
    """Median device ms per launch of each aggregation kernel a run's
    ``clock`` captured (CUDA events around each dispatcher call, the host
    time between them included), printed."""
    import numpy as np

    med = {name: round(float(np.median(clock.device_ms(name))), 4)
           for name in AGGREGATION_KERNELS if clock.events[name]}
    print(f"{tag}: aggregation device ms per launch (CUDA events), median: "
          + json.dumps(med))
    return med


def gather_l2_floor(table, idx, flush) -> dict:
    """The gather's L2 floor on these inputs, by ``scripts/aggregation_ab.py``
    (the distinct rows read once from DRAM, the re-reads at the rate of an
    L2-resident read; it builds its read probe with nvcc)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import aggregation_ab

    return aggregation_ab.l2_floor(table, idx, flush)


def call_numbers(tag, what, fn, kernel) -> dict:
    """``fn`` 's kernel ``kernel`` alone (torch.profiler, 10 calls), its
    device operations a call and its host ms, printed; returns them for the
    ``kernels`` line."""
    alone = kernel_device_ms(fn, (kernel,), reps=10)[kernel]
    ops = device_ops_a_call(fn)
    host = host_ms(fn)
    print(f"{tag}: {what}: kernel alone (torch.profiler) "
          + (f"{alone:.4f} ms" if alone else "not measured")
          + f"; {ops}; wrapper host {host:.4f} ms")
    return {"kernel_alone_ms": alone, "device_ops_a_call": int(ops.split()[0]),
            "host_ms": host}


class LaunchCapture:
    """A telemetry session that keeps the inputs of chosen calls of one
    dispatcher (by call index, cloned contiguous) and counts its calls.
    Unlike :class:`StageClock` it times nothing and clones nothing else,
    so the serving loop under it runs at its own speed."""

    profile_kernels = True

    def __init__(self, name, keep):
        self.name, self.keep = name, set(keep)
        self.calls = 0
        self.kept = {}

    def profile_call(self, name, fn, *args, **kwargs):
        import torch

        if name == self.name:
            if self.calls in self.keep:
                self.kept[self.calls] = (
                    [a.clone(memory_format=torch.contiguous_format)
                     if isinstance(a, torch.Tensor) else a for a in args],
                    dict(kwargs),
                )
            self.calls += 1
        return fn(*args, **kwargs)


class ServeCapture(LaunchCapture):
    """:class:`LaunchCapture` that also watches ``moe_forward``: it keeps
    each call's input (cloned), for the experts a step touches, or with
    ``timed=True`` times each call by CUDA events instead."""

    def __init__(self, name="", keep=(), timed=False):
        super().__init__(name, keep)
        self.timed = timed
        self.moe_inputs, self.moe_events = [], []

    def profile_call(self, name, fn, *args, **kwargs):
        import torch

        if name != "moe_forward":
            return super().profile_call(name, fn, *args, **kwargs)
        if not self.timed:
            self.moe_inputs.append(args[2].detach().clone())
            return fn(*args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.moe_events.append((start, end))
        return out


def serve_prompts(cfg, device):
    """The prompts ``serve_batch`` draws for ``SERVE`` (its own rng)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SERVE["seed"])
    prompts = rng.integers(1, min(cfg.vocab_size, 1000),
                           size=(SERVE["requests"], SERVE["prompt_len"]))
    return torch.from_numpy(prompts.astype(np.int32)).to(device)


def expert_bytes(cfg, used: int) -> int:
    """Bytes of weights a MoE layer reads with ``used`` routed experts in
    use: their three matrices, the shared experts' and the float32
    router."""
    m = cfg.moe
    width = 2 if cfg.dtype == "bfloat16" else 4
    return ((used + m.num_shared_experts) * 3 * cfg.d_model * m.d_ff_expert * width
            + cfg.d_model * m.num_experts * 4)


def experts_touched(cfg, router, x) -> int:
    from repro_torch.models import moe

    return moe._route(cfg, router, x.reshape(-1, x.shape[-1]))[1].unique().numel()


def moe_layer_alone(cfg, p, x, flush, reps=5) -> dict:
    """One MoE layer (``moe_forward`` on its captured input ``x``): device
    ms by CUDA events (L2 flushed, mean of ``reps`` after a warm call), the
    experts it reads and their bytes, the HBM bound of those bytes, and
    what a host read of its expert counts would cost (``bincount`` of its
    routing copied to the host: host ms, median of 20 on the idle card;
    ``moe_forward`` itself reads nothing back)."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    with torch.no_grad():
        moe.moe_forward(cfg, p, x)
        ms = timed_ms(lambda: moe.moe_forward(cfg, p, x), reps, flush)
        idx = moe._route(cfg, p["router"], x.reshape(-1, x.shape[-1]))[1].reshape(-1)
        reads = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.bincount(idx, minlength=cfg.moe.num_experts).tolist()
            reads.append(1e3 * (time.perf_counter() - t0))
    used = idx.unique().numel()
    nbytes = expert_bytes(cfg, used)
    return {"tokens": x.shape[0] * x.shape[1], "ms": ms, "experts": used,
            "expert_bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "count_read_ms": float(np.median(reads))}


def decode_alone(cfg, params, prompts, gen_len, session, frames=None):
    """The decode step alone over the prompt (teacher-forced) and
    ``gen_len`` greedy tokens, each step ending in a sync: host ms and
    CUDA-event ms per step, the ``moe_forward`` event ms inside each step
    (``session`` timed), and the logits at the prompt's last position.
    Whisper's cross cache is filled from ``frames`` first (not timed)."""
    import torch

    from repro_torch import telemetry
    from repro_torch.models import model as M

    B, P = prompts.shape
    steps = P + gen_len
    cache = M.init_cache(cfg, B, steps + 1, device=prompts.device)
    if frames is not None:
        M.prefill_cross_cache(cfg, params, cache, frames)
    host_ms, dev_ms, moe_ms, at_prompt = [], [], [], None
    tok = prompts[:, :1]
    with torch.no_grad(), telemetry.active(session):
        for t in range(steps):
            torch.cuda.synchronize()
            n0 = len(session.moe_events)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            logits, cache = M.decode_step(cfg, params, cache, tok, t)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            end.record()
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            dev_ms.append(start.elapsed_time(end))
            moe_ms.append(sum(s.elapsed_time(e) for s, e in session.moe_events[n0:]))
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"decode step {t}: logits not all finite")
            if t == P - 1:
                at_prompt = logits[:, -1].clone()
            tok = prompts[:, t + 1 : t + 2] if t + 1 < P else nxt
    return host_ms, dev_ms, moe_ms, at_prompt


def prefill_check(tag, cfg, params, prompts, at_prompt, session, runs=2, extra=None) -> dict:
    """``make_prefill_step`` on the prompts and ``extra`` inputs (Whisper's
    frames; ``runs`` times, each synced: wall s), its last-position logits
    against the decode path's at the same position."""
    import torch

    from repro_torch import telemetry
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    walls = []
    with torch.no_grad(), telemetry.active(session):
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = prefill(params, {"tokens": prompts, **(extra or {})})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    if tuple(last.shape) != (prompts.shape[0], cfg.vocab_size) or not bool(
            torch.isfinite(last).all()):
        raise AssertionError(f"{tag}: prefill logits {tuple(last.shape)} not all finite")
    diff = (last - at_prompt).abs().max().item()
    scale = at_prompt.abs().max().item()
    same = (last.argmax(-1) == at_prompt.argmax(-1)).sum().item()
    print(f"{tag}: make_prefill_step on the prompts ({tuple(prompts.shape)}): wall "
          + ", ".join(f"{w:.3f}" for w in walls) + " s (the first includes warm-up); "
          f"last-position logits vs the decode path's at position {prompts.shape[1] - 1}: "
          f"max |diff| {diff:.4g}, {diff / max(scale, 1e-30):.4g} of max |logits| "
          f"{scale:.4g}; greedy token equal on {same} of {prompts.shape[0]} requests")
    return {"prefill_s": walls, "max_abs_diff": diff, "ratio": diff / max(scale, 1e-30)}


def serve_numbers(tag, cfg, served, host_ms, dev_ms, moe_ms, peak_gb) -> None:
    import numpy as np

    share = [m / d for m, d in zip(moe_ms, dev_ms) if d > 0]
    print(f"{tag}: serve_batch: prefill {served['prefill_s']:.3f} s, decode "
          f"{served['decode_s']:.3f} s ({1e3 * served['decode_s'] / SERVE['gen_len']:.3f} ms "
          f"per step), {served['tokens_per_s']:.1f} tokens/s; peak memory {peak_gb:.2f} GB")
    print(f"{tag}: decode step alone (synced): host median {np.median(host_ms):.3f} ms, "
          f"min {np.min(host_ms):.3f}; CUDA events median {np.median(dev_ms):.3f} ms over "
          f"{len(dev_ms)} steps"
          + (f"; MoE layers {np.median(moe_ms):.3f} ms a step (CUDA events around each "
             f"moe_forward), {100 * np.median(share):.1f}% of the step (median)"
             if any(moe_ms) else ""))


def zoo_card_vs_cpu(arch, dev, overrides=None) -> dict:
    """Phase 9c for one architecture: its smoke config in float32 from the
    same weights on the CPU and the card. ``serve_batch`` tokens equal;
    8 decode positions' logits and the prefill step's allclose 1e-4; the
    card's MLA launches all on the CUDA-core kernel (GQA: none);
    ``forward`` vs token-by-token decode on the card within 1e-3 x
    max(|logits|, 1) (S = 14 past the window of 8 for a windowed
    config); a MoE config's decode twice on the card, bit-identical.
    Whisper's decode attends to the cross cache of the same frames on both
    devices, and its prefill and forward read them; Phi-3-vision's prefill
    reads the same patches. ``overrides`` change the config (phase 17:
    expert parallelism); forward vs decode runs only where no MoE copy can
    be dropped (a capacity drop in the forward's longer sequence is a
    different result)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    small = get_smoke_config(arch).with_overrides(dtype="float32", **(overrides or {}))
    tree = _numpy_tree(M.init_params(small, 7, device="cpu"))
    B = SERVE_SMALL["requests"]
    toks_np = np.random.default_rng(5).integers(1, small.vocab_size, size=(B, 8)).astype(np.int32)
    media = {}  # Whisper's frames, Phi-3-vision's patches
    if small.encoder_layers:
        media["frames"] = np.random.default_rng(8).normal(
            0, 0.02, size=(B, small.encoder_seq, small.d_model)).astype(np.float32)
    if small.frontend == "vision":
        media["patches"] = np.random.default_rng(8).normal(
            0, 0.02, size=(B, small.num_patches, M.VISION_EMBED_DIM)).astype(np.float32)

    def on(where, rows=B):
        return {k: torch.from_numpy(v[:rows]).to(where) for k, v in media.items()}

    def decode_logits(p, where, toks):
        cache = M.init_cache(small, toks.shape[0], toks.shape[1] + 2, device=where)
        if small.encoder_layers:
            M.prefill_cross_cache(small, p, cache, on(where, toks.shape[0])["frames"])
        out = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, cache = M.decode_step(small, p, cache, toks[:, t : t + 1], t)
                out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    runs = []
    for where in ("cpu", DEVICE):
        p_dev = M.params_from_jax(tree, where)
        toks = torch.from_numpy(toks_np).to(where)
        native.reset_launches()
        mla0 = dict(md.KERNEL_LAUNCHES)
        res = serve_mod.serve_batch(arch, cfg=small, params=p_dev, device=where, **SERVE_SMALL)
        logits = decode_logits(p_dev, where, toks)
        with torch.no_grad():
            last = make_prefill_step(small)(p_dev, {"tokens": toks, **on(where)})
        mla = {k: v - mla0[k] for k, v in md.KERNEL_LAUNCHES.items()}
        runs.append((res["tokens"], logits.cpu(), last.cpu(), dict(native.LAUNCHES), mla, p_dev))
    (tok_cpu, log_cpu, last_cpu, l_cpu, _, _), (tok_card, log_card, last_card, l_card, mla,
                                                 p_card) = runs
    mla_layers = sum(1 for k in M.layer_kinds(small) if small.attn_type == "mla")
    n_small = mla_layers * (SERVE_SMALL["prompt_len"] + SERVE_SMALL["gen_len"] + 8)
    others = {k: v for k, v in l_card.items() if v and k != "mla_flash_decode"}
    if (any(l_cpu.values()) or others or l_card["mla_flash_decode"] != n_small
            or mla != {"tensor_cores": 0, "cuda_cores": n_small}):
        raise AssertionError(f"phase 9c ({arch}): launches cpu {l_cpu}, card {l_card}, MLA "
                             f"kernels {mla}, want {n_small} (float32: the CUDA-core kernel)")
    if not np.array_equal(tok_cpu, tok_card):
        raise AssertionError(f"phase 9c ({arch}): greedy tokens differ:\n{tok_cpu}\n{tok_card}")
    for what, a, b in (("decode", log_card, log_cpu), ("prefill", last_card, last_cpu)):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"phase 9c ({arch}): {what} logits differ beyond 1e-4 (max "
                                 f"|diff| {(a - b).abs().max().item():.3g})")
    row = {"tokens": list(tok_card.shape), "decode_diff": (log_card - log_cpu).abs().max().item(),
           "prefill_diff": (last_card - last_cpu).abs().max().item(), "mla_launches": n_small}
    m = small.moe
    if small.ep_axis and small.ep_capacity_factor * m.experts_per_token < m.num_experts:
        row["fwd_vs_dec"] = "not run: copies can drop"
    else:
        row.update(forward_vs_decode(small, p_card, dev, decode_logits, on))
    if small.moe.num_experts:
        twice = [decode_logits(p_card, dev, torch.from_numpy(toks_np).to(dev)) for _ in range(2)]
        if not torch.equal(*twice):
            raise AssertionError(f"phase 9c ({arch}): two card decodes differ")
        row["moe_bit_identical"] = True
    return row


def forward_vs_decode(small, p_card, dev, decode_logits, on) -> dict:
    """``forward`` against token-by-token decode on the card, within 1e-3
    x max(|logits|, 1) (S = 14 past the window of 8 for a windowed
    config)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    S = 14 if small.sliding_window else 10
    seq = torch.from_numpy(np.random.default_rng(6).integers(
        0, small.vocab_size, size=(1, S)).astype(np.int32)).to(dev)
    with torch.no_grad():
        full, _ = M.forward(small, p_card, seq, frames=on(dev, 1).get("frames"))
    dec = decode_logits(p_card, dev, seq)
    err = (dec - full).abs().max().item()
    scale = full.abs().max().item()
    if not err < 1e-3 * max(scale, 1.0):
        raise AssertionError(f"phase 9c ({small.name}): forward vs decode {err} at scale {scale}")
    return {"fwd_vs_dec": err, "S": S}


def train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one training step of ``lm_loss``: 3 x the forward's
    matrix products (the backward's are twice the forward's), attention's
    S x S products counted whole, as the plain attention computes them
    (mask included), MoE layers at their top-k experts a token, the
    unembedding over all S positions and DeepSeek-V3's MTP head (its
    projection, block and unembedding over S - 1 and S - 2 positions).
    The recurrent layers count their projections and their scans' products
    a step (Mamba2's state read, mLSTM's ``C q`` and ``n q``, sLSTM's input
    and recurrent gate products); mLSTM's scan products count 4 x, since
    its chunk checkpoint runs them again in backward, and sLSTM's first
    recurrent product has no input gradient (its ``h`` starts at zeros).
    Whisper adds its encoder layers over ``encoder_seq`` frames and each
    decoder layer's cross attention (queries and output over the tokens,
    keys and values over the frames, S x ``encoder_seq`` products);
    Phi-3-vision runs its layers and unembedding over the patches and the
    text, and its projector's backward has no input gradient (the patches
    are data). ``tests/test_torch_train.py``, ``test_torch_whisper.py`` and
    ``test_torch_vision.py`` hold it to ``FlopCounterMode``'s count."""
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    d, h = cfg.d_model, cfg.num_heads

    def mlp(f):
        return (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * f

    def layer(kind, s):
        """The forward's products, and what the backward runs beyond 2 x."""
        if kind == "mamba2":
            e, heads, n = ssm.mamba2_dims(cfg)
            return 2 * batch * s * (d * (2 * e + 2 * n + heads) + e * n + e * d), 0
        if kind == "mlstm":
            e, heads, hd = ssm.mlstm_dims(cfg)
            scan = 2 * batch * s * e * (hd + 1)
            return 2 * batch * s * (2 * d * e + 3 * e * e + 2 * e * heads + e * d) + scan, scan
        if kind == "slstm":
            f = int(cfg.ssm.proj_factor_slstm * d)
            return 2 * batch * s * (8 * d * d + 3 * d * f), -2 * batch * d * 4 * d
        if cfg.attn_type == "mla" and kind in ("dense", "moe", "attn"):
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            proj = (d * m.q_lora_rank + m.q_lora_rank * h * qk + d * m.kv_lora_rank
                    + d * m.qk_rope_head_dim
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    + h * m.v_head_dim * d)
            att = batch * h * s * s * (qk + m.v_head_dim)
        else:
            proj = d * cfg.head_dim * 2 * (h + cfg.num_kv_heads)
            att = batch * h * s * s * 2 * cfg.head_dim
        e = cfg.moe
        if kind == "moe":
            ffn = d * e.num_experts + e.experts_per_token * mlp(e.d_ff_expert)
            ffn += mlp(e.d_ff_expert * e.num_shared_experts) if e.num_shared_experts else 0
        else:
            ffn = mlp(e.d_ff_dense if kind == "dense" else cfg.d_ff)
        cross = 0
        if kind == "dec":
            hd, se = cfg.head_dim, cfg.encoder_seq
            cross = 2 * (batch * s * 2 * d * h * hd + batch * se * 2 * d * cfg.num_kv_heads * hd
                         + batch * h * s * se * 2 * hd)
        return 2 * (batch * s * (proj + ffn) + att) + cross, 0

    prefix = cfg.num_patches if cfg.frontend == "vision" else 0
    counts = [layer(k, seq + prefix) for k in M.layer_kinds(cfg)]
    counts += [layer("enc", cfg.encoder_seq)] * cfg.encoder_layers
    fwd = sum(c[0] for c in counts)
    fwd += 2 * batch * (seq + prefix) * d * cfg.vocab_size
    projector = 2 * batch * prefix * M.VISION_EMBED_DIM * d
    fwd += projector
    if cfg.mtp:
        fwd += 2 * batch * (seq - 1) * 2 * d * d
        fwd += layer("dense" if cfg.moe.num_experts else "attn", seq - 1)[0]
        fwd += 2 * batch * (seq - 2) * d * cfg.vocab_size
    return 3 * fwd + sum(c[1] for c in counts) - projector


def train_full_width(arch, layers, batch, seq, lr, dev, tag="phase 14", remat_steps=2,
                     split=True) -> dict:
    """Phase 14 (and 15c) for one architecture: ``TRAIN_STEPS`` steps of
    ``launch.train.train`` at full width (cut to ``layers`` when given),
    every loss and metric finite, the last loss below the first, no native
    kernel launched; the step times (the first apart), tokens/s, peak
    memory and the model FLOPs' share of the bf16 peak; then from the
    trained parameters and fresh moments, on the next batch, the gradient
    with ``remat=False`` and ``remat_steps`` train steps with
    ``remat=True``: losses within ``REMAT_TOL`` relative, each pass's peak
    memory; with ``split``, one step split by CUDA events and one under
    torch.profiler (``train_step_split``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.with_overrides(num_layers=layers)
    tag = f"{tag} ({arch})"
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    res = train(arch, cfg=cfg, steps=TRAIN_STEPS, batch=batch, seq=seq, lr=lr, seed=0,
                log_every=TRAIN_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = no_launches(tag, mla0)
    bad = [m for m in res["metrics"] if not all(np.isfinite(v) for v in m.values())]
    if bad or not res["last_loss"] < res["first_loss"]:
        raise AssertionError(f"{tag}: metrics {res['metrics']}")
    params = res["params"]
    n_params = sum(t.numel() for t in _leaves(params))
    step_s = res["step_s"]
    median = float(np.median(step_s[1:]))
    flops = train_flops(cfg, batch, seq)
    row = {
        "layers": cfg.num_layers, "groups": [list(g) for g in M.scan_groups(cfg)],
        "params": n_params, "state_bytes": M.train_state_bytes(cfg), "batch": batch,
        "seq": seq, "lr": lr, "losses": res["losses"], "metrics_last": res["metrics"][-1],
        "first_step_ms": 1e3 * step_s[0], "step_ms_median": 1e3 * median,
        "step_ms": [1e3 * t for t in step_s], "tokens_per_s": batch * seq / median,
        "peak_bytes": peak, "held_before_bytes": held, "flops_per_step": flops,
        "tflops_per_s": flops / median / 1e12,
        "flop_share_of_bf16_peak": flops / median / BF16_TENSOR_OPS_PER_S, "wall_s": wall,
        "launches": launches,
    }
    del res
    # One more batch, from the trained parameters and fresh moments.
    pipe = TokenPipeline(cfg, batch, seq, seed=0)
    for _ in range(TRAIN_STEPS):
        pipe.next_batch()
    nxt = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    opt = adamw_init(params, cfg.opt_dtype)
    torch.cuda.reset_peak_memory_stats()
    loss_nr, _, grads = loss_and_grads(cfg, params, nxt, remat=False)
    loss_nr = float(loss_nr)
    peak_nr = torch.cuda.max_memory_allocated() - held
    del grads
    torch.cuda.reset_peak_memory_stats()
    remat_step = make_train_step(cfg, lr=lr, remat=True)
    remat_ms = []
    for i in range(remat_steps):  # the first call also sets up the checkpointing
        t0 = time.perf_counter()
        _, _, metrics = remat_step(params, opt, nxt)
        loss = float(metrics["loss"])  # waits for the step
        remat_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            loss_r = loss
    peak_r = torch.cuda.max_memory_allocated() - held
    if not abs(loss_r - loss_nr) <= REMAT_TOL * abs(loss_nr):
        raise AssertionError(f"{tag}: remat loss {loss_r} vs {loss_nr}")
    row.update(remat_loss=loss_r, no_remat_loss=loss_nr, remat_step_ms=remat_ms,
               remat_step_peak_bytes=peak_r, no_remat_grad_peak_bytes=peak_nr)
    if split:
        row.update(train_step_split(cfg, params, opt, nxt, lr))
    del params, opt, metrics, nxt
    torch.cuda.empty_cache()
    return row


def train_step_split(cfg, params, opt, batch, lr) -> dict:
    """Where a ``remat=False`` train step's time goes: the gradient pass
    and the AdamW update by CUDA events (one step, host clock around it);
    then one step under torch.profiler: the device's busy time (every
    kernel, memset and copy the trace recorded) against the step's host
    time, and the largest kernels."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw_update

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    _, _, grads = loss_and_grads(cfg, params, batch, remat=False)
    ev[1].record()
    adamw_update(params, grads, opt, lr)
    ev[2].record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    # The update's least bytes: parameters and both moments read and
    # written once, the gradients read once.
    update_bytes = sum(2 * t.nbytes for t in (*_leaves(params), *_leaves(opt.m), *_leaves(opt.v)))
    update_bytes += sum(t.nbytes for t in _leaves(grads))
    del grads
    step = make_train_step(cfg, lr=lr, remat=False)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kernels = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name[:48]] += e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:6]
    return {"grad_ms": ev[0].elapsed_time(ev[1]), "update_ms": ev[1].elapsed_time(ev[2]),
            "update_bytes": update_bytes, "update_bound_ms": 1e3 * update_bytes / HBM_BYTES_PER_S,
            "split_host_ms": host_ms, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy if busy else None,
            "device_busy_share": busy / prof_ms if busy else None,
            "top_kernels_ms": {k: round(v, 3) for k, v in top}}


def print_train_row(arch, row, tag="phase 14") -> None:
    """Phase 14's (or 15c's) lines for one architecture."""
    batch, seq = row["batch"], row["seq"]
    print(f"{tag}: {arch} ({row['layers']} layers {row['groups']}, {row['params']} "
          f"parameters, {row['state_bytes']} bytes of parameters, gradients and moments), "
          f"batch {batch} x seq {seq}, {TRAIN_STEPS} steps at lr {row['lr']}: losses "
          f"{[round(x, 4) for x in row['losses']]} (last below first, every metric "
          f"finite; last {({k: round(v, 4) for k, v in row['metrics_last'].items()})}); "
          f"no native kernel launched")
    print(f"{tag}: {arch}: first step {row['first_step_ms']:.1f} ms, then median "
          f"{row['step_ms_median']:.1f} ms a step ({[round(x, 1) for x in row['step_ms']]}), "
          f"{row['tokens_per_s']:.0f} tokens/s; peak {row['peak_bytes'] / 1e9:.2f} GB above "
          f"the {row['held_before_bytes'] / 1e9:.2f} GB held before; {row['flops_per_step']:.4g} "
          f"model FLOPs a step, {row['tflops_per_s']:.1f} TFLOP/s = "
          f"{100 * row['flop_share_of_bf16_peak']:.1f}% of the {BF16_TENSOR_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s dense bf16 peak; wall {row['wall_s']:.1f} s")
    print(f"{tag}: {arch}: the next batch from the trained state: remat=True step loss "
          f"{row['remat_loss']:.6f} vs remat=False {row['no_remat_loss']:.6f} (within "
          f"{REMAT_TOL}); peak {row['remat_step_peak_bytes'] / 1e9:.2f} GB "
          f"({len(row['remat_step_ms'])} remat steps, "
          + " and ".join(f"{x:.1f}" for x in row["remat_step_ms"]) + " ms) vs "
          f"{row['no_remat_grad_peak_bytes'] / 1e9:.2f} GB (remat=False gradient)")
    if "grad_ms" not in row:
        return
    busy = (f"{row['device_busy_ms']:.1f} ms of kernels = "
            f"{100 * row['device_busy_share']:.1f}% busy" if row["device_busy_ms"]
            else "device time not measured")
    print(f"{tag}: {arch}: one step split by CUDA events: gradient pass "
          f"{row['grad_ms']:.1f} ms, AdamW update {row['update_ms']:.1f} ms (its "
          f"{row['update_bytes']} bytes' HBM bound {row['update_bound_ms']:.1f} ms; host "
          f"{row['split_host_ms']:.1f} ms); one step under torch.profiler "
          f"{row['profiled_step_ms']:.1f} ms, {busy}; largest kernels (ms) "
          + json.dumps(row["top_kernels_ms"]))


def zoo_train_card_vs_cpu(arch, dev, overrides=None) -> dict:
    """Phase 14c for one architecture: its smoke config in float32 from the
    same weights and batches on the CPU and the card: the step-1 gradients
    of every leaf within ``TRAIN_TOL`` x its largest, ``train``'s losses
    over ``TRAIN_SMALL["steps"]`` steps within ``TRAIN_TOL`` relative, no
    native launch; the card's run saves a checkpoint, which loads on the
    CPU bit for bit equal to the card's parameters. ``overrides`` change
    the config (phase 17: expert parallelism)."""
    import numpy as np
    import torch

    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import native
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train
    from repro_torch.models import model as M

    small = get_smoke_config(arch).with_overrides(dtype="float32", **(overrides or {}))
    tree = _numpy_tree(M.init_params(small, 7, device="cpu"))
    first = TokenPipeline(small, TRAIN_SMALL["batch"], TRAIN_SMALL["seq"],
                          seed=TRAIN_SMALL["seed"]).next_batch()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "params.msgpack")
        for where in ("cpu", DEVICE):
            p = M.params_from_jax(tree, where)
            _, _, grads = loss_and_grads(
                small, p, {k: torch.from_numpy(v).to(where) for k, v in first.items()},
                remat=False)
            native.reset_launches()
            res = train(arch, cfg=small, params=p, log_every=TRAIN_SMALL["steps"], device=where,
                        ckpt_path=path if where == DEVICE else None, **TRAIN_SMALL)
            if any(native.LAUNCHES.values()):
                raise AssertionError(f"phase 14c ({arch}): launches {dict(native.LAUNCHES)}")
            runs[where] = ([g.cpu() for g in _leaves(grads)], res["losses"],
                           [t.cpu() for t in _leaves(res["params"])], res["params"])
        loaded = load_checkpoint(path, runs["cpu"][3])
    (g_cpu, l_cpu, _, _), (g_card, l_card, p_card, _) = runs["cpu"], runs[DEVICE]
    grad_err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(g_card, g_cpu))
    if not grad_err <= TRAIN_TOL:
        raise AssertionError(f"phase 14c ({arch}): step-1 gradients differ by {grad_err:.3g} "
                             f"of a leaf's largest")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if not loss_err <= TRAIN_TOL:
        raise AssertionError(f"phase 14c ({arch}): losses {l_card} vs {l_cpu}")
    got = list(_leaves(loaded))
    if len(got) != len(p_card) or not all(
            a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, p_card)):
        raise AssertionError(f"phase 14c ({arch}): the card's checkpoint does not load equal")
    return {"losses": [float(f"{x:.6g}") for x in l_card], "loss_rel_diff": loss_err,
            "grad_rel_diff": grad_err, "leaves": len(got)}


def cache_bytes(cache) -> tuple[int, int, int]:
    """Bytes of a decode cache: the attention keys and values (``k``,
    ``v``), the recurrent state, and Whisper's cross keys and values
    (``ck``, ``cv``)."""
    kv = state = cross = 0
    for group in cache:
        for layer in group.values():
            for name, t in layer.items():
                if name in ("k", "v"):
                    kv += t.nbytes
                elif name in ("ck", "cv"):
                    cross += t.nbytes
                else:
                    state += t.nbytes
    return kv, state, cross


def decode_bound(param_bytes, cache, slots) -> dict:
    """The least bytes a decode step moves: every parameter the step reads
    once (the tied unembedding reads the whole table), the whole attention
    cache read (the plain attention scores every slot and masks) and one
    slot of it written, the recurrent state read and written, the cross
    keys and values read; over the card's HBM rate."""
    kv, state, cross = cache_bytes(cache)
    nbytes = param_bytes + kv + kv // slots + 2 * state + cross
    return {"bytes": nbytes, "kv_bytes": kv, "state_bytes": state, "cross_bytes": cross,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def saved_bytes(cfg, batch: int, seq: int, remat: bool) -> int:
    """Predicted bytes the recurrences keep for backward at their largest,
    beyond the parameters, gradients and moments: a Mamba2 layer keeps one
    float32 state (B, H, hd, N) a step; an mLSTM layer keeps its carry at
    each chunk's start and, while one chunk runs again in backward, two
    (B, H, hd, hd) float32 tensors a step of it (the memory before the
    forget gate and the outer product's); sLSTM's (B, D) tensors are left
    out. With ``remat`` only the unit running again in backward keeps its
    steps: its layers of the largest group."""
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    _, heads, n = ssm.mamba2_dims(cfg)
    _, m_heads, m_hd = ssm.mlstm_dims(cfg)
    memory = batch * m_heads * m_hd * m_hd * 4
    ck = ssm.MLSTM_CHUNK if seq % ssm.MLSTM_CHUNK == 0 else 1
    kept = {"mamba2": seq * batch * heads * cfg.ssm.head_dim * n * 4,
            "mlstm": (seq // ck) * memory}
    kinds = max((u for u, _ in M.scan_groups(cfg)), key=len) if remat else M.layer_kinds(cfg)
    chunk = 2 * ck * memory if "mlstm" in kinds else 0
    return sum(kept.get(k, 0) for k in kinds) + chunk


def ssm_serve(arch, dev) -> dict:
    """Phase 15 for one architecture: the published config whole in bf16
    (random weights from ``SERVE["seed"]``) through ``serve_batch`` with
    ``SERVE``'s requests; the decode step alone (host and CUDA-event ms),
    ``make_prefill_step`` against the decode path at the prompt's last
    position, tokens/s, peak memory and the step's bytes bound; no native
    kernel launched in the phase."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M

    tag = f"phase 15 ({arch})"
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{tag}: {cfg.num_layers} layers {M.scan_groups(cfg)}, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters, {M.param_bytes(cfg)} bytes "
          f"from seed {SERVE['seed']} in {time.perf_counter() - t0:.3f} s")
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    served = serve_mod.serve_batch(arch, cfg=cfg, params=params, device=DEVICE, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = served["tokens"]
    if tokens.shape != (SERVE["requests"], SERVE["gen_len"]) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: tokens {tokens.shape}, range {tokens.min()}..{tokens.max()}")
    prompts = serve_prompts(cfg, dev)
    host_ms, dev_ms, moe_ms, at_prompt = decode_alone(cfg, params, prompts, SERVE["gen_len"],
                                                      ServeCapture(timed=True))
    peak = torch.cuda.max_memory_allocated() - held
    serve_numbers(tag, cfg, served, host_ms, dev_ms, moe_ms, peak / 1e9)
    slots = SERVE["prompt_len"] + SERVE["gen_len"] + 1
    bound = decode_bound(M.param_bytes(cfg), M.init_cache(cfg, SERVE["requests"], slots,
                                                          device="meta"), slots)
    print(f"{tag}: serve_batch wall {wall:.2f} s; the decode step's bound: {bound['bytes']} "
          f"bytes (parameters {M.param_bytes(cfg)}, attention cache {bound['kv_bytes']} read, "
          f"recurrent state {bound['state_bytes']} read and written) at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound['bound_ms']:.4f} ms, "
          f"{100 * bound['bound_ms'] / np.median(dev_ms):.2f}% of the CUDA-event median, "
          f"{100 * bound['bound_ms'] / np.median(host_ms):.2f}% of the host median")
    pre = prefill_check(tag, cfg, params, prompts, at_prompt, ServeCapture())
    launches = no_launches(tag, mla0)
    print(f"{tag}: no native kernel launched (the recurrences and attention are plain "
          f"PyTorch, as the reference's are plain jnp)")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": served["tokens_per_s"],
            "step_host_ms": float(np.median(host_ms)), "step_dev_ms": float(np.median(dev_ms)),
            "bound_ms": bound["bound_ms"], "peak_bytes": peak, "prefill": pre}


def long_context(arch, dev) -> dict:
    """Phase 15b for one architecture: ``long_500k`` (batch 1, a cache of
    524,288 positions, ``long_mode=True``), ``LONG_STEPS`` greedy decode
    steps from position 524,288 - ``LONG_STEPS``: logits finite, ms a
    step (host and CUDA events), the step's bytes bound, the peak memory
    with the cache. xLSTM-350M's last step is taken again at position 5
    from a copy of the same state: logits and state bit-identical (its
    decode does not read ``pos``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import native
    from repro_torch.launch.steps import SHAPES
    from repro_torch.models import model as M

    tag = f"phase 15b ({arch})"
    cfg = get_config(arch)
    shape = SHAPES["long_500k"]
    B, S = shape["batch"], shape["seq"]
    force_local = shape["long"] and cfg.local_global
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    t0 = time.perf_counter()
    cache = M.init_cache(cfg, B, S, long_mode=shape["long"], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kv, state, _ = cache_bytes(cache)
    bound = decode_bound(M.param_bytes(cfg), cache, S)
    native.reset_launches()
    tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
    host_ms, dev_ms, same = [], [], None
    with torch.no_grad():
        for i in range(LONG_STEPS):
            pos = S - LONG_STEPS + i
            last = i == LONG_STEPS - 1 and cfg.arch_type == "ssm"
            if last:
                twin = [{b: {k: t.clone() for k, t in layer.items()} for b, layer in g.items()}
                        for g in cache]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            logits, cache = M.decode_step(cfg, params, cache, tok, pos, force_local=force_local)
            end.record()
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            dev_ms.append(start.elapsed_time(end))
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{tag}: logits at position {pos} not all finite")
            if last:
                early, twin = M.decode_step(cfg, params, twin, tok, 5, force_local=force_local)
                same = torch.equal(early, logits) and all(
                    torch.equal(a, b) for a, b in zip(_leaves(twin), _leaves(cache)))
                if not same:
                    raise AssertionError(f"{tag}: the step at position {pos} and at 5 differ")
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    peak = torch.cuda.max_memory_allocated() - held
    if any(native.LAUNCHES.values()):
        raise AssertionError(f"{tag}: native launches {dict(native.LAUNCHES)}, want none")
    print(f"{tag}: batch {B}, cache {S} (long_mode): {LONG_STEPS} steps from position "
          f"{S - LONG_STEPS}, logits finite, no native launch; cache {kv} bytes of keys and "
          f"values + {state} bytes of recurrent state, made in {init_s:.3f} s; a step: host "
          f"median {np.median(host_ms):.3f} ms, CUDA events median {np.median(dev_ms):.3f} ms "
          f"({[round(x, 3) for x in dev_ms]}); bound {bound['bytes']} bytes = "
          f"{bound['bound_ms']:.4f} ms ({100 * bound['bound_ms'] / np.median(dev_ms):.1f}% of "
          f"the CUDA-event median); peak {peak / 1e9:.3f} GB with the parameters and cache"
          + ("; the last step again at position 5 from a copy of its state: logits and state "
             "bit-identical" if same else ""))
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": dict(native.LAUNCHES), "step_host_ms": float(np.median(host_ms)),
            "step_dev_ms": float(np.median(dev_ms)), "bound_ms": bound["bound_ms"],
            "cache_bytes": kv + state, "peak_bytes": peak, "pos_independent": same}


def serve_frames(cfg, device):
    """The frames ``serve_batch`` draws for ``SERVE``: from its generator
    after the prompts, in the model's dtype."""
    import numpy as np
    import torch

    from repro_torch.models.common import dtype_of

    rng = np.random.default_rng(SERVE["seed"])
    rng.integers(1, min(cfg.vocab_size, 1000), size=(SERVE["requests"], SERVE["prompt_len"]))
    frames = rng.normal(0, 0.02, size=(SERVE["requests"], cfg.encoder_seq, cfg.d_model))
    return torch.from_numpy(frames).to(dtype_of(cfg)).to(device)


def no_launches(tag, mla0) -> dict:
    """The native launches since the last ``reset_launches`` (and the MLA
    kernels' since ``mla0``); raises unless there are none."""
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native

    launches = dict(native.LAUNCHES)
    mla = {k: v - mla0[k] for k, v in md.KERNEL_LAUNCHES.items() if v != mla0[k]}
    if any(launches.values()) or mla:
        raise AssertionError(f"{tag}: native launches {launches}, MLA kernels {mla}, want none")
    return launches


def audio_serve(dev) -> dict:
    """Phase 16: Whisper-large-v3 whole in bf16 (random weights from
    ``SERVE["seed"]``) through ``serve_batch`` with ``SERVE``'s requests,
    each with 1500 frames: the encoder and cross cache (``serve_batch``'s
    ``encode_s``, and ``prefill_cross_cache`` again alone: host and
    CUDA-event ms), the decode step alone (host and CUDA-event ms),
    ``make_prefill_step`` with the frames against the decode path at the
    prompt's last position, tokens/s, peak memory and the decode step's
    bound (the decoder's parameters read once, the self-attention cache,
    the cross keys and values); no native kernel launched."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M

    tag = f"phase 16 ({AUDIO_ARCH})"
    cfg = get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    enc_bytes = sum(t.nbytes for k in ("enc_groups", "enc_final_norm")
                    for t in _leaves(params[k]))
    print(f"{tag}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers "
          f"{M.scan_groups(cfg)}, d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.encoder_seq} frames, "
          f"{cfg.dtype}: {n_params} parameters, {M.param_bytes(cfg)} bytes ({enc_bytes} of them "
          f"the encoder's) from seed {SERVE['seed']} in {time.perf_counter() - t0:.3f} s")
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    served = serve_mod.serve_batch(AUDIO_ARCH, cfg=cfg, params=params, device=DEVICE, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = served["tokens"]
    if tokens.shape != (SERVE["requests"], SERVE["gen_len"]) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: tokens {tokens.shape}, range {tokens.min()}..{tokens.max()}")
    prompts, frames = serve_prompts(cfg, dev), serve_frames(cfg, dev)
    slots = SERVE["prompt_len"] + SERVE["gen_len"] + 1
    cache = M.init_cache(cfg, SERVE["requests"], slots, device=dev)
    enc_host, enc_dev = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        M.prefill_cross_cache(cfg, params, cache, frames)
        end.record()
        torch.cuda.synchronize()
        enc_host.append(1e3 * (time.perf_counter() - t0))
        enc_dev.append(start.elapsed_time(end))
    bound = decode_bound(M.param_bytes(cfg) - enc_bytes, cache, slots)
    del cache
    host_ms, dev_ms, moe_ms, at_prompt = decode_alone(
        cfg, params, prompts, SERVE["gen_len"], ServeCapture(timed=True), frames=frames)
    peak = torch.cuda.max_memory_allocated() - held
    serve_numbers(tag, cfg, served, host_ms, dev_ms, moe_ms, peak / 1e9)
    print(f"{tag}: the encoder over {SERVE['requests']} x {cfg.encoder_seq} frames and the "
          f"cross cache: {1e3 * served['encode_s']:.3f} ms in serve_batch (host, the first "
          f"call); prefill_cross_cache alone (synced) host {enc_host[0]:.3f} / "
          f"{enc_host[1]:.3f} ms, CUDA events {enc_dev[0]:.3f} / {enc_dev[1]:.3f} ms")
    print(f"{tag}: serve_batch wall {wall:.2f} s; the decode step's bound: {bound['bytes']} "
          f"bytes (the decoder's parameters {M.param_bytes(cfg) - enc_bytes}, self-attention "
          f"cache {bound['kv_bytes']} read, cross keys and values {bound['cross_bytes']} read) "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound['bound_ms']:.4f} ms, "
          f"{100 * bound['bound_ms'] / np.median(dev_ms):.2f}% of the CUDA-event median, "
          f"{100 * bound['bound_ms'] / np.median(host_ms):.2f}% of the host median")
    pre = prefill_check(tag, cfg, params, prompts, at_prompt, ServeCapture(),
                        extra={"frames": frames})
    launches = no_launches(tag, mla0)
    print(f"{tag}: no native kernel launched (the encoder, the cross attention and GQA are "
          f"plain PyTorch, as the reference's are plain jnp)")
    del params, frames
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": served["tokens_per_s"],
            "encode_s": served["encode_s"], "encode_dev_ms": enc_dev,
            "step_host_ms": float(np.median(host_ms)), "step_dev_ms": float(np.median(dev_ms)),
            "bound_ms": bound["bound_ms"], "peak_bytes": peak, "prefill": pre}


def vision_prefill(dev) -> dict:
    """Phase 16b: Phi-3-vision-4.2B whole in bf16 (random weights from
    ``SERVE["seed"]``) on ``VISION_PREFILL``'s batch: the prompts drawn as
    ``serve_batch`` draws them, then 576 patches each
    (``models.frontend.synth_vision_patches`` from the same generator).
    ``forward``'s logits ``(B, 576 + S, vocab)`` finite;
    ``make_prefill_step`` twice (synced wall s), its logits the forward's
    last position; peak memory; no native kernel launched."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models.frontend import synth_vision_patches

    tag = f"phase 16b ({VISION_ARCH})"
    cfg = get_config(VISION_ARCH)
    B, S = VISION_PREFILL["batch"], VISION_PREFILL["seq"]
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    print(f"{tag}: {cfg.num_layers} layers {M.scan_groups(cfg)}, d_model {cfg.d_model}, "
          f"{cfg.num_patches} patches through vision_proj {tuple(params['vision_proj'].shape)}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}: {sum(t.numel() for t in _leaves(params))} "
          f"parameters, {M.param_bytes(cfg)} bytes from seed {SERVE['seed']} in "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SERVE["seed"])
    prompts = torch.from_numpy(rng.integers(1, min(cfg.vocab_size, 1000), size=(B, S)).astype(
        np.int32)).to(dev)
    patches = torch.from_numpy(synth_vision_patches(cfg, B, rng)).to(dev)
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = M.forward(cfg, params, prompts, patches=patches)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        shape = tuple(logits.shape)
        if shape != (B, cfg.num_patches + S, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: forward logits {shape}, not all finite")
        last_fwd = logits[:, -1].clone()
        del logits
        prefill = make_prefill_step(cfg)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = prefill(params, {"tokens": prompts, "patches": patches})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    if not torch.equal(last, last_fwd):
        raise AssertionError(f"{tag}: the prefill step's logits are not the forward's last "
                             f"position's (max |diff| {(last - last_fwd).abs().max().item()})")
    peak = torch.cuda.max_memory_allocated() - held
    launches = no_launches(tag, mla0)
    print(f"{tag}: forward on {B} x ({cfg.num_patches} patches + {S} tokens): logits {shape} "
          f"finite in {fwd_s:.3f} s (the first call); make_prefill_step "
          + ", ".join(f"{w:.3f}" for w in walls) + " s, its logits the forward's last position "
          f"bit for bit; peak {peak / 1e9:.2f} GB with the parameters; no native kernel "
          f"launched")
    del params, patches, prompts
    torch.cuda.empty_cache()
    return {"launches": launches, "logits_shape": list(shape), "forward_s": fwd_s,
            "prefill_s": walls, "peak_bytes": peak}


@contextlib.contextmanager
def ep_world_of_one():
    """A ``torch.distributed`` world of one over a ``FileStore`` in a
    temporary directory (no TCP): gloo for CPU tensors, NCCL for the
    card's. Its (1, 1) mesh is registered for ``moe_forward_ep``; the group
    is destroyed on the way out."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    backend = "gloo" if DEVICE == "cpu" else "cpu:gloo,cuda:nccl"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_test_mesh(1, 1, device_type=DEVICE)
            moe.set_ep_mesh(mesh)
            yield mesh
        finally:
            moe.set_ep_mesh(None)
            dist.destroy_process_group()


def ep_drops(cfg, router, x) -> int:
    """Token copies ``moe_forward_ep`` drops on a mesh of one at
    ``cfg.ep_capacity_factor``: each expert's copies past its capacity
    block (both combines: on one rank the all-to-all sends every copy and
    the receiver's blocks are the psum form's)."""
    import torch

    from repro_torch.models import moe

    m = cfg.moe
    idx = moe._route(cfg, router, x.reshape(-1, x.shape[-1]))[1].reshape(-1)
    cap = moe._capacity(idx.numel(), m.num_experts, cfg.ep_capacity_factor, floor=True)
    counts = torch.bincount(idx, minlength=m.num_experts)
    return int((counts - cap).clamp(min=0).sum())


def ep_grads(cfg, params, x, ct, where) -> dict:
    """``moe_apply`` on ``where`` (``cfg.ep_axis`` set): ``y``, ``aux`` and
    the gradients of ``sum(y * ct) + aux`` with respect to every parameter
    and ``x``, on the CPU."""
    import torch

    from repro_torch.models import moe
    from repro_torch.tree import flatten, unflatten

    leaves, spec = flatten(params)
    live = [t.to(where).requires_grad_() for t in leaves]
    xx = x.to(where).requires_grad_()
    y, aux = moe.moe_apply(cfg, unflatten(spec, live), xx)
    grads = torch.autograd.grad((y * ct.to(where)).sum() + aux, [*live, xx])
    return {"y": y.detach().cpu(), "aux": aux.detach().cpu(),
            **{f"g{i}": g.cpu() for i, g in enumerate(grads)}}


def ep_small_inputs(arch):
    """Phase 17's inputs for one MoE smoke config, on the CPU from a seed:
    ``(cfg, params, x, ct)``, ``cfg`` in float32 with ``ep_axis="model"``,
    ``x`` with a shared skew so that routing is uneven."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    seed = EP_ARCHES.index(arch)
    base = get_smoke_config(arch).with_overrides(dtype="float32", ep_axis="model")
    params = moe.init_moe(base, torch.Generator().manual_seed(11 + seed))
    d = base.d_model
    rng = np.random.default_rng(12 + seed)
    x = torch.from_numpy(
        (rng.standard_normal((*EP_X, d)) + EP_SKEW * rng.standard_normal(d)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((*EP_X, d)).astype(np.float32))
    return base, params, x, ct


def ep_card_vs_cpu(dev) -> dict:
    """Phase 17: both MoE smoke configs in float32 (TF32 off), each combine
    at capacity 8 and 1.25, ``moe_apply`` with ``ep_axis="model"`` on the
    registered mesh of one: ``y``, ``aux`` and every gradient on the card
    within ``EP_TOL`` of the CPU's (gradients of a leaf's largest), two card
    runs bit-identical, no native launch; at 1.25 copies drop and ``y``
    differs from capacity 8's on both devices. Then the twins of phases 9c
    (:func:`zoo_card_vs_cpu`) and 14c (:func:`zoo_train_card_vs_cpu`) on
    both smoke models with the same settings; their decode launches the
    MLA kernel (DeepSeek-V3)."""
    import torch

    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native

    rows = {}
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    for arch in EP_ARCHES:
        base, params, x, ct = ep_small_inputs(arch)
        dropless = {}
        for combine, cf in EP_CASES:
            cfg = base.with_overrides(ep_capacity_factor=cf, ep_combine=combine)
            cpu, card, again = (ep_grads(cfg, params, x, ct, w) for w in ("cpu", dev, dev))
            tag = f"phase 17 ({arch}, {combine}, cf {cf})"
            y_err = (card["y"] - cpu["y"]).abs().max().item()
            aux_err = abs(card["aux"].item() - cpu["aux"].item())
            g_err = max((card[k] - cpu[k]).abs().max().item() / max(cpu[k].abs().max().item(), 1e-30)
                        for k in cpu if k.startswith("g"))
            if not (y_err <= EP_TOL * max(cpu["y"].abs().max().item(), 1.0)
                    and aux_err <= EP_TOL and g_err <= EP_TOL):
                raise AssertionError(f"{tag}: card vs CPU y {y_err}, aux {aux_err}, gradients "
                                     f"{g_err} of a leaf's largest")
            if not all(torch.equal(card[k], again[k]) for k in card):
                raise AssertionError(f"{tag}: two card runs differ")
            drops = ep_drops(cfg, params["router"], x)
            row = {"y_diff": y_err, "aux_diff": aux_err, "grad_rel_diff": g_err, "drops": drops,
                   "copies": x.shape[0] * x.shape[1] * base.moe.experts_per_token}
            if cf == EP_CASES[0][1]:
                dropless[combine] = (cpu["y"], card["y"])
                if drops:
                    raise AssertionError(f"{tag}: {drops} copies dropped at capacity {cf}")
            else:
                gaps = [(a - b).abs().max().item() for a, b in zip((cpu["y"], card["y"]),
                                                                  dropless[combine])]
                if not drops or min(gaps) <= 0.1:
                    raise AssertionError(f"{tag}: {drops} drops, y against capacity 8 {gaps}")
                row["y_gap_to_dropless"] = gaps[1]
            rows[f"{arch} {combine} cf {cf}"] = row
    no_launches("phase 17", mla0)
    # The twins of phases 9c and 14c with the same settings.
    twins = {}
    for arch in EP_ARCHES:
        for combine, cf in EP_CASES:
            over = dict(ep_axis="model", ep_combine=combine, ep_capacity_factor=cf)
            twins[f"{arch} {combine} cf {cf}"] = {
                "serve": zoo_card_vs_cpu(arch, dev, over),
                "train": zoo_train_card_vs_cpu(arch, dev, over)}
    launches = {"mla_flash_decode": sum(t["serve"]["mla_launches"] for t in twins.values())}
    return {"rows": rows, "twins": twins, "launches": launches}


def ep_layer_full_width(dev, flush) -> dict:
    """Phase 17b: one MoE layer at published width (DeepSeek-V3: 256
    experts, 22.5 GB of bf16 expert stacks; Phi-3.5-MoE: 16 experts, 2.5
    GB) from a seed, at ``EP_SHAPES``: ``moe_forward_ep`` (psum) at
    capacity E / k (no copy can drop) against ``moe_forward`` within 3e-2
    of max |y|; both timed by CUDA events (L2 flushed, mean of 5, in turns)
    beside their bounds, the larger of the bytes each must read (the
    blocked form every local expert, ``moe_forward`` the experts it routes
    to) and its products at the bf16 peak (the blocked form's padded
    capacity rows, ``moe_forward``'s routed copies); the copies
    dropped at the default capacity 1.25 and that run's distance from the
    dropless ``y``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    rows = {}
    for arch in (ARCH, "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch)
        m = cfg.moe
        gen = torch.Generator(device=dev).manual_seed(17)
        torch.cuda.empty_cache()
        p = moe.init_moe(cfg, gen)
        ep_cfg = cfg.with_overrides(ep_axis="model", ep_capacity_factor=m.num_experts / m.experts_per_token)
        for what, b, s in EP_SHAPES:
            tag = f"phase 17b ({arch}, {what})"
            x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
            with torch.no_grad():
                want, aux0 = moe.moe_forward(cfg, p, x)
                got, aux1 = moe.moe_forward_ep(ep_cfg, p, x)
                scale = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= 3e-2 * scale or abs(aux1.item() - aux0.item()) > 1e-5:
                    raise AssertionError(f"{tag}: EP vs moe_forward {err} of {scale}, aux "
                                         f"{aux1.item()} vs {aux0.item()}")
                ep_ms, plain_ms, _, raw = time_pair(lambda: moe.moe_forward_ep(ep_cfg, p, x),
                                                    lambda: moe.moe_forward(cfg, p, x), flush,
                                                    reps=5)
                default = ep_cfg.with_overrides(ep_capacity_factor=1.25)
                y125, _ = moe.moe_forward_ep(default, p, x)
                gap = (y125.float() - want.float()).abs().max().item()
            n = b * s
            used = moe._route(cfg, p["router"], x.reshape(n, -1))[1].unique().numel()
            io = 2 * x.numel() * x.element_size()
            # Products of the experts' FFN (three for the gated kinds), two
            # operations a multiply-add; the blocked form's rows are its
            # capacity blocks, moe_forward's the routed copies.
            per_row = 2 * (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * cfg.d_model * m.d_ff_expert
            shared = per_row * n * m.num_shared_experts
            cap = moe._capacity(n * m.experts_per_token, m.num_experts, ep_cfg.ep_capacity_factor,
                                floor=True)
            ep_b = bound(expert_bytes(cfg, m.num_experts) + io,
                         per_row * m.num_experts * cap + shared, BF16_TENSOR_OPS_PER_S)
            plain_b = bound(expert_bytes(cfg, used) + io,
                            per_row * n * m.experts_per_token + shared, BF16_TENSOR_OPS_PER_S)
            rows[f"{arch} {what}"] = {
                "tokens": n, "max_abs_err": err, "max_abs_y": scale, "ep_ms": ep_ms,
                "moe_forward_ms": plain_ms, "raw_ms": raw, "capacity": cap,
                "ep_bound_ms": ep_b[0], "ep_bound_by": ep_b[1],
                "moe_forward_bound_ms": plain_b[0], "moe_forward_bound_by": plain_b[1],
                "experts_routed": used,
                "drops_cf_1.25": ep_drops(default, p["router"], x),
                "copies": n * m.experts_per_token, "y_gap_cf_1.25": gap,
            }
        del p, x, want, got, y125
        torch.cuda.empty_cache()
    return rows


class EPCapture:
    """A telemetry session that keeps each ``moe_forward_ep`` call's router
    and input (detached), for the copies it dropped."""

    profile_kernels = True

    def __init__(self):
        self.calls = []

    def profile_call(self, name, fn, *args, **kwargs):
        if name == "moe_forward_ep":
            self.calls.append((args[0], args[1]["router"].detach(), args[2].detach().clone()))
        return fn(*args, **kwargs)


def ep_entry_points(dev, served_tokens) -> dict:
    """Phase 17c: the entry points with ``ep_axis="model"`` on the mesh of
    one. ``serve_batch`` on phase 9's DeepSeek-V3 cut (the same parameters
    from phase 9's seed, its requests): ms a step, the greedy tokens'
    agreement with phase 9's (``served_tokens``), the MLA launches; then on
    one cache (``EP_FILL`` prompt positions, dropless) one decode step EP
    against dropless, logits within 3e-2 of max |logits|. Then
    ``EP_TRAIN``'s steps of ``make_train_step`` on the Phi-3.5-MoE cut:
    losses, the copies dropped, ms a step, the peak; no native launch."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    out = {}
    cfg = get_config(ARCH).with_overrides(num_layers=SERVE_LAYERS)
    ep_cfg = cfg.with_overrides(ep_axis="model")
    torch.cuda.empty_cache()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    capture = EPCapture()
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    torch.cuda.synchronize()
    with telemetry.active(capture):
        served = serve_mod.serve_batch(ARCH, cfg=ep_cfg, params=params, device=DEVICE, **SERVE)
    launches = dict(native.LAUNCHES)
    mla = {k: v - mla0[k] for k, v in md.KERNEL_LAUNCHES.items()}
    steps = SERVE["prompt_len"] + SERVE["gen_len"]
    n_mla = SERVE_LAYERS * steps
    n_moe = (SERVE_LAYERS - cfg.moe.first_k_dense) * steps
    others = {k: v for k, v in launches.items() if v and k != "mla_flash_decode"}
    if launches["mla_flash_decode"] != n_mla or others or mla["tensor_cores"] != n_mla:
        raise AssertionError(f"phase 17c: launches {launches}, MLA kernels {mla}, want "
                             f"mla_flash_decode = {n_mla}")
    drops = sum(ep_drops(c, r, x) for c, r, x in capture.calls)
    if len(capture.calls) != n_moe or drops:
        raise AssertionError(f"phase 17c: {len(capture.calls)} moe_forward_ep calls (want "
                             f"{n_moe}), {drops} copies dropped (decode: none can)")
    agree = float(np.mean(served["tokens"] == served_tokens))
    out["serve"] = {"ms_per_step": 1e3 * served["decode_s"] / SERVE["gen_len"],
                    "prefill_s": served["prefill_s"], "tokens_per_s": served["tokens_per_s"],
                    "token_agreement": agree, "moe_calls": len(capture.calls),
                    "launches": {k: v for k, v in launches.items() if v}}
    del capture
    # One decode step on one cache, EP against dropless.
    prompts = serve_prompts(cfg, dev)
    cache = M.init_cache(cfg, SERVE["requests"], EP_FILL + 2, device=dev)
    with torch.no_grad():
        for t in range(EP_FILL):
            _, cache = M.decode_step(cfg, params, cache, prompts[:, t:t + 1], t)
        tok = prompts[:, EP_FILL:EP_FILL + 1]
        logits = [M.decode_step(c, params, tree_map(torch.clone, cache), tok, EP_FILL)[0]
                  for c in (cfg, ep_cfg)]
    scale = logits[0].float().abs().max().item()
    err = (logits[1].float() - logits[0].float()).abs().max().item()
    greedy = bool(torch.equal(logits[0].argmax(-1), logits[1].argmax(-1)))
    if not err <= 3e-2 * scale:
        raise AssertionError(f"phase 17c: EP decode step vs dropless {err} of {scale}")
    out["decode_check"] = {"max_abs_err": err, "max_abs_logits": scale, "greedy_equal": greedy,
                           "position": EP_FILL}
    del params, cache, logits
    torch.cuda.empty_cache()
    # Training: EP_TRAIN's steps on the Phi-3.5-MoE cut.
    tcfg = get_config(EP_TRAIN["arch"]).with_overrides(num_layers=EP_TRAIN["layers"])
    ep_tcfg = tcfg.with_overrides(ep_axis="model")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(tcfg, 0, device=dev)
    opt = adamw_init(params, tcfg.opt_dtype)
    pipe = TokenPipeline(tcfg, EP_TRAIN["batch"], EP_TRAIN["seq"], seed=0)
    step = make_train_step(ep_tcfg, lr=EP_TRAIN["lr"], remat=False)
    capture = EPCapture()
    native.reset_launches()
    mla0 = dict(md.KERNEL_LAUNCHES)
    losses, step_ms, drops = [], [], []
    for _ in range(EP_TRAIN["steps"]):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.active(capture):
            params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        drops.append(sum(ep_drops(c, r, x) for c, r, x in capture.calls))
        capture.calls.clear()
    peak = torch.cuda.max_memory_allocated() - held
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 17c: training losses {losses}")
    copies = EP_TRAIN["batch"] * EP_TRAIN["seq"] * tcfg.moe.experts_per_token * (
        tcfg.num_layers - tcfg.moe.first_k_dense)
    out["train"] = {"losses": losses, "step_ms": step_ms, "drops": drops,
                    "copies_per_step": copies, "peak_bytes": peak,
                    "launches": no_launches("phase 17c (train)", mla0)}
    del params, opt, metrics, batch
    torch.cuda.empty_cache()
    return out


def ep_phases(dev, flush, served_tokens) -> dict:
    """Phases 17-17c on a world of one (:func:`ep_world_of_one`), printed;
    ``served_tokens`` are phase 9's greedy tokens. Returns each phase's
    native launches."""
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native

    ep_launches = {}
    t_ep = time.perf_counter()
    with ep_world_of_one():
        t_phase = time.perf_counter()
        ep_small = ep_card_vs_cpu(dev)
        ep_launches["phase 17"] = ep_small["launches"]
        print(f"phase 17: both MoE smoke configs (float32, TF32 off), moe_apply with "
              f"ep_axis='model' on a torch.distributed world of one (gloo for the CPU, NCCL for "
              f"the card), each combine at capacity 8 and 1.25: y, aux and every gradient on the "
              f"card within {EP_TOL} of the CPU's, two card runs bit-identical, the 1.25 cases "
              f"dropping copies on both devices; no native launch; "
              + json.dumps({k: {kk: float(f"{vv:.3g}") if isinstance(vv, float) else vv
                                for kk, vv in r.items()} for k, r in ep_small["rows"].items()}))
        print("phase 17: the twins of 9c and 14c on both MoE smoke configs with each combine and "
              "capacity: tokens equal card vs CPU, logits within 1e-4, forward vs decode where no "
              "copy can drop, two card decodes bit-identical; 3 train() steps: losses within "
              f"{TRAIN_TOL} relative, step-1 gradients within {TRAIN_TOL} x a leaf's largest, the "
              "card's checkpoint loaded on the CPU bit for bit; " + json.dumps(
                  {k: {w: {kk: float(f"{vv:.3g}") if isinstance(vv, float) else vv
                           for kk, vv in r.items()} for w, r in t.items()}
                   for k, t in ep_small["twins"].items()}))
        print(f"phase 17: wall {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        native.reset_launches()
        mla0 = dict(md.KERNEL_LAUNCHES)
        ep_layers = ep_layer_full_width(dev, flush)
        ep_launches["phase 17b"] = no_launches("phase 17b", mla0)
        for what, row in ep_layers.items():
            print(f"phase 17b: {what} ({row['tokens']} tokens), one MoE layer at published width: "
                  f"moe_forward_ep (psum, capacity E / k) vs moe_forward max |diff| "
                  f"{row['max_abs_err']:.4g} of max |y| {row['max_abs_y']:.4g} (within 3e-2); "
                  f"moe_forward_ep {row['ep_ms']:.4f} ms against its bound {row['ep_bound_ms']:.4f} "
                  f"ms ({row['ep_bound_by']}: every local expert read, blocks of "
                  f"{row['capacity']} rows), moe_forward {row['moe_forward_ms']:.4f} ms against "
                  f"{row['moe_forward_bound_ms']:.4f} ms ({row['moe_forward_bound_by']}: "
                  f"{row['experts_routed']} experts routed) (CUDA events, L2 flushed, mean of 5, "
                  f"in turns: {[round(v, 4) for v in row['raw_ms']]}); at the default capacity "
                  f"1.25: {row['drops_cf_1.25']} of {row['copies']} copies dropped, y "
                  f"{row['y_gap_cf_1.25']:.4g} from the dropless y")
        print(f"phase 17b: wall {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        ep_entry = ep_entry_points(dev, served_tokens)
        ep_launches["phase 17c"] = ep_entry["serve"]["launches"]
        sv, dc, tr = ep_entry["serve"], ep_entry["decode_check"], ep_entry["train"]
        print(f"phase 17c: serve_batch of phase 9's {ARCH} cut with ep_axis='model' "
              f"({sv['moe_calls']} moe_forward_ep calls, none dropping): "
              f"{sv['ms_per_step']:.3f} ms a decode step, {sv['tokens_per_s']:.1f} tokens/s, "
              f"prefill {sv['prefill_s']:.3f} s; greedy tokens equal to phase 9's on "
              f"{100 * sv['token_agreement']:.1f}%; launches {sv['launches']}; one decode step at "
              f"position {dc['position']} on one cache, EP vs dropless: max |diff| "
              f"{dc['max_abs_err']:.4g} of max |logits| {dc['max_abs_logits']:.4g} (within 3e-2), "
              f"greedy equal {dc['greedy_equal']}")
        print(f"phase 17c: make_train_step with ep_axis='model' on {EP_TRAIN['arch']} cut to "
              f"{EP_TRAIN['layers']} layers, batch {EP_TRAIN['batch']} x seq {EP_TRAIN['seq']}, lr "
              f"{EP_TRAIN['lr']}: losses {[round(v, 4) for v in tr['losses']]}, copies dropped "
              f"{tr['drops']} of {tr['copies_per_step']} a step, "
              f"{[round(v, 1) for v in tr['step_ms']]} ms a step, peak "
              f"{tr['peak_bytes'] / 1e9:.2f} GB; no native launch")
        print(f"phase 17c: wall {time.perf_counter() - t_phase:.1f} s")
    print(f"phase 17-17c: wall {time.perf_counter() - t_ep:.1f} s")
    return ep_launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _numpy_tree(tree):
    """A parameter tree with numpy leaves (the shape ``params_from_jax``
    takes)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def mla_check(md, ref, args, pos, scale, tol, what, rel=None) -> float:
    """The MLA kernel against its plain version, allclose at ``tol`` (and,
    given ``rel``, max |diff| <= rel * max |plain|); returns the max abs
    difference."""
    import torch

    got = md.mla_flash_decode_cuda(*args, pos, scale)
    want = ref.mla_latent_attention(*args, pos, scale)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel != plain at rtol=atol={tol}")
    err = (got.float() - want.float()).abs().max().item()
    if rel is not None and not err <= rel * want.float().abs().max().item():
        raise AssertionError(f"{what}: max |diff| {err:.3g} > {rel} * max |plain| "
                             f"{want.float().abs().max().item():.3g}")
    return err


def mla_nan_check(md, ref, args, pos, scale, tol, what) -> float:
    """The kernel on caches whose rows past ``pos`` are NaN: finite, and
    allclose at ``tol`` to the plain version on the same caches with those
    rows zeroed; returns the max abs difference."""
    import torch

    q_lat, q_rope, c, kr = args
    c_nan, kr_nan, c_zero, kr_zero = c.clone(), kr.clone(), c.clone(), kr.clone()
    for t, v in ((c_nan, float("nan")), (kr_nan, float("nan")), (c_zero, 0.0), (kr_zero, 0.0)):
        t[:, pos + 1 :] = v
    got = md.mla_flash_decode_cuda(q_lat, q_rope, c_nan, kr_nan, pos, scale)
    want = ref.mla_latent_attention(q_lat, q_rope, c_zero, kr_zero, pos, scale)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: NaN rows past pos leaked into the output")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel != plain on a zeroed tail at rtol=atol={tol}")
    return (got.float() - want.float()).abs().max().item()


def ptxas_lines(log: str) -> list[str]:
    """The lines of an ``-Xptxas -v`` report that name an entry, its
    registers and spills, and a count of ptxas's wgmma notes (C7519:
    ``warpgroup.arrive`` injected around a wgmma whose registers the code
    touches)."""
    lines = [line.strip() for line in log.splitlines()
             if ("registers" in line or "spill" in line or "Compiling entry" in line)
             and "C7519" not in line]
    notes = sum("C7519" in line for line in log.splitlines())
    return lines + ([f"{notes} C7519 notes (warpgroup.arrive injected)"] if notes else [])


def kernel_device_ms(fn, names, reps: int = 3) -> dict:
    """Device time per launch of the kernels whose names contain each of
    ``names``, over ``reps`` calls of ``fn`` (one torch.profiler window
    after a warm-up call; the total over the launches the trace recorded):
    ``{name: ms or None}``, None where the trace shows no such kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    out = {}
    for name in names:
        hits = [e for e in rows if name in e.key and device_us(e) > 0]
        launches = sum(e.count for e in hits)
        out[name] = sum(device_us(e) for e in hits) / launches / 1e3 if launches else None
    return out


def mla_ops(args, pos) -> int:
    """Operations of the MLA decode on rows ``0..pos``: 2 (r + rr) per
    head and row for the scores, 2 r for the context."""
    q_lat, q_rope, cache_c = args[0], args[1], args[2]
    B, H, R = q_lat.shape
    rows = min(int(pos), cache_c.shape[1] - 1) + 1
    return 2 * B * H * rows * (2 * R + q_rope.shape[-1])


def mla_bytes(args, pos) -> int:
    """Bytes the MLA decode must move: the queries, the rows ``0..pos`` of
    both caches, and the output (the queries' size, in the cache dtype)."""
    q_lat, q_rope, cache_c, cache_kr = args
    rows = min(int(pos), cache_c.shape[1] - 1) + 1
    B = cache_c.shape[0]
    per_row = (cache_c.shape[2] + cache_kr.shape[2]) * cache_c.element_size()
    return tensor_bytes((q_lat, q_rope)) + B * rows * per_row + tensor_bytes((q_lat,))


def run_warned(trainer):
    """``trainer.run()``, returning the result and the texts of the
    ``RuntimeWarning`` s it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = trainer.run()
    return result, [str(w.message) for w in caught if w.category is RuntimeWarning]


def shift_ids(ids, base: int):
    """Engine ids with every valid (non-negative) id moved up by ``base``."""
    import numpy as np

    return np.where(ids >= 0, ids + np.int64(base), ids)


def compare_runs(what, a_tr, a_run, b_tr, b_run, store: bool, base: int = 0):
    """Run ``a`` against run ``b`` (card against CPU, or a rebased run
    against its narrow twin, whose ids ``base`` lower): every stream, stat
    and the buffer state (and store streams and payload) identical, ids
    shifted by ``base``, losses allclose."""
    import numpy as np

    streams = STREAMS + (STORE_STREAMS if store else ())
    for p, (a, b) in enumerate(zip(a_run.logs, b_run.logs)):
        for f in streams:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{what}: PE {p} stream {f} differs")
    for f in STATS:
        if not np.array_equal(getattr(a_tr.engine.stats, f), getattr(b_tr.engine.stats, f)):
            raise AssertionError(f"{what}: engine.stats.{f} differs")
    for f in ("ids", "scores", "valid", "accessed", "weights") + (("payload",) if store else ()):
        b_val = getattr(b_tr.engine, f)
        if f == "ids" and base:
            b_val = shift_ids(b_val, base)
        if not np.array_equal(getattr(a_tr.engine, f), b_val):
            raise AssertionError(f"{what}: engine.{f} differs")
    np.testing.assert_allclose(a_run.losses, b_run.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    if store and a_run.total_bytes_measured != a_run.total_bytes_modeled:
        raise AssertionError(f"{what}: measured bytes != modeled bytes")
    if not a_run.losses:
        return 0.0
    return float(np.max(np.abs(np.subtract(a_run.losses, b_run.losses))))


def plain_readback(args, kw):
    """The fused step's engine form (gate words in, the packed readback
    out) composed of plain versions: the gate bits, ``ref.fused_step``,
    ``ref.pack_readback``."""
    from repro_torch.kernels import ref

    bits = [(args[9] & bit) != 0 for bit in (1, 2, 4)]
    out = ref.fused_step(*args[:9], *bits, **kw)
    return (*out[:5], ref.pack_readback(*out[5:9], out[10]))


def assert_maps_clean(what) -> int:
    """Raise unless the fused step's kept maps (every device and stream)
    are all -1 (``slot_of``) and 0 (``cand_first``); returns their
    entries."""
    import torch

    from repro_torch.kernels import fused_step as fs

    torch.cuda.synchronize()
    if not fs._MAPS:
        raise AssertionError(f"{what}: the fused step kept no maps")
    for key, (slot_of, cand_first) in fs._MAPS.items():
        if not (bool((slot_of == -1).all()) and bool((cand_first == 0).all())):
            raise AssertionError(f"{what}: the kept maps of {key} are not clean")
    return sum(m[0].numel() for m in fs._MAPS.values())


def fused_step_forms(args, kw, wide):
    """The fused step's two forms on one captured launch, each beside its
    plain version: (engine kernel, engine plain, reference kernel,
    reference plain), as callables."""
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ref

    ref_wrapper = fs.fused_step_wide_cuda if wide else fs.fused_step_cuda
    bits = [(args[9] & bit) != 0 for bit in (1, 2, 4)]
    plain_kw = {k: v for k, v in kw.items() if k not in ("id_lo", "num_ids")}
    ref_kw = kw if wide else {k: v for k, v in kw.items() if k != "id_lo"}
    return (
        lambda: fs.fused_step_readback_cuda(*args, **kw),
        lambda: plain_readback(args, plain_kw),
        lambda: ref_wrapper(*args[:9], *bits, **ref_kw),
        lambda: ref.fused_step(*args[:9], *bits, **plain_kw),
    )


def check_step_launches(tag, caps, wide, max_err) -> int:
    """Every captured launch of the fused step (engine form, as the engine
    calls it, and the reference's form) bit-exact against its plain
    version; returns the count."""
    import torch

    name = "fused_step_wide" if wide else "fused_step"
    for i, (args, kw) in enumerate(caps):
        k_rb, p_rb, k_ref, p_ref = fused_step_forms(args, kw, wide)
        for got, want, names, form in ((k_rb(), p_rb(), READBACK_OUT, "engine"),
                                       (k_ref(), p_ref(), STEP_OUT, "reference")):
            torch.cuda.synchronize()
            max_err[name] = max(max_err[name], compare_outputs(
                got, want, names, f"{tag} {name} {i} ({form} form)"))
    return len(caps)


def check_frontier_launches(tag, caps, wide, max_err) -> int:
    """Every captured ``fused_frontier_step`` (or, ``wide``, its int64
    twin's) launch bit-exact against its plain version; returns the
    count."""
    import torch

    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ref

    name = "fused_frontier_step_wide" if wide else "fused_frontier_step"
    kernel = fs.fused_frontier_step_wide_cuda if wide else fs.fused_frontier_step_cuda
    plain = ref.fused_frontier_step_wide if wide else ref.fused_frontier_step
    for i, (args, kw) in enumerate(caps):
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        max_err[name] = max(
            max_err[name], compare_outputs(got, want, FRONTIER_OUT, f"{tag} {name} {i}"))
    return len(caps)


def check_prefetch_launches(tag, clock, max_err) -> dict:
    """Both narrow prefetch-step kernels (rows 1 and 2) bit-exact on every
    launch a run's ``clock`` captured; returns the counts held."""
    held = {
        "fused_frontier_step": check_frontier_launches(
            tag, clock.launches["fused_frontier_step_batch"], False, max_err),
        "fused_step": check_step_launches(
            tag, clock.launches["fused_step_readback_batch"], False, max_err),
    }
    if held["fused_step"]:
        assert_maps_clean(f"{tag}: after the checks")
    return held


def compare_legacy(what, tr, run, want, want_stats, store: bool):
    """A legacy run (``tr``, ``run``) against a vectorized one (its
    result ``want`` and ``engine.stats`` ``want_stats``): every stream (and
    the store streams), ``epoch_times`` and the accuracy identical, the
    legacy buffers' stats summing to the engine's; the losses bit-identical
    or, if not, allclose. Returns (losses bit-identical, max |diff|)."""
    import numpy as np

    streams = STREAMS + (STORE_STREAMS if store else ())
    for p, (a, b) in enumerate(zip(run.logs, want.logs)):
        for f in streams:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{what}: PE {p} stream {f} differs")
    if run.epoch_times != want.epoch_times:
        raise AssertionError(f"{what}: epoch_times differ")
    for f in STATS:
        got = np.array([getattr(buf.stats, f) for buf in tr.buffers])
        if not np.array_equal(got, want_stats[f]):
            raise AssertionError(f"{what}: buffer stats {f} {got} != engine {want_stats[f]}")
    same = run.losses == want.losses and run.accuracy == want.accuracy
    if not same:
        np.testing.assert_allclose(run.losses, want.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    diff = float(np.max(np.abs(np.subtract(run.losses, want.losses)))) if run.losses else 0.0
    return same, diff


def legacy_stages(clock) -> dict:
    """Median ms per step of the legacy loop's stages: the step, its four
    ``pe_step`` spans summed, the store's gathers, the training step."""
    import numpy as np

    return {
        k: round(float(np.median(v)), 3) for k, v in {
            "step": clock.ms("step"),
            "pe_step_sum": clock.per_step("pe_step"),
            "store.gather_sum": clock.per_step("store.gather"),
            "train": clock.ms("train"),
        }.items() if len(v) and any(v)
    }


def only_kernels(what, launches, allowed) -> None:
    """Raise if a run launched a kernel outside ``allowed``."""
    bad = {k: v for k, v in launches.items() if v and k not in allowed}
    if bad:
        raise AssertionError(f"{what}: launched {bad}")


def decide_us(clf, X, reps: int = 3) -> float:
    """Host µs per ``clf.decide`` call over the rows of ``X``."""
    t0 = time.perf_counter()
    for _ in range(reps):
        for x in X:
            clf.decide(x)
    return 1e6 * (time.perf_counter() - t0) / (reps * len(X))


def check_fused_step(tag, caps, wide, flush, max_err):
    """A ragged run's fused step (phases 3b and 6b): every captured launch
    in the engine's form (``fused_step_readback_cuda``: gate words in, the
    packed readback out) and in the reference's (``fused_step_cuda`` /
    ``_wide_cuda`` on the unpacked bits) bit-exact against its plain
    version; the kept maps clean after the run, the checks and the
    timings; both forms timed at the launch with the most work, with their
    device operations a call, wrapper host ms and the kernel alone.
    Returns the ``kernels`` line's timing tuple (the engine's form) and the
    reference form's numbers beside it."""
    name = "fused_step_wide" if wide else "fused_step"
    entries = assert_maps_clean(f"{tag}: after the run")
    check_step_launches(tag, caps, wide, max_err)
    assert_maps_clean(f"{tag}: after the checks")
    print(f"{tag}: kernel == plain, bit-exact, on all {len(caps)} {name} launches of "
          f"the run, in both forms; the kept maps ({entries} entries each) clean after "
          f"the run and the checks")

    args, kw = max(caps, key=lambda c: c[0][6].shape[1] + c[0][7].shape[1])
    k_rb, p_rb, k_ref, p_ref = fused_step_forms(args, kw, wide)
    k_ms, p_ms, _, raw = time_pair(k_rb, p_rb, flush)
    r_ms, rp_ms, _, raw_ref = time_pair(k_ref, p_ref, flush)
    nbytes = tensor_bytes(args, k_rb())
    nops = step_ops(args)
    b_ms, b_by = bound(nbytes, nops)
    alone = kernel_device_ms(k_rb, ("fused_step_kernel",), reps=10)["fused_step_kernel"]
    alone_ref = kernel_device_ms(k_ref, ("fused_step_kernel",), reps=10)["fused_step_kernel"]
    extra = {"reference_form_ms": r_ms, "reference_form_plain_ms": rp_ms}
    P, C = args[0].shape
    print(
        f"{tag}: {name} at P={P}, C={C}, M={args[6].shape[1]}, K={args[7].shape[1]}, "
        f"id_lo={kw.get('id_lo')}, num_ids={kw['num_ids']}; engine form: kernel "
        f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms; reference "
        f"form: kernel {raw_ref[0]:.4f}/{raw_ref[1]:.4f} ms, plain "
        f"{raw_ref[2]:.4f}/{raw_ref[3]:.4f} ms; {nbytes} bytes, {nops} ops; bound "
        f"{b_ms:.4f} ms ({b_by}); kernel alone (torch.profiler): engine form "
        + (f"{alone:.4f} ms" if alone else "not measured") + ", reference form "
        + (f"{alone_ref:.4f} ms" if alone_ref else "not measured")
    )
    for form, fn in (("engine", k_rb), ("reference", k_ref)):
        print(f"{tag}: {name} ({form} form): {device_ops_a_call(fn)}; wrapper host "
              f"{host_ms(fn):.4f} ms")
    assert_maps_clean(f"{tag}: after the timings")
    return (k_ms, p_ms, None, b_ms, b_by), extra


# --------------------------------------------------------------------------- #
#: Phase 18: the roofline's counts on a mesh of one, at phase 9d's decode
#: step (``SERVE``'s batch, a cache of ``prompt_len + gen_len + 1``) and
#: phase 14's Gemma2-2B training step (whole, 2 x 1024, ``remat=False``).
ROOF_DECODE = dict(kind="decode", seq=SERVE["prompt_len"] + SERVE["gen_len"] + 1,
                   batch=SERVE["requests"])
ROOF_TRAIN = dict(arch="gemma2-2b", kind="train", seq=1024, batch=2)
#: Phase 18b: the dry-run's command line, one pair each, on the fake mesh.
DRYRUN_PAIRS = (("qwen3-8b", "decode_32k", False), ("deepseek-v3-671b", "decode_32k", True))


def roofline_phases(decode_ms: float, train_ms: float) -> dict:
    """Phases 18 and 18b. 18: ``roofline.measure_corrected`` of phase 9d's
    Qwen3-8B decode step and phase 14's Gemma2-2B training step, each
    placed on a (1, 1) mesh of a fake world of one (``meta`` tensors), the
    counted FLOPs and bytes and their times at the card's spec-sheet peaks
    beside the same run's measured ms and the hand counts
    (``decode_bound``, ``train_flops``); the measured ms are at least
    ``t_compute``. 18b: ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_PAIRS`` as two subprocesses at once on the production meshes
    (256 and 512 fake ranks), started first so that they run beside 18's
    counts, exit 0 and rows ``ok``. Neither launches a
    kernel (the counts run on ``meta`` tensors, ``mla_flash_decode`` on
    its plain version there)."""
    import functools
    import os

    import torch

    from repro_torch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M

    # 18b's two subprocesses run beside phase 18's counts.
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi in DRYRUN_PAIRS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape]
        cmd += ["--multi-pod"] if multi else []
        procs.append((cmd, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    try:
        native.reset_launches()
        mla0 = dict(md.KERNEL_LAUNCHES)
        steps.SHAPES["phase 9d"] = ROOF_DECODE
        steps.SHAPES["phase 14"] = {k: v for k, v in ROOF_TRAIN.items() if k != "arch"}
        try:
            with dryrun.fake_world(1):
                mesh = make_test_mesh(1, 1, device_type="cpu")
                runs = {
                    "phase 9d": (WHOLE_ARCH, rl.measure_corrected(
                        get_config(WHOLE_ARCH), "phase 9d", mesh, dryrun.build_step), decode_ms),
                    "phase 14": (ROOF_TRAIN["arch"], rl.measure_corrected(
                        get_config(ROOF_TRAIN["arch"]), "phase 14", mesh,
                        functools.partial(dryrun.build_step, remat=False)), train_ms),
                }
        finally:
            del steps.SHAPES["phase 9d"], steps.SHAPES["phase 14"]
        launches = {k: v for k, v in native.LAUNCHES.items() if v}
        mla = {k: v - mla0.get(k, 0) for k, v in md.KERNEL_LAUNCHES.items() if v - mla0.get(k, 0)}
        if launches or mla:
            raise AssertionError(f"phase 18: launches {launches}, MLA kernels {mla}, want none")
        out = {}
        for tag, (arch, vec, ms) in runs.items():
            cfg = get_config(arch)
            report = rl.analyse(arch=arch, shape=tag, mesh=mesh, vector=vec)
            if vec["coll:all-reduce"] or report.coll_bytes:
                raise AssertionError(f"phase 18 ({tag}): collectives {report.coll_breakdown} "
                                     "on one rank")
            if tag == "phase 9d":
                cache = M.init_cache(cfg, ROOF_DECODE["batch"], ROOF_DECODE["seq"], device="meta")
                hand = decode_bound(M.param_bytes(cfg), cache, ROOF_DECODE["seq"])
                hand = {"hand_bytes": hand["bytes"], "hand_bound_ms": hand["bound_ms"]}
            else:
                flops = train_flops(cfg, ROOF_TRAIN["batch"], ROOF_TRAIN["seq"])
                hand = {"hand_flops": flops, "hand_t_compute_ms": 1e3 * flops / report.peak_flops}
            row = {"arch": arch, "flops": vec["flops"], "bytes": vec["bytes"],
                   "t_compute_ms": 1e3 * report.t_compute, "t_memory_ms": 1e3 * report.t_memory,
                   "bottleneck": report.bottleneck, "measured_ms": ms,
                   "measured_over_t_compute": ms / (1e3 * report.t_compute),
                   "measured_over_t_memory": ms / (1e3 * report.t_memory), **hand}
            if not ms >= row["t_compute_ms"]:
                raise AssertionError(f"phase 18 ({tag}): measured {ms} ms below the compute floor "
                                     f"{row['t_compute_ms']} ms")
            out[tag] = row
            ratio = (f"counted bytes / hand bytes {vec['bytes'] / hand['hand_bytes']:.3f}"
                     if "hand_bytes" in hand else
                     f"counted FLOPs / train_flops {vec['flops'] / hand['hand_flops']:.4f}")
            print(f"phase 18 ({tag}, {arch}): counted on a mesh of one {vec['flops']:.6g} FLOPs, "
                  f"{vec['bytes']:.6g} bytes, peak temporaries {vec['temp']:.6g} bytes; t_compute "
                  f"{row['t_compute_ms']:.4f} ms (bf16 {report.peak_flops / 1e12:.0f} TFLOP/s), "
                  f"t_memory {row['t_memory_ms']:.4f} ms ({report.hbm_bw / 1e12} TB/s) -> "
                  f"{report.bottleneck}; measured {ms:.3f} ms = "
                  f"{row['measured_over_t_compute']:.2f} "
                  f"x t_compute (asserted >= 1), {row['measured_over_t_memory']:.3f} x t_memory; "
                  f"hand count " + json.dumps({k: float(f"{v:.6g}") for k, v in hand.items()})
                  + f"; {ratio}")
        print(f"phase 18: no kernel launched; wall {time.perf_counter() - t_phase:.1f} s")

        rows = []
        for cmd, proc in procs:
            try:
                log, _ = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise AssertionError(f"phase 18b: {' '.join(cmd[1:])} ran past 300 s") from None
            found = [json.loads(line) for line in log.splitlines() if line.startswith("{")]
            if proc.returncode or [r.get("status") for r in found] != ["ok"]:
                raise AssertionError(f"phase 18b: {' '.join(cmd[1:])} exited {proc.returncode}:\n"
                                     + log[-3000:])
            rows.append(found[0])
        for r in rows:
            print(f"phase 18b: dryrun {r['arch']} x {r['shape']} on {r['mesh']}: ok, "
                  f"{r['hlo_flops_per_chip']:.6g} FLOPs and t_compute {r['t_compute_s']:.6g} s, "
                  f"t_memory {r['t_memory_s']:.6g} s, t_collective {r['t_collective_s']:.6g} s "
                  f"-> {r['bottleneck']}; {r['bytes_per_device']} bytes a device; count "
                  f"{r['count_s']} s; collectives " + json.dumps(r["coll_breakdown"]))
        print(f"phase 18b: fake backend, FakeStore, DTensor below the counter and local_map in "
              f"torch {torch.__version__}; phases 18 and 18b wall "
              f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"counts": out, "rows": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch import telemetry
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.gnn.sage import fanout_mean
    from repro_torch.graph import generate, partition_graph
    from repro_torch.kernels import frontier_unique as fu
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import gather_mean as gm
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import native, ops, ref, scenarios
    from repro_torch.kernels import score_update as su
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.telemetry.export import load_jsonl, write_jsonl
    from repro_torch.runtime import driver
    from repro_torch.store import FeatureStore
    from repro_torch.trace import load_trace
    from repro_torch.trace.cli import record_trace

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    max_err = defaultdict(float)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    # -- 0. the card ------------------------------------------------------ #
    print(card_line())
    print(
        f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}"
    )

    # -- 1. build --------------------------------------------------------- #
    t0 = time.perf_counter()
    reports = native.build_all(verbose=True)
    print(f"phase 1: built {sorted(native.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in ptxas_lines(log):
            print(f"  ptxas {name}: {line}")

    # -- 2. kernel vs plain on the scenario sets -------------------------- #
    native.reset_launches()
    cases = scenarios.frontier_scenarios()
    for sc in cases:
        args = to_device(sc.arrays().values(), dev)
        kw = dict(cand_cap=sc.cand_cap, **sc.constants)
        views = [(None, None, None)]
        if sc.name in ("rudder-u", "degree-w", "drained-Mt1"):
            P, C = sc.ids.shape
            N = sc.part_of.shape[0]
            rng = np.random.default_rng(7)
            views.append(tuple(to_device((
                rng.standard_normal((P * C, 5)).astype(np.float32),
                rng.standard_normal((N + 3, 5)).astype(np.float32),
                rng.permutation(N + 3)[:N].astype(np.int32),
            ), dev)))
        for view in views:
            got = fs.fused_frontier_step_cuda(*args, *view, **kw)
            want = ref.fused_frontier_step(*args, *view, **kw)
            torch.cuda.synchronize()
            max_err["fused_frontier_step"] = max(
                max_err["fused_frontier_step"],
                compare_outputs(got, want, FRONTIER_OUT, f"frontier {sc.name}"),
            )
    steps_cases = scenarios.fused_step_scenarios()
    for sc in steps_cases:
        args = to_device(sc.arrays().values(), dev)
        got = fs.fused_step_cuda(*args, num_ids=sc.num_ids, **sc.constants)
        want = ref.fused_step(*args, **sc.constants)
        torch.cuda.synchronize()
        max_err["fused_step"] = max(
            max_err["fused_step"],
            compare_outputs(got, want, STEP_OUT, f"fused_step {sc.name}"),
        )
    gathers = scenarios.gather_scenarios()
    for sc in gathers:
        tables, idx = to_device((sc.tables, sc.idx), dev)
        got = gr.gather_rows_batch_cuda(tables, idx)
        single = gr.gather_rows_cuda(tables[0].contiguous(), idx[0].contiguous())
        torch.cuda.synchronize()
        max_err["gather_rows_batch"] = max(
            max_err["gather_rows_batch"],
            compare_outputs(got, ref.gather_rows_batch(tables, idx), ["out"],
                            f"gather_rows_batch {sc.name}"),
        )
        max_err["gather_rows"] = max(
            max_err["gather_rows"],
            compare_outputs(single, ref.gather_rows(tables[0], idx[0]), ["out"],
                            f"gather_rows {sc.name}"),
        )
    # The wide sets, in both index modes of the kernels: as the wrapper
    # picks them (direct maps, the sorted mode for the sparse fused-step
    # sets), then with a map budget of 0, which forces the sorted mode.
    wide_cases = scenarios.wide_frontier_scenarios()
    budget = fs.MAP_BUDGET_BYTES
    for sc in wide_cases:
        args = to_device(sc.arrays().values(), dev)
        kw = sc.kwargs()
        views = [(None, None, None)]
        if sc.name.startswith(("rudder-u@", "degree-w@", "drained-Mt1@")):
            P, C = sc.ids.shape
            N = sc.part_of.shape[0]
            rng = np.random.default_rng(7)
            views.append(tuple(to_device((
                rng.standard_normal((P * C, 5)).astype(np.float32),
                rng.standard_normal((N + 3, 5)).astype(np.float32),
                rng.permutation(N + 3)[:N].astype(np.int32),
            ), dev)))
        for view in views:
            want = ref.fused_frontier_step_wide(*args, *view, **kw)
            for b in (budget, 0):
                fs.MAP_BUDGET_BYTES = b
                got = fs.fused_frontier_step_wide_cuda(*args, *view, **kw)
                torch.cuda.synchronize()
                max_err["fused_frontier_step_wide"] = max(
                    max_err["fused_frontier_step_wide"],
                    compare_outputs(got, want, FRONTIER_OUT,
                                    f"frontier wide {sc.name} budget={b}"),
                )
            fs.MAP_BUDGET_BYTES = budget
    wide_steps = scenarios.wide_fused_step_scenarios()
    for sc in wide_steps:
        args = to_device(sc.arrays().values(), dev)
        want = ref.fused_step_wide(*args, **sc.constants)
        for b in (budget, 0):
            fs.MAP_BUDGET_BYTES = b
            got = fs.fused_step_wide_cuda(
                *args, id_lo=sc.id_lo, num_ids=sc.num_ids, **sc.constants
            )
            torch.cuda.synchronize()
            max_err["fused_step_wide"] = max(
                max_err["fused_step_wide"],
                compare_outputs(got, want, STEP_OUT,
                                f"fused_step wide {sc.name} budget={b}"),
            )
        fs.MAP_BUDGET_BYTES = budget
    # The staged pipeline's kernels: the frontier dedup in both
    # instantiations (int64 keys within INT32_ID_MAX run narrow, as the
    # dispatcher routes them), the three score entries over every mode.
    unique_cases = scenarios.frontier_unique_scenarios()
    wide_unique = {}
    for sc in unique_cases:
        keys, flags = to_device((sc.keys, sc.is_remote), dev)
        wide = keys.dtype == torch.int64 and not ops.int32_id_eligible(sc.keys.max(initial=0))
        if wide:
            name, got = "frontier_unique_batch_wide", fu.frontier_unique_batch_wide_cuda(keys, flags)
            wide_unique[sc.name] = (keys, flags)
        else:
            keys = keys.to(torch.int32)
            name, got = "frontier_unique_batch", fu.frontier_unique_batch_cuda(keys, flags)
        want = ref.frontier_unique_batch(keys, flags)
        torch.cuda.synchronize()
        max_err[name] = max(
            max_err[name], compare_outputs(got, want, UNIQUE_OUT, f"{name} {sc.name}")
        )
        # The sampler's form, without part_of and with the set's.
        for part_of in [None] + ([sc.part_of] if sc.part_of is not None else []):
            pdev = None if part_of is None else to_device((part_of,), dev)[0]
            max_err[name] = max(max_err[name], check_compact(
                keys, pdev, f"{name} compact {sc.name}"))
    score_cases = scenarios.score_scenarios()
    for sc in score_cases:
        s_, a_, w_ = to_device((sc.scores, sc.accessed, sc.weights), dev)
        checks = [
            ("score_policy_update_batch",
             su.score_policy_update_batch_cuda(s_, a_, w_, **sc.constants),
             ref.score_policy_update_batch(s_, a_, w_, **sc.constants)),
            ("score_update_batch", su.score_update_batch_cuda(s_, a_),
             ref.score_update_batch(s_, a_)),
        ]
        for p_ in range(s_.shape[0]):
            row = (s_[p_].contiguous(), a_[p_].contiguous())
            checks.append(("score_update", su.score_update_cuda(*row), ref.score_update(*row)))
        torch.cuda.synchronize()
        for name, got, want in checks:
            max_err[name] = max(
                max_err[name], compare_outputs(got, want, SCORE_OUT, f"{name} {sc.name}")
            )
    # The GraphSAGE step's kernels, float32 and bfloat16.
    def typed(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.to(torch.bfloat16) if dtype == "bfloat16" else t

    mean_cases = scenarios.gather_mean_scenarios()
    for sc in mean_cases:
        table, idx = sc.tensors(dev)
        got = gm.gather_mean_cuda(table, idx)
        want = ref.gather_mean(table, idx)
        torch.cuda.synchronize()
        max_err["gather_mean"] = max(
            max_err["gather_mean"],
            compare_outputs(got, want, ["out"], f"gather_mean {sc.name}"),
        )
    sum_cases = scenarios.segment_sum_scenarios()
    for sc in sum_cases:
        data = sc.tensor(dev)
        for scale in (None, 1.0 / sc.k):  # the sum, and the fanout mean
            got = ss.segment_sum_equal_cuda(data, sc.k, scale)
            want = ref.segment_sum_equal(data, sc.k, scale)
            torch.cuda.synchronize()
            max_err["segment_sum_equal"] = max(
                max_err["segment_sum_equal"],
                compare_outputs(got, want, ["out"], f"segment_sum_equal {sc.name} scale={scale}"),
            )
    # The MLA decode on the reference test's shapes and the edge shapes,
    # float32 and bfloat16, inputs from a numpy seed, with the reference
    # test's near-uniform scores and with peaked ones; pos at 0, mid-tile,
    # at the edges of the first tiles and of the splits the wrapper picks
    # for the whole cache (each kernel's own), and at S - 1; then caches
    # whose rows past pos are NaN.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mla_cases = mla_nan_cases = 0
    mla_kernels = dict(md.KERNEL_LAUNCHES)
    mla_want = {"tensor_cores": 0, "cuda_cores": 0}
    for (b, h, r, rr, s_len), spread in itertools.product(MLA_SHAPES, (None, scenarios.PEAKED)):
        arrays = scenarios.mla_inputs(b, h, r, rr, s_len, spread=spread)
        for dtype, tol in MLA_TOL.items():
            rel = MLA_REL if spread and dtype == "bfloat16" else None
            args = [typed(a, dtype) for a in arrays]
            geom = md.geometry(args[2].dtype)
            _, chunk = md.split_plan(b, h, s_len, sms, geom)
            edges = {0, 17, geom.rows - 1, geom.rows, chunk - 1, chunk, 2 * chunk - 1,
                     s_len - 2, s_len - 1}
            for pos in sorted(p for p in edges if 0 <= p < s_len):
                max_err["mla_flash_decode"] = max(
                    max_err["mla_flash_decode"],
                    mla_check(md, ref, args, pos, 1.0 / (r + rr) ** 0.5, tol,
                              f"mla_flash_decode {(b, h, r, rr, s_len)} {dtype} pos={pos} "
                              f"spread={spread}", rel),
                )
                mla_cases += 1
                mla_want[md.kernel_name(args[2].dtype)] += 1
            if (b, h, r, rr, s_len) in MLA_NAN_SHAPES:
                for pos in (0, 37, s_len // 2):
                    max_err["mla_flash_decode"] = max(
                        max_err["mla_flash_decode"],
                        mla_nan_check(md, ref, args, pos, 1.0 / (r + rr) ** 0.5, tol,
                                      f"mla_flash_decode NaN tail {(b, h, r, rr, s_len)} "
                                      f"{dtype} pos={pos} spread={spread}"),
                    )
                    mla_nan_cases += 1
                    mla_want[md.kernel_name(args[2].dtype)] += 1
    mla_kernels = {k: v - mla_kernels[k] for k, v in md.KERNEL_LAUNCHES.items()}
    if mla_kernels != mla_want:
        raise AssertionError(f"phase 2: MLA kernels {mla_kernels}, want {mla_want} (bfloat16 "
                             "on the tensor cores, float32 on the CUDA cores)")
    phase2 = dict(native.LAUNCHES)
    print(
        f"phase 2: kernel == plain, bit-exact: fused_frontier_step on "
        f"{len(cases)} scenarios (3 also with a store table), fused_step on "
        f"{len(steps_cases)} ({', '.join(s.name for s in steps_cases)}), "
        f"gather_rows_batch and gather_rows on {len(gathers)} "
        f"({', '.join(s.name for s in gathers)}); fused_frontier_step_wide on "
        f"{len(wide_cases)} wide scenarios (bases {sorted({s.id_base for s in wide_cases})}; "
        f"3 per base also with a store table), fused_step_wide on {len(wide_steps)} "
        f"({', '.join(s.name for s in wide_steps)}), each in both index modes "
        f"(direct maps and sorted); frontier_unique_batch and its int64 twin on "
        f"{len(unique_cases)} sets ({', '.join(s.name for s in unique_cases)}), in the "
        f"reference's mask form and the sampler's compact form (without part_of, and with "
        f"the set's where it has one); "
        f"score_policy_update_batch, score_update_batch and score_update (per row) "
        f"on {len(score_cases)} ({', '.join(s.name for s in score_cases)}); "
        f"gather_mean on {len(mean_cases)} ({', '.join(s.name for s in mean_cases)}); "
        f"segment_sum_equal on {len(sum_cases)}, with and without 1 / k in its epilogue "
        f"({', '.join(s.name for s in sum_cases)}); "
        f"and to allclose (1e-4 float32, 3e-2 bfloat16): mla_flash_decode on "
        f"{mla_cases} cases ({len(MLA_SHAPES)} shapes x 2 dtypes x near-uniform and peaked "
        f"scores (bfloat16 peaked also max |diff| <= {MLA_REL} x max |plain|) x pos at 0, "
        f"mid-tile, the tile and split edges and S - 1) and {mla_nan_cases} NaN-tail cases "
        f"(finite, equal "
        f"to plain on a zeroed tail); max |diff| {max_err['mla_flash_decode']:.3g}; kernels "
        f"{mla_kernels}; "
        f"launches {phase2}"
    )

    # -- 3. the raw main path on the card --------------------------------- #
    t0 = time.perf_counter()
    g = generate("products", seed=0, scale=MAIN_SCALE)
    parts = partition_graph(g, 4)
    trainer = DistributedTrainer(parts, device=DEVICE, **RUN)
    steps = trainer.epochs * trainer.mb_per_epoch
    print(
        f"phase 3: products scale={MAIN_SCALE} ({g.num_nodes} nodes, {g.num_edges} edges, "
        f"{g.features.shape[1]}-dim features), P=4, capacity "
        f"{trainer.engine.capacity.tolist()}, {steps} steps; set-up "
        f"{time.perf_counter() - t0:.1f} s"
    )
    clock = StageClock(["fused_frontier_step_batch", *AGGREGATION_KERNELS],
                       by_ref=[trainer.features])
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_raw = dict(native.LAUNCHES)
    no_staged_launches("phase 3", launches_raw)
    agg_raw = check_aggregation("phase 3", launches_raw, trainer)

    if launches_raw["fused_frontier_step"] != steps + 1:
        raise AssertionError(f"launches {launches_raw} != steps + 1 = {steps + 1}")
    transfers = trainer.last_device_engine.transfers
    if transfers["h2d"] != steps + 1 or transfers["d2h"] != steps + 1:
        raise AssertionError(f"transfers {transfers} != one each per launch")
    losses = np.asarray(result.losses)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not all(len(log.pct_hits) == steps for log in result.logs):
        raise AssertionError("a PE logged the wrong number of steps")
    hits = int(trainer.engine.stats.hits.sum())
    if hits <= 0:
        raise AssertionError("the buffers never hit: the prefetch path did nothing")
    captured = clock.launches["fused_frontier_step_batch"]
    Mt = captured[1][0][6].shape[1] - 1
    print(
        f"phase 3: {steps} steps, launches {launches_raw} (fused_frontier_step = "
        f"steps + 1; gather_mean and segment_sum_equal = P * steps + 1 = "
        f"{agg_raw['gather_mean']}, the accuracy pass included), transfers "
        f"{transfers}, Mt = {Mt} per PE, "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f} (finite), buffer hits {hits}, "
        f"accuracy {result.accuracy:.4f}, wall {wall:.2f} s"
    )
    print_stages("phase 3", {
        "step": clock.ms("step"),
        "sample_host": clock.ms("sample"),
        "decide_host": clock.ms("decision"),
        # The last launch is the drained one (Mt = 1): leave it out.
        "launch_device_cuda_events": clock.device_ms("fused_frontier_step_batch", True),
        "launch_host": clock.ms("device.launch", True),
        "readback": clock.ms("device.readback", True),
        "train": clock.ms("train"),
    }, steps, wall)

    check_frontier_launches("phase 3", captured, False, max_err)
    n_agg = check_captured("phase 3", clock, max_err)
    print(f"phase 3: kernel == plain, bit-exact, on all {len(captured)} "
          f"launches of the run (Mt = {Mt}) and all {n_agg} gather_mean and "
          f"segment_sum_equal launches")
    in_run = {"phase 3": aggregation_in_run("phase 3", clock)}

    args, kw = captured[len(captured) // 2]
    k_ms, p_ms, _, raw = time_pair(
        lambda: fs.fused_frontier_step_cuda(*args, **kw),
        lambda: ref.fused_frontier_step(*args, **kw),
        flush,
    )
    outs = fs.fused_frontier_step_cuda(*args, **kw)
    nbytes = tensor_bytes(args, outs)
    nops = frontier_ops(args)
    b_ms, b_by = bound(nbytes, nops)
    timings = {"fused_frontier_step": (k_ms, p_ms, None, b_ms, b_by)}
    extras = {}  # the kernels line's further keys, by kernel
    print(
        f"phase 3: fused_frontier_step at P={args[0].shape[0]}, Mt={Mt}, "
        f"C={args[0].shape[1]}, K={args[8].shape[1]}: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
        f"plain {raw[2]:.4f}/{raw[3]:.4f} ms; {nbytes} bytes, {nops} ops; "
        f"bound {b_ms:.4f} ms ({b_by})"
    )
    print("phase 3: device time per launch by kernel (torch.profiler): "
          + profile_rows(lambda: fs.fused_frontier_step_cuda(*args, **kw)))
    print("phase 3: fused_frontier_step: "
          + device_ops_a_call(lambda: fs.fused_frontier_step_cuda(*args, **kw))
          + f"; wrapper host {host_ms(lambda: fs.fused_frontier_step_cuda(*args, **kw)):.4f} ms")

    # The aggregation kernels at the training step's shape (the accuracy
    # pass's launch is the last, at its own smaller batch).
    (table, idx), _ = clock.launches["gather_mean"][0]
    B, K = idx.shape
    F = table.shape[1]
    k_ms, p_ms, l_ms, raw = time_pair(
        lambda: gm.gather_mean_cuda(table, idx),
        lambda: ref.gather_mean(table, idx),
        flush,
        library=lambda: torch.nn.functional.embedding_bag(idx, table, mode="mean"),
    )
    # Distinct rows read once, every output row written once, the index.
    uniq = torch.unique(idx).numel()
    nbytes = uniq * F * 4 + B * F * 4 + idx.numel() * idx.element_size()
    nops = B * K * F + B * F  # an add per gathered element, a multiply per output
    b_ms, b_by = bound(nbytes, nops)
    timings["gather_mean"] = (k_ms, p_ms, l_ms, b_ms, b_by)
    print(
        f"phase 3: gather_mean at table ({table.shape[0]}, {F}) {table.dtype}, indices "
        f"({B}, {K}) {idx.dtype}: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, plain "
        f"{raw[2]:.4f}/{raw[3]:.4f} ms, embedding_bag(mean) {l_ms:.4f} ms; {nbytes} "
        f"bytes ({uniq} distinct rows read, {B} written), {nops} ops; bound "
        f"{b_ms:.4f} ms ({b_by})"
    )
    print("phase 3: gather_mean device time per launch by kernel (torch.profiler): "
          + profile_rows(lambda: gm.gather_mean_cuda(table, idx)))
    extras["gather_mean"] = call_numbers(
        "phase 3", "gather_mean", lambda: gm.gather_mean_cuda(table, idx), "gather_mean_kernel")
    floor = gather_l2_floor(table, idx, flush)
    extras["gather_mean"]["l2_floor_ms"] = floor["l2_floor_ms"]
    print(f"phase 3: gather_mean's L2 floor {floor['l2_floor_ms']:.4f} ms beside its bound "
          f"{b_ms:.4f} ms: {floor['distinct_bytes']} distinct bytes read once from DRAM in "
          f"{floor['dram_read_ms']:.4f} ms, {floor['reread_bytes']} re-read bytes at the "
          f"L2-resident rate {floor['l2_read_rate'] / 1e12:.3f} TB/s; kernel alone at "
          + (f"{b_ms / extras['gather_mean']['kernel_alone_ms']:.1%} of the bound and "
             f"{floor['l2_floor_ms'] / extras['gather_mean']['kernel_alone_ms']:.1%} of the "
             "floor" if extras["gather_mean"]["kernel_alone_ms"] else "not measured"))
    (data, k), _ = clock.launches["segment_sum_equal"][0]
    seg_shape = (data.shape[0] // k, k, data.shape[1])
    k_ms, p_ms, l_ms, raw = time_pair(
        lambda: ss.segment_sum_equal_cuda(data, k),
        lambda: ref.segment_sum_equal(data, k),
        flush,
        library=lambda: data.view(seg_shape).sum(1),
    )
    outs = ss.segment_sum_equal_cuda(data, k)
    nbytes = tensor_bytes((data,), (outs,))
    b_ms, b_by = bound(nbytes, data.numel())
    timings["segment_sum_equal"] = (k_ms, p_ms, l_ms, b_ms, b_by)
    print(
        f"phase 3: segment_sum_equal at data {tuple(data.shape)}, k={k} (x_n1): kernel "
        f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
        f"view(S, k, F).sum(1) {l_ms:.4f} ms; {nbytes} bytes, {data.numel()} ops; "
        f"bound {b_ms:.4f} ms ({b_by})"
    )
    print("phase 3: segment_sum_equal device time per launch by kernel (torch.profiler): "
          + profile_rows(lambda: ss.segment_sum_equal_cuda(data, k)))
    extras["segment_sum_equal"] = call_numbers(
        "phase 3", "segment_sum_equal on x_n1", lambda: ss.segment_sum_equal_cuda(data, k),
        "segment_sum_kernel")
    x_n1 = data.view(seg_shape)
    extras["segment_sum_equal"]["fanout_mean"] = call_numbers(
        "phase 3", "fanout_mean on x_n1 (the sum with 1 / k in its epilogue)",
        lambda: fanout_mean(x_n1), "segment_sum_kernel")
    # Phases 6 and 7 rebase this graph and compare with this run.
    g_main, main, mt_main = g, (trainer, result), Mt
    stages_main = stage_medians(clock)
    # Phases 11 and 12 run phase 3's graph again and compare with this run.
    parts_main, result_main = parts, result
    stats_main = {f: getattr(trainer.engine.stats, f).copy() for f in STATS}
    del trainer, result, clock, captured, g, parts, table, idx, data, outs

    # -- 3b. the ragged path, with the feature store ----------------------- #
    t0 = time.perf_counter()
    g = generate("papers", seed=0, scale=RAGGED_SCALE)
    parts = partition_graph(g, 4)
    store = FeatureStore.for_partitions(parts, device=DEVICE, use_kernel=True)
    trainer = DistributedTrainer(parts, device=DEVICE, feature_store=store, **RAGGED)
    steps = trainer.epochs * trainer.mb_per_epoch
    train_sizes = [len(t) for t in trainer.local_train]
    print(
        f"phase 3b: papers scale={RAGGED_SCALE} ({g.num_nodes} nodes, {g.num_edges} "
        f"edges, {g.features.shape[1]}-dim features, store table {store.nbytes} B "
        f"on the card), P=4, local train sets {train_sizes} < batch "
        f"{RAGGED['batch_size']}, capacity {trainer.engine.capacity.tolist()}, "
        f"{steps} steps; set-up {time.perf_counter() - t0:.1f} s"
    )
    if steps != RAGGED["epochs"] or min(train_sizes) >= RAGGED["batch_size"]:
        raise AssertionError("phase 3b: expected ragged blocks and one step per epoch")
    clock = StageClock(["fused_step_readback_batch", "gather_rows_batch", "gather_rows",
                        *AGGREGATION_KERNELS])
    native.reset_launches()
    store.kernel_gathers = store.flat_gathers = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_ragged = dict(native.LAUNCHES)
    no_staged_launches("phase 3b", launches_ragged)
    agg_ragged = check_aggregation("phase 3b", launches_ragged, trainer)
    if launches_ragged["fused_step"] != steps + 1:
        raise AssertionError(f"launches {launches_ragged} != steps + 1 = {steps + 1}")
    if launches_ragged["fused_frontier_step"] != 0:
        raise AssertionError("the ragged run took the raw path")
    check_store_launches("phase 3b", launches_ragged, store, trainer)
    losses = np.asarray(result.losses)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    hits = int(trainer.engine.stats.hits.sum())
    if hits <= 0:
        raise AssertionError("phase 3b: the buffers never hit")
    if result.total_bytes_measured != result.total_bytes_modeled:
        raise AssertionError("phase 3b: measured bytes != modeled bytes")
    transfers = trainer.last_device_engine.transfers
    step_caps = clock.launches["fused_step_readback_batch"]
    print(
        f"phase 3b: {steps} steps, launches {launches_ragged} (fused_step = steps + 1, "
        f"gather_rows_batch = the store's {store.kernel_gathers} per-home gathers of the "
        f"misses and admissions, gather_rows = its {store.flat_gathers} flat gathers of "
        f"each PE's training rows, P * steps + 1, "
        f"segment_sum_equal = 2 * (P * steps + 1) = {agg_ragged['segment_sum_equal']}, "
        f"gather_mean = 0: the store serves the rows), "
        f"transfers {transfers}, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (finite), buffer hits {hits}, "
        f"bytes measured == modeled == {result.total_bytes_measured}, "
        f"accuracy {result.accuracy:.4f}, wall {wall:.2f} s"
    )
    print_stages("phase 3b", {
        "step": clock.ms("step"),
        "sample_host": clock.ms("sample"),
        "decide_host": clock.ms("decision"),
        "launch_device_cuda_events": clock.device_ms("fused_step_readback_batch", True),
        "launch_host": clock.ms("device.launch", True),
        # Launch readback (the sync that waits for the kernel) plus the
        # payload's pull_rows readback, summed per step.
        "readback_per_step": clock.per_step("device.readback"),
        "store_serve": clock.ms("fetch.serve"),
        "store_gathers_device_cuda_events": clock.device_ms("gather_rows_batch"),
        "train_gathers_device_cuda_events": clock.device_ms("gather_rows"),
        "train": clock.ms("train"),
    }, steps, wall)

    timings["fused_step"], extras["fused_step"] = check_fused_step(
        "phase 3b", step_caps, False, flush, max_err)
    gather_caps, flat_caps = check_store_gathers("phase 3b", clock, max_err)
    n_agg = check_captured("phase 3b", clock, max_err)
    print(f"phase 3b: kernel == plain, bit-exact, on all {len(gather_caps)} "
          f"gather_rows_batch, {len(flat_caps)} gather_rows and {n_agg} "
          f"segment_sum_equal launches of the run")
    # The layer-2 mean over the store's rows: the run's largest reduction.
    data, k = max(clock.launches["segment_sum_equal"], key=lambda c: c[0][0].numel())[0]
    seg_shape = (data.shape[0] // k, k, data.shape[1])
    k_ms, p_ms, l_ms, raw = time_pair(
        lambda: ss.segment_sum_equal_cuda(data, k),
        lambda: ref.segment_sum_equal(data, k),
        flush,
        library=lambda: data.view(seg_shape).sum(1),
    )
    outs = ss.segment_sum_equal_cuda(data, k)
    nbytes = tensor_bytes((data,), (outs,))
    b_ms, b_by = bound(nbytes, data.numel())
    print(
        f"phase 3b: segment_sum_equal at data {tuple(data.shape)}, k={k} (x_n2 from the "
        f"store): kernel {raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
        f"view(S, k, F).sum(1) {l_ms:.4f} ms; {nbytes} bytes, {data.numel()} ops; "
        f"bound {b_ms:.4f} ms ({b_by}); device ms per launch over the run (CUDA "
        f"events), median {float(np.median(clock.device_ms('segment_sum_equal'))):.4f}"
    )
    extras["segment_sum_equal"]["x_n2"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
        **call_numbers("phase 3b", "segment_sum_equal on x_n2",
                       lambda: ss.segment_sum_equal_cuda(data, k), "segment_sum_kernel"),
    }
    in_run["phase 3b"] = aggregation_in_run("phase 3b", clock)
    del data, outs

    # The largest per-home gather of the run (a step's misses and admissions).
    tables, idx = max(gather_caps, key=lambda c: c[0][1].numel())[0]
    P, N, F = tables.shape
    Mg = idx.shape[1]
    idx_long = idx.long()[:, :, None].expand(P, Mg, F).contiguous()
    k_ms, p_ms, l_ms, raw = time_pair(
        lambda: gr.gather_rows_batch_cuda(tables, idx),
        lambda: ref.gather_rows_batch(tables, idx),
        flush,
        library=lambda: torch.gather(tables, 1, idx_long),
    )
    # The rows this gather must read are its distinct (shard, row) pairs:
    # a gather that repeats a row reads it again from L2.
    uniq = torch.unique(
        idx.long() + N * torch.arange(P, device=dev)[:, None]
    ).numel()
    nbytes = uniq * F * 4 + P * Mg * F * 4 + P * Mg * 4
    b_ms, b_by = bound(nbytes, 0)
    timings["gather_rows_batch"] = (k_ms, p_ms, l_ms, b_ms, b_by)
    print(
        f"phase 3b: gather_rows_batch at P={P}, N_max={N}, M={Mg}, F={F}: kernel "
        f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
        f"torch.gather {l_ms:.4f} ms; {nbytes} bytes ({uniq} distinct rows read, "
        f"{P * Mg} written); bound {b_ms:.4f} ms ({b_by})"
    )
    # The largest flat gather of the run: a PE's training rows, read from
    # the flat table through the store's node -> row map in the launch.
    table_f, ids_f, loc_f = max(flat_caps, key=lambda c: c[0][1].numel())[0]
    Mf, Ff = ids_f.shape[0], table_f.shape[1]
    rows_f = loc_f[ids_f.long()].long()
    k_ms, p_ms, l_ms, raw = time_pair(
        lambda: gr.gather_rows_cuda(table_f, ids_f, loc_f),
        lambda: ref.gather_rows(table_f, ids_f, loc_f),
        flush,
        library=lambda: table_f.index_select(0, loc_f[ids_f.long()].long()),
    )
    uniq_f = torch.unique(rows_f).numel()
    # Distinct rows read, rows written, the ids and their map entries.
    nbytes = uniq_f * Ff * 4 + Mf * Ff * 4 + Mf * 4 + Mf * 4
    b_ms, b_by = bound(nbytes, 0)
    timings["gather_rows"] = (k_ms, p_ms, l_ms, b_ms, b_by)
    print(
        f"phase 3b: gather_rows with the map at N={table_f.shape[0]}, M={Mf}, F={Ff} "
        f"(the store's flat table, a PE's training rows): kernel "
        f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
        f"map lookup + index_select {l_ms:.4f} ms; {nbytes} bytes ({uniq_f} distinct rows "
        f"read); bound {b_ms:.4f} ms ({b_by}); device ms per launch over the run (CUDA "
        f"events), median {float(np.median(clock.device_ms('gather_rows'))):.4f}"
    )
    g_papers, papers = g, (trainer, result)
    parts_papers, result_papers = parts, result
    stages_papers = {k: round(float(np.median(v)), 3) for k, v in {
        "step": clock.ms("step"), "sample_host": clock.ms("sample"),
        "store_serve": clock.ms("fetch.serve"), "train": clock.ms("train")}.items()}
    stats_papers = {f: getattr(trainer.engine.stats, f).copy() for f in STATS}
    del trainer, result, clock, step_caps, gather_caps, flat_caps, store, g, parts, tables, idx
    del table_f, ids_f, loc_f, rows_f

    # -- 4. card vs CPU, end to end --------------------------------------- #
    g1 = generate("products", seed=0, scale=SMALL_SCALE)
    p1g = partition_graph(g1, 4)
    g2 = generate("products", seed=0, scale=SMALL_RAGGED_SCALE)
    p2g = partition_graph(g2, 4)
    p1w = partition_graph(g1.rebase(WIDE_BASE), 4)
    p1s = partition_graph(g1.rebase(ops.WIDE_ID_MAX), 4)
    for what, parts_, cfg, with_store in (
        ("raw", p1g, SMALL, False),
        ("raw + store", p1g, SMALL, True),
        ("ragged + store", p2g, SMALL_RAGGED, True),
        ("raw, wide ids", p1w, SMALL, False),
        ("raw, cadence", p1g, dict(SMALL, variant="fixed", readback_every=CADENCE), False),
        ("staged fall-back", p1s, SMALL, False),
    ):
        staged = what.startswith("staged")
        raw_path = what.startswith("raw")
        runs = {}
        for where in ("card", "cpu"):
            d = DEVICE if where == "card" else "cpu"
            extra = {}
            if with_store:
                extra["feature_store"] = FeatureStore.for_partitions(
                    parts_, device=d, use_kernel=True
                )
            tr = DistributedTrainer(parts_, device=d, **cfg, **extra)
            native.reset_launches()
            run, warned = run_warned(tr)
            runs[where] = (tr, run, warned, dict(native.LAUNCHES))
        (tc, rc, wc, lc), (th, rh, wh, _) = runs["card"], runs["cpu"]
        check_aggregation(f"phase 4 ({what})", lc, tc)
        if staged:
            steps = tc.epochs * tc.mb_per_epoch
            if tc.last_device_engine is not None or len(wc) != 1 or len(wh) != 1:
                raise AssertionError(f"phase 4 ({what}): no fall-back ({wc}, {wh})")
            if (lc["frontier_unique_batch"] != steps
                    or lc["score_policy_update_batch"] != steps):
                raise AssertionError(f"phase 4 ({what}): launches {lc}")
        elif driver._device_raw_supported(tc) != raw_path:
            raise AssertionError(f"phase 4 ({what}) took the other loop")
        else:
            no_staged_launches(f"phase 4 ({what})", lc)
        diff = compare_runs(f"card vs CPU ({what})", tc, rc, th, rh, with_store)
        print(
            f"phase 4 ({what}): batch {cfg['batch_size']}, {len(rc.losses)} steps: card == "
            f"CPU on every stream ({', '.join(STREAMS + (STORE_STREAMS if with_store else ()))}), "
            f"engine.stats and buffer state{' and payload' if with_store else ''}; losses "
            f"allclose (rtol={LOSS_RTOL}, atol={LOSS_ATOL}), max |diff| {diff:.3g}; "
            f"aggregation launches {({k: lc[k] for k in AGGREGATION_KERNELS})}"
        )

    # -- 4b. the telemetry session on the card ----------------------------- #
    runs = {}
    for on in (False, True):
        tr = DistributedTrainer(p1g, device=DEVICE, trace=True, telemetry=on, **SMALL)
        native.reset_launches()
        run = tr.run()
        torch.cuda.synchronize()
        runs[on] = (tr, run, dict(native.LAUNCHES))
    (t_off, r_off, _), (t_on, r_on, l_on) = runs[False], runs[True]
    if t_on.last_trace.exact_digest() != t_off.last_trace.exact_digest():
        raise AssertionError("phase 4b: telemetry on moved the exact digest")
    diff = compare_runs("phase 4b (telemetry on vs off)", t_on, r_on, t_off, r_off, False)
    check_aggregation("phase 4b", l_on, t_on)
    session = t_on.last_telemetry
    if session is None or r_on.telemetry is None or r_off.telemetry is not None:
        raise AssertionError("phase 4b: the session did not land on the trainer and result")
    reg = session.registry
    for name, n in l_on.items():
        if not n:
            continue
        key = f"kernel.{DISPATCHER_OF.get(name, name)}.calls"
        if key not in reg or reg[key].total != n:
            raise AssertionError(f"phase 4b: {key} != {n} launches of {name}")
    # A step's train plane: its `train` span, and each PE's inputs and
    # loss wait (`train.features`, `train.wait`).
    train_spans = [sp for sp in session.tracer.spans if sp.plane == "train"]
    steps_on = t_on.epochs * t_on.mb_per_epoch
    by_name = Counter(sp.name for sp in train_spans)
    pe_steps = t_on.parts.num_parts * steps_on
    want = {"train": steps_on, "train.features": pe_steps, "train.wait": pe_steps}
    if by_name != want:
        raise AssertionError(f"phase 4b: train-plane spans {dict(by_name)} != {want}")
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = write_jsonl(session, Path(tmp) / "run.jsonl")
        chrome = Path(tmp) / "trace.json"
        session.write_chrome_trace(chrome)
        artifact = load_jsonl(jsonl)
        events = json.loads(chrome.read_text())["traceEvents"]
    n_complete = sum(1 for e in events if e.get("ph") == "X")
    if (not len(artifact["spans"]) == len(session.tracer.spans) == n_complete
            or artifact["meta"]["provenance"]["cuda"] != torch.version.cuda):
        raise AssertionError("phase 4b: the artifacts did not load back")
    seconds = {
        name: {
            "count": reg[f"kernel.{name}.seconds"].count,
            "p50_ms": round(1e3 * reg[f"kernel.{name}.seconds"].percentile(50), 4),
        }
        for name in AGGREGATION_KERNELS
    }
    print(
        f"phase 4b: telemetry on, batch {SMALL['batch_size']}, {len(r_on.losses)} steps: "
        f"exact_digest and every stream equal the telemetry-off run's (losses max "
        f"|diff| {diff:.3g}); kernel.<name>.calls == launches for "
        f"{ {k: v for k, v in l_on.items() if v} }; {len(train_spans)} train-plane spans; "
        f"JSONL ({len(artifact['spans'])} spans) and Chrome trace ({n_complete} events) "
        f"loaded back; kernel.<name>.seconds (host clock to the kernels' end): "
        + json.dumps(seconds)
    )
    digest_small = t_off.last_trace.exact_digest()  # phase 11's legacy twin
    del runs, t_off, r_off, t_on, r_on, session, reg

    # -- 5. the goldens on the card --------------------------------------- #
    goldens = sorted((ROOT / "tests" / "golden").glob("*.json"))
    if len(goldens) != 8:
        raise AssertionError(f"expected 8 goldens, found {len(goldens)}")
    t0 = time.perf_counter()
    for path in goldens:
        golden = load_trace(str(path))
        for runtime in ("vectorized", "legacy"):
            for with_store in (False, True):
                fresh = record_trace(dict(golden.config, feature_store=with_store),
                                     runtime=runtime, device=DEVICE)
                if fresh.exact_digest() != golden.exact_digest():
                    raise AssertionError(
                        f"golden {path.stem} ({runtime}, store={with_store}) drifted")
    print(f"phase 5: all {len(goldens)} goldens re-recorded on the card, on both runtimes "
          f"(vectorized: the device loops; legacy: the per-PE host loop), modeled and "
          f"with the feature store: exact_digest matched "
          f"({', '.join(p.stem for p in goldens)}); {time.perf_counter() - t0:.1f} s")

    # -- 6. the wide raw loop at full width --------------------------------- #
    t0 = time.perf_counter()
    parts = partition_graph(g_main.rebase(WIDE_BASE), 4)
    trainer = DistributedTrainer(parts, device=DEVICE, **RUN)
    steps = trainer.epochs * trainer.mb_per_epoch
    print(f"phase 6: products scale={MAIN_SCALE} rebased to id_base {WIDE_BASE} "
          f"(ids {WIDE_BASE}..{WIDE_BASE + g_main.num_nodes - 1}), phase 3's run; "
          f"set-up {time.perf_counter() - t0:.1f} s")
    clock = StageClock(["fused_frontier_step_wide_batch", *AGGREGATION_KERNELS],
                       by_ref=[trainer.features])
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_wide = dict(native.LAUNCHES)
    no_staged_launches("phase 6", launches_wide)
    check_aggregation("phase 6", launches_wide, trainer)
    if launches_wide["fused_frontier_step_wide"] != steps + 1 or launches_wide["fused_frontier_step"]:
        raise AssertionError(f"phase 6: launches {launches_wide}")
    dev_w = trainer.last_device_engine
    if not dev_w.wide or dev_w.transfers["h2d"] != steps + 1 or dev_w.transfers["d2h"] != steps + 1:
        raise AssertionError(f"phase 6: wide {dev_w.wide}, transfers {dev_w.transfers}")
    diff = compare_runs("phase 6 (wide vs phase 3)", trainer, result, *main, False, WIDE_BASE)
    captured = clock.launches["fused_frontier_step_wide_batch"]
    print(
        f"phase 6: {steps} steps, launches {launches_wide} (fused_frontier_step_wide = "
        f"steps + 1, no narrow launch), transfers {dev_w.transfers}; every stream, "
        f"engine.stats and the buffer state equal phase 3's (ids + {WIDE_BASE}), losses "
        f"allclose (max |diff| {diff:.3g}); wall {wall:.2f} s"
    )
    print_stages("phase 6", {
        "step": clock.ms("step"),
        "sample_host": clock.ms("sample"),
        "decide_host": clock.ms("decision"),
        "launch_device_cuda_events": clock.device_ms("fused_frontier_step_wide_batch", True),
        "launch_host": clock.ms("device.launch", True),
        "readback": clock.ms("device.readback", True),
        "train": clock.ms("train"),
    }, steps, wall)
    wide_stages = stage_medians(clock)
    print("phase 6 vs phase 3, median ms per step: " + json.dumps(
        {k: [round(wide_stages[k], 3), round(v, 3)] for k, v in stages_main.items()}))
    check_frontier_launches("phase 6", captured, True, max_err)
    n_agg = check_captured("phase 6", clock, max_err)
    print(f"phase 6: kernel == plain, bit-exact, on all {len(captured)} launches of the run "
          f"and all {n_agg} gather_mean and segment_sum_equal launches")
    in_run["phase 6"] = aggregation_in_run("phase 6", clock)
    args, kw = captured[len(captured) // 2]
    k_ms, p_ms, _, raw = time_pair(
        lambda: fs.fused_frontier_step_wide_cuda(*args, **kw),
        lambda: ref.fused_frontier_step_wide(*args, **kw),
        flush,
    )
    outs = fs.fused_frontier_step_wide_cuda(*args, **kw)
    nbytes = tensor_bytes(args, outs)
    nops = frontier_ops(args)
    b_ms, b_by = bound(nbytes, nops)
    timings["fused_frontier_step_wide"] = (k_ms, p_ms, None, b_ms, b_by)
    print(
        f"phase 6: fused_frontier_step_wide at P={args[0].shape[0]}, "
        f"Mt={args[6].shape[1] - 1}, C={args[0].shape[1]}, K={args[8].shape[1]}: "
        f"kernel {raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms; "
        f"{nbytes} bytes, {nops} ops; bound {b_ms:.4f} ms ({b_by})"
    )
    print("phase 6: device time per launch by kernel (torch.profiler): "
          + profile_rows(lambda: fs.fused_frontier_step_wide_cuda(*args, **kw)))
    print("phase 6: fused_frontier_step_wide: "
          + device_ops_a_call(lambda: fs.fused_frontier_step_wide_cuda(*args, **kw))
          + f"; wrapper host {host_ms(lambda: fs.fused_frontier_step_wide_cuda(*args, **kw)):.4f} ms")
    del trainer, result, clock, captured, parts, dev_w

    # -- 6b. the wide ragged loop, with the feature store ------------------ #
    t0 = time.perf_counter()
    parts = partition_graph(g_papers.rebase(WIDE_BASE), 4)
    store = FeatureStore.for_partitions(parts, device=DEVICE, use_kernel=True)
    trainer = DistributedTrainer(parts, device=DEVICE, feature_store=store, **RAGGED)
    steps = trainer.epochs * trainer.mb_per_epoch
    print(f"phase 6b: papers scale={RAGGED_SCALE} rebased to id_base {WIDE_BASE}, "
          f"phase 3b's run; set-up {time.perf_counter() - t0:.1f} s")
    clock = StageClock(["fused_step_readback_batch", "gather_rows_batch", "gather_rows",
                        *AGGREGATION_KERNELS])
    native.reset_launches()
    store.kernel_gathers = store.flat_gathers = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_wide_ragged = dict(native.LAUNCHES)
    no_staged_launches("phase 6b", launches_wide_ragged)
    check_aggregation("phase 6b", launches_wide_ragged, trainer)
    check_store_launches("phase 6b", launches_wide_ragged, store, trainer)
    if (launches_wide_ragged["fused_step_wide"] != steps + 1
            or launches_wide_ragged["fused_step"]
            or any(launches_wide_ragged[k] != launches_ragged[k]
                   for k in ("gather_rows_batch", "gather_rows"))):
        raise AssertionError(f"phase 6b: launches {launches_wide_ragged}")
    gathers_6b, flat_6b = check_store_gathers("phase 6b", clock, max_err)
    diff = compare_runs("phase 6b (wide vs phase 3b)", trainer, result, *papers, True, WIDE_BASE)
    print(
        f"phase 6b: {steps} steps, launches {launches_wide_ragged} (fused_step_wide = "
        f"steps + 1, gather_rows_batch and gather_rows = phase 3b's, all "
        f"{len(gathers_6b)} + {len(flat_6b)} bit-exact, the flat gathers from ids "
        f"rebased on the host), transfers "
        f"{trainer.last_device_engine.transfers}; every stream (feat_sums and bytes "
        f"included), engine.stats, the buffer state and payload equal phase 3b's "
        f"(ids + {WIDE_BASE}), losses allclose (max |diff| {diff:.3g}); wall {wall:.2f} s"
    )
    print_stages("phase 6b", {
        "step": clock.ms("step"),
        "sample_host": clock.ms("sample"),
        "launch_device_cuda_events": clock.device_ms("fused_step_readback_batch", True),
        "launch_host": clock.ms("device.launch", True),
        "readback_per_step": clock.per_step("device.readback"),
        "store_serve": clock.ms("fetch.serve"),
        "train": clock.ms("train"),
    }, steps, wall)
    step_caps = clock.launches["fused_step_readback_batch"]
    timings["fused_step_wide"], extras["fused_step_wide"] = check_fused_step(
        "phase 6b", step_caps, True, flush, max_err)
    n_agg = check_captured("phase 6b", clock, max_err)
    print(f"phase 6b: kernel == plain, bit-exact, on all {n_agg} segment_sum_equal "
          f"launches of the run")
    in_run["phase 6b"] = aggregation_in_run("phase 6b", clock)
    del trainer, result, clock, step_caps, store, parts, papers, g_papers, gathers_6b, flat_6b

    # -- 7. the readback cadence ------------------------------------------ #
    g_wide = g_main.rebase(WIDE_BASE)
    for tag, graph in (("narrow", g_main), ("wide", g_wide)):
        parts = partition_graph(graph, 4)
        runs = {}
        for k in (1, CADENCE):
            tr = DistributedTrainer(parts, device=DEVICE, readback_every=k, **FIXED)
            clock = StageClock([])
            native.reset_launches()
            torch.cuda.synchronize()
            with telemetry.active(clock):
                run = tr.run()
            torch.cuda.synchronize()
            runs[k] = (tr, run, clock, dict(native.LAUNCHES))
        (t1, r1, c1, l1), (tk, rk, ck, lk) = runs[1], runs[CADENCE]
        no_staged_launches(f"phase 7 ({tag}, K=1)", l1)
        no_staged_launches(f"phase 7 ({tag}, K={CADENCE})", lk)
        check_aggregation(f"phase 7 ({tag}, K=1)", l1, t1)
        check_aggregation(f"phase 7 ({tag}, K={CADENCE})", lk, tk)
        steps = tk.epochs * tk.mb_per_epoch
        kernel = "fused_frontier_step_wide" if tag == "wide" else "fused_frontier_step"
        if l1[kernel] != steps + 1 or lk[kernel] != steps + 1:
            raise AssertionError(f"phase 7 ({tag}): launches {l1} / {lk}")
        d2h = tk.last_device_engine.transfers["d2h"]
        if d2h != math.ceil((steps + 1) / CADENCE) or t1.last_device_engine.transfers["d2h"] != steps + 1:
            raise AssertionError(f"phase 7 ({tag}): d2h {d2h} with K={CADENCE}")
        diff = compare_runs(f"phase 7 ({tag}, K={CADENCE} vs K=1)", tk, rk, t1, r1, False)
        cad_ms = sum(ck.ms("device.readback")) / steps
        k1_ms = float(np.median(c1.ms("device.readback", True)))
        print(
            f"phase 7 ({tag}): fixed, readback_every={CADENCE}: {steps} steps, "
            f"{lk[kernel]} {kernel} launches, d2h {d2h} pulls against "
            f"{t1.last_device_engine.transfers['d2h']} at K=1; logs, engine.stats and "
            f"buffer state equal the K=1 run's, losses allclose (max |diff| {diff:.3g}); "
            f"readback {cad_ms:.4f} ms per step (all {d2h} pulls / {steps} steps) against "
            f"{k1_ms:.4f} ms median at K=1 (phase 3: {stages_main.get('readback', 0.0):.4f}); "
            f"step median {np.median(ck.ms('step')):.3f} ms against {np.median(c1.ms('step')):.3f}"
        )
        if tag == "narrow":
            launches_cadence = lk
        else:
            launches_cadence_wide = lk
        del runs, t1, r1, tk, rk, parts
    del g_wide

    # -- 8. the staged fall-back at full width ------------------------------ #
    t0 = time.perf_counter()
    parts = partition_graph(g_main.rebase(ops.WIDE_ID_MAX), 4)
    trainer = DistributedTrainer(parts, device=DEVICE, **RUN)
    steps = trainer.epochs * trainer.mb_per_epoch
    print(f"phase 8: products scale={MAIN_SCALE} rebased to id_base WIDE_ID_MAX = "
          f"{ops.WIDE_ID_MAX} (ids past the wide-id bound), phase 3's run on "
          f"device={DEVICE!r}; set-up {time.perf_counter() - t0:.1f} s")
    clock = StageClock(["frontier_unique_batch", "score_policy_update_batch",
                        *AGGREGATION_KERNELS], by_ref=[trainer.features])
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result, warned = run_warned(trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_staged = dict(native.LAUNCHES)
    if len(warned) != 1 or FALLBACK_WARNING not in warned[0]:
        raise AssertionError(f"phase 8: warnings {warned}")
    check_aggregation("phase 8", launches_staged, trainer)
    others = {k: v for k, v in launches_staged.items()
              if v and k not in ("frontier_unique_batch", "score_policy_update_batch",
                                 *AGGREGATION_KERNELS)}
    if (launches_staged["frontier_unique_batch"] != steps
            or launches_staged["score_policy_update_batch"] != steps or others):
        raise AssertionError(f"phase 8: launches {launches_staged}")
    if trainer.last_device_engine is not None:
        raise AssertionError("phase 8: the run took a device loop")
    unique_caps = clock.launches["frontier_unique_batch"]
    score_caps = clock.launches["score_policy_update_batch"]
    keys_shape = {(tuple(a[0].shape), a[0].dtype) for a, _ in unique_caps}
    score_shape = {tuple(a[0].shape) for a, _ in score_caps}
    C = trainer.engine.max_capacity
    if keys_shape != {((4, mt_main), torch.int32)} or score_shape != {(4, C)}:
        raise AssertionError(f"phase 8: shapes {keys_shape} / {score_shape}")
    diff = compare_runs("phase 8 (staged vs phase 3)", trainer, result, *main, False,
                        ops.WIDE_ID_MAX)
    print(
        f"phase 8: {steps} steps, one RuntimeWarning ({warned[0]!r}), launches "
        f"{ {k: v for k, v in launches_staged.items() if v} } on keys {keys_shape} "
        f"and scores {score_shape}; every stream, engine.stats and the buffer "
        f"state equal phase 3's (ids + WIDE_ID_MAX), losses allclose (max |diff| "
        f"{diff:.3g}); wall {wall:.2f} s"
    )
    staged_stages = {
        "step": clock.ms("step"),
        "sample": clock.ms("sample"),
        "fetch.probe": clock.ms("fetch.probe"),
        "fetch.commit": clock.ms("fetch.commit"),
        "decide_host": clock.ms("decision"),
        "frontier_unique_batch_device_cuda_events": clock.device_ms("frontier_unique_batch"),
        "score_policy_update_batch_device_cuda_events": clock.device_ms(
            "score_policy_update_batch"),
        "train": clock.ms("train"),
    }
    print_stages("phase 8", staged_stages, steps, wall)
    if not all(kw.get("compact") and kw.get("part_of") is not None for _, kw in unique_caps):
        raise AssertionError("phase 8: the sampler's dedup did not take the compact form")
    for i, (args, kw) in enumerate(unique_caps):
        max_err["frontier_unique_batch"] = max(
            max_err["frontier_unique_batch"],
            check_compact(args[0], kw["part_of"], f"phase 8 dedup {i}"),
        )
    for i, (args, kw) in enumerate(score_caps):
        got = su.score_policy_update_batch_cuda(*args, **kw)
        want = ref.score_policy_update_batch(*args, **kw)
        torch.cuda.synchronize()
        max_err["score_policy_update_batch"] = max(
            max_err["score_policy_update_batch"],
            compare_outputs(got, want, SCORE_OUT, f"phase 8 score {i}"),
        )
    n_agg = check_captured("phase 8", clock, max_err)
    print(f"phase 8: kernel == plain, bit-exact, on all {len(unique_caps)} "
          f"frontier_unique_batch (the sampler's compact form) and {len(score_caps)} "
          f"score_policy_update_batch launches of the run and all {n_agg} gather_mean and "
          "segment_sum_equal launches")
    in_run["phase 8"] = aggregation_in_run("phase 8", clock)

    # The sampler hook's split, its steps one at a time on the run's plane
    # (no telemetry session, so no input capture).
    sys.path.insert(0, str(ROOT / "scripts"))
    import staged_hooks_ab

    blocks = [parts.local_train_nodes(p)[:RUN["batch_size"]] for p in range(4)]
    split = staged_hooks_ab.hook_split(trainer.sampler_plane, blocks, parts.part_of)
    print("phase 8: the sampler hook's split, median ms (host: expansion, enqueue of "
          "upload + sort + kernel, readback, host split; device by CUDA events: upload, "
          "sort, kernel): " + json.dumps(split))
    extras["frontier_unique_batch"] = {"hook_split": split}

    # The kernels at the run's shapes, each against its plain version. The
    # path's form is the sampler's (compact): it reads the keys and
    # part_of once and writes the used ids and the counts; the reference's
    # mask form (flags from part_of) reads keys and flags and writes two
    # masks. The scoring round reads scores and marks (and weights) and
    # writes the new scores and counts.
    args, kw = unique_caps[len(unique_caps) // 2]
    keys, pdev = args[0], kw["part_of"]
    flags = pdev[keys.long()] != torch.arange(keys.shape[0], device=dev)[:, None]
    out = fu.frontier_unique_compact_cuda(keys, pdev)
    used = int(out[2].sum()) + int(out[3].sum())
    forms = {
        "compact_form": (
            lambda: fu.frontier_unique_compact_cuda(keys, pdev),
            lambda: ref.frontier_unique_compact(keys, pdev),
            keys.numel() * 4 + pdev.numel() * 4 + 4 * used + 8 * keys.shape[0]),
        "mask_form": (
            lambda: fu.frontier_unique_batch_cuda(keys, flags),
            lambda: ref.frontier_unique_batch(keys, flags),
            tensor_bytes((keys, flags), fu.frontier_unique_batch_cuda(keys, flags))),
    }
    nops = 4 * keys.numel()  # compare, and, two count adds per position
    for form, (kern, plain, nbytes) in forms.items():
        k_ms, p_ms, _, raw = time_pair(kern, plain, flush)
        b_ms, b_by = bound(nbytes, nops)
        row = call_numbers("phase 8", f"frontier_unique_batch ({form})", kern,
                           "frontier_unique_kernel")
        row["kernel_alone_cold_ms"] = staged_hooks_ab.kernel_alone(
            kern, "frontier_unique_kernel", flush=flush)
        row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bytes=nbytes)
        extras["frontier_unique_batch"][form] = row
        if form == "compact_form":
            timings["frontier_unique_batch"] = (k_ms, p_ms, None, b_ms, b_by)
        print(
            f"phase 8: frontier_unique_batch ({form}) at P={keys.shape[0]}, "
            f"M={keys.shape[1]} int32: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, plain "
            f"{raw[2]:.4f}/{raw[3]:.4f} ms; {nbytes} bytes, {nops} ops; bound {b_ms:.4f} ms "
            f"({b_by}); kernel alone cold "
            + (f"{row['kernel_alone_cold_ms']:.4f} ms" if row["kernel_alone_cold_ms"]
               else "not measured"))
    args, kw = score_caps[len(score_caps) // 2]
    score_call = lambda: su.score_policy_update_batch_cuda(*args, **kw)  # noqa: E731
    k_ms, p_ms, _, raw = time_pair(
        score_call, lambda: ref.score_policy_update_batch(*args, **kw), flush)
    outs = score_call()
    nbytes = tensor_bytes(args, outs)
    nops = 3 * args[0].numel()  # gain, add or multiply, compare per slot
    b_ms, b_by = bound(nbytes, nops)
    timings["score_policy_update_batch"] = (k_ms, p_ms, None, b_ms, b_by)
    extras["score_policy_update_batch"] = call_numbers(
        "phase 8", "score_policy_update_batch", score_call, "score_update_kernel")
    extras["score_policy_update_batch"]["kernel_alone_cold_ms"] = staged_hooks_ab.kernel_alone(
        score_call, "score_update_kernel", flush=flush)
    print(
        f"phase 8: score_policy_update_batch at P={args[0].shape[0]}, N={args[0].shape[1]} "
        f"({kw['mode']}, weights {'on' if args[2] is not None else 'off'}): kernel "
        f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms; "
        f"{nbytes} bytes, {nops} ops; bound {b_ms:.6f} ms ({b_by})"
    )
    # The three entries no trainer path launches, on their largest phase-2
    # sets: the int64 dedup, and the fixed-policy rounds on the long row.
    keys, flags = max(wide_unique.values(), key=lambda kf: kf[0].numel())
    wide_call = lambda: fu.frontier_unique_batch_wide_cuda(keys, flags)  # noqa: E731
    k_ms, p_ms, _, raw = time_pair(
        wide_call, lambda: ref.frontier_unique_batch(keys, flags), flush)
    b_ms, b_by = bound(tensor_bytes((keys, flags), wide_call()), 4 * keys.numel())
    timings["frontier_unique_batch_wide"] = (k_ms, p_ms, None, b_ms, b_by)
    extras["frontier_unique_batch_wide"] = call_numbers(
        "phase 8", "frontier_unique_batch_wide", wide_call, "frontier_unique_kernel")
    print(f"phase 8: frontier_unique_batch_wide at P={keys.shape[0]}, M={keys.shape[1]} "
          f"int64 (phase-2 set): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
          f"bound {b_ms:.6f} ms ({b_by})")
    long_row = max(score_cases, key=lambda sc: sc.scores.size)
    s_, a_ = to_device((long_row.scores, long_row.accessed), dev)
    for name, kern, plain, ins in (
        ("score_update_batch", su.score_update_batch_cuda, ref.score_update_batch,
         (s_, a_)),
        ("score_update", su.score_update_cuda, ref.score_update,
         (s_[0].contiguous(), a_[0].contiguous())),
    ):
        k_ms, p_ms, _, raw = time_pair(lambda: kern(*ins), lambda: plain(*ins), flush)
        outs = kern(*ins)
        b_ms, b_by = bound(tensor_bytes(ins, outs), 3 * ins[0].numel())
        timings[name] = (k_ms, p_ms, None, b_ms, b_by)
        extras[name] = call_numbers("phase 8", name, lambda: kern(*ins),
                                    "score_update_kernel")
        print(f"phase 8: {name} at {tuple(ins[0].shape)} (phase-2 set "
              f"{long_row.name}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
              f"bound {b_ms:.6f} ms ({b_by})")
    staged_medians = {k: float(np.median(v)) for k, v in staged_stages.items() if len(v)}
    del trainer, result, clock, unique_caps, score_caps, parts

    # -- 8b. the staged loop on the host ------------------------------------ #
    t0 = time.perf_counter()
    parts = partition_graph(g_main, 4)
    trainer = DistributedTrainer(parts, device=False, **RUN)
    clock = StageClock([])
    native.reset_launches()
    with telemetry.active(clock):
        result, warned = run_warned(trainer)
    wall = time.perf_counter() - t0
    if any(native.LAUNCHES.values()) or warned:
        raise AssertionError(f"phase 8b: launches {dict(native.LAUNCHES)}, warnings {warned}")
    diff = compare_runs("phase 8b (device=False vs phase 3)", trainer, result, *main, False)
    host_medians = {
        k: float(np.median(v)) for k, v in {
            "step": clock.ms("step"),
            "sample": clock.ms("sample"),
            "fetch.probe": clock.ms("fetch.probe"),
            "fetch.commit": clock.ms("fetch.commit"),
            "train": clock.ms("train"),
        }.items() if len(v)
    }
    print(
        f"phase 8b: device=False on phase 3's graph and run: no launch, no warning; "
        f"every stream, engine.stats and the buffer state equal phase 3's, losses "
        f"allclose (max |diff| {diff:.3g}); wall {wall:.2f} s (set-up included)"
    )
    print("phase 8 / 8b / 3, median ms per step: " + json.dumps({
        "staged_fallback": {k: round(v, 3) for k, v in staged_medians.items()},
        "staged_host": {k: round(v, 3) for k, v in host_medians.items()},
        "device_raw": {k: round(v, 3) for k, v in stages_main.items()},
    }))
    print(f"phase 8 / 8b / 3: sample {staged_medians['sample']:.3f} / "
          f"{host_medians['sample']:.3f} / {stages_main['sample_host']:.3f} ms, "
          f"fetch.commit {staged_medians['fetch.commit']:.3f} / "
          f"{host_medians['fetch.commit']:.3f} / - ms (medians per step; phase 3's "
          "sample is the raw loop's expansion, which dedups in its launch)")
    del trainer, result, clock, parts, g_main, main

    # -- 9. DeepSeek-V3's serving path at full width ------------------------ #
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import SHAPES, make_decode_step
    from repro_torch.models import model as M

    cfg = get_config(ARCH).with_overrides(num_layers=SERVE_LAYERS)
    n_dense = cfg.moe.first_k_dense
    unit = ("dense",) * n_dense + ("moe",) * (SERVE_LAYERS - n_dense)
    if M.scan_groups(cfg) != [(unit, 1)]:
        raise AssertionError(f"phase 9: scan groups {M.scan_groups(cfg)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    steps = SERVE["prompt_len"] + SERVE["gen_len"]
    n_mla = SERVE_LAYERS * steps
    n_moe = (SERVE_LAYERS - n_dense) * steps
    prefill_step = SERVE["prompt_len"] // 2
    keep = [SERVE_LAYERS * prefill_step + i for i in range(SERVE_LAYERS)]
    keep += [n_mla - SERVE_LAYERS + i for i in range(SERVE_LAYERS)]
    m = cfg.moe
    print(f"phase 9: {ARCH} at full width (d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"kv_lora {cfg.mla.kv_lora_rank}, d_ff {m.d_ff_dense}, {m.num_experts} routed "
          f"experts top-{m.experts_per_token} of width {m.d_ff_expert} + {m.num_shared_experts} "
          f"shared, vocab {cfg.vocab_size}, {cfg.dtype}), cut in depth to {SERVE_LAYERS} layers "
          f"{unit}: {n_params} parameters, {M.param_bytes(cfg)} bytes (MTP head included) from "
          f"seed {SERVE['seed']} in {time.perf_counter() - t0:.3f} s")
    capture = ServeCapture("mla_flash_decode", keep)
    native.reset_launches()
    mla_kernels = dict(md.KERNEL_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(capture):
        served = serve_mod.serve_batch(ARCH, cfg=cfg, params=params, device=DEVICE, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_serve = dict(native.LAUNCHES)
    mla_kernels = {k: v - mla_kernels[k] for k, v in md.KERNEL_LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    captured = capture.kept
    others = {k: v for k, v in launches_serve.items() if v and k != "mla_flash_decode"}
    if launches_serve["mla_flash_decode"] != n_mla or others or capture.calls != n_mla:
        raise AssertionError(f"phase 9: launches {launches_serve}, dispatcher calls "
                             f"{capture.calls}, want mla_flash_decode = {n_mla}")
    if mla_kernels != {"tensor_cores": n_mla, "cuda_cores": 0}:
        raise AssertionError(f"phase 9: MLA kernels {mla_kernels}, want all {n_mla} bf16 "
                             "launches on the tensor-core kernel")
    if len(capture.moe_inputs) != n_moe:
        raise AssertionError(f"phase 9: {len(capture.moe_inputs)} moe_forward calls, want "
                             f"{n_moe}")
    tokens = phase9_tokens = served["tokens"]
    if tokens.shape != (SERVE["requests"], SERVE["gen_len"]) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"phase 9: tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    # The experts each step's MoE layers touch (the serve run's own routed
    # inputs, routed again).
    moe_layers = [M._layers(params["groups"][0], 1)[0][f"b{i}"]["ffn"]
                  for i in range(n_dense, SERVE_LAYERS)]
    touched = np.array([
        experts_touched(cfg, moe_layers[i % len(moe_layers)]["router"], x)
        for i, x in enumerate(capture.moe_inputs)
    ]).reshape(steps, len(moe_layers))
    print(f"phase 9: serve_batch on the card: {SERVE['requests']} requests, prompt "
          f"{SERVE['prompt_len']}, {SERVE['gen_len']} generated: tokens {tokens.shape} in "
          f"[0, {cfg.vocab_size}); launches {launches_serve['mla_flash_decode']} = "
          f"{SERVE_LAYERS} x {steps} (mla_flash_decode only, all on the tensor-core "
          f"kernel: {mla_kernels}); {n_moe} moe_forward calls; wall {wall:.2f} s")
    print(f"phase 9: distinct routed experts a MoE layer touches per step (of "
          f"{m.num_experts}, at most {SERVE['requests'] * m.experts_per_token}): min "
          f"{touched.min()}, median {np.median(touched):.1f}, max {touched.max()}; per step "
          f"over both MoE layers: median {np.median(touched.sum(1)):.1f} "
          f"({expert_bytes(cfg, int(np.median(touched))) * len(moe_layers)} bytes of expert "
          f"weights read at the median, against {expert_bytes(cfg, m.num_experts) * len(moe_layers)} "
          "for every expert)")
    for i in keep:
        args, kw = captured[i]
        pos = args[4]
        max_err["mla_flash_decode"] = max(
            max_err["mla_flash_decode"],
            mla_check(md, ref, args[:4], pos, kw["scale"], MLA_TOL["bfloat16"],
                      f"phase 9 launch {i} (pos {pos})"),
        )
    print(f"phase 9: kernel == plain (allclose 3e-2) on the captured launches {keep} "
          f"(prefill step {prefill_step} and the last step, every layer); max |diff| "
          f"{max_err['mla_flash_decode']:.3g}")
    # The decode step alone on a fresh cache (the same prompts teacher-
    # forced, then greedy), each step synced; the MoE layers by CUDA events.
    prompts = serve_prompts(cfg, dev)
    clock = ServeCapture(timed=True)
    step_host, step_dev, step_moe, at_prompt = decode_alone(cfg, params, prompts, SERVE["gen_len"],
                                                      clock)
    serve_numbers("phase 9", cfg, served, step_host, step_dev, step_moe, peak_gb)
    step = make_decode_step(cfg)
    cache = M.init_cache(cfg, SERVE["requests"], steps + 1, device=dev)
    tok = prompts[:, :1]
    print("phase 9: decode step device time by kernel (torch.profiler): "
          + profile_rows(lambda: step(params, cache, tok, steps - 1), reps=2))
    pcap = ServeCapture()
    prefill_check("phase 9", cfg, params, prompts, at_prompt, pcap)
    # One MoE layer alone, at decode (the last step's input) and at prefill
    # (the prefill's input of the same layer).
    alone = {
        "decode": moe_layer_alone(cfg, moe_layers[0], capture.moe_inputs[-len(moe_layers)], flush),
        "prefill": moe_layer_alone(cfg, moe_layers[0], pcap.moe_inputs[0], flush),
    }
    for what, row in alone.items():
        print(f"phase 9: one MoE layer alone at {what} ({row['tokens']} tokens): "
              f"{row['ms']:.4f} ms (CUDA events, L2 flushed, mean of 5); {row['experts']} "
              f"experts read, {row['expert_bytes']} bytes of expert weights, HBM bound "
              f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}% of it "
              f"reached); no host read (a host read of the counts alone: "
              f"{row['count_read_ms']:.4f} ms)")
    args, kw = captured[keep[-1]]
    serve_args, serve_pos = args[:4], args[4]
    k_ms, p_ms, _, raw = time_pair(
        lambda: md.mla_flash_decode_cuda(*serve_args, serve_pos, kw["scale"]),
        lambda: ref.mla_latent_attention(*serve_args, serve_pos, kw["scale"]),
        flush,
    )
    b_ms, b_by = bound(mla_bytes(serve_args, serve_pos), mla_ops(serve_args, serve_pos),
                       BF16_TENSOR_OPS_PER_S)
    print(f"phase 9: mla_flash_decode at the serve shape (B={serve_args[0].shape[0]}, "
          f"H={serve_args[0].shape[1]}, S={serve_args[2].shape[1]}, pos={serve_pos}, bf16; "
          f"splits {md.split_plan(serve_args[0].shape[0], serve_args[0].shape[1], serve_pos + 1, sms)}): "
          f"kernel {raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms; "
          f"bound {b_ms:.5f} ms ({b_by}); kernels alone (torch.profiler): "
          + json.dumps(kernel_device_ms(
              lambda: md.mla_flash_decode_cuda(*serve_args, serve_pos, kw["scale"]),
              ("mla_tc_kernel", "mla_combine_kernel"))) + " ms")
    del params, cache, capture, captured, served, step, args, serve_args, moe_layers
    del clock, pcap, prompts, at_prompt
    torch.cuda.empty_cache()

    # -- 9b. the kernel at decode_32k --------------------------------------- #
    for line in ptxas_lines(reports.get("mla_decode", "")) or ["not built in this run"]:
        print(f"phase 9b: ptxas mla_decode: {line}")
    shape = SHAPES["decode_32k"]
    B, S = shape["batch"], shape["seq"]
    H, R, RR = cfg.num_heads, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + RR)
    # N(0, 0.3²) on the card from a seed, the queries scaled so that the
    # scores spread by scenarios.PEAKED.
    gen = torch.Generator(device=dev).manual_seed(3)
    gains = (*scenarios.mla_query_gains(R, RR, scale, scenarios.PEAKED), 1.0, 1.0)
    args = [
        (torch.randn(sh, generator=gen, device=dev) * (0.3 * g)).to(torch.bfloat16)
        for sh, g in zip(((B, H, R), (B, H, RR), (B, S, R), (B, S, RR)), gains)
    ]
    pos = S - 1
    err = mla_check(md, ref, args, pos, scale, MLA_TOL["bfloat16"], "phase 9b decode_32k",
                    MLA_REL)
    max_err["mla_flash_decode"] = max(max_err["mla_flash_decode"], err)
    q_cat = torch.cat(args[:2], dim=-1).view(B, 1, H, R + RR)
    k_cat = torch.cat(args[2:], dim=-1).view(B, 1, S, R + RR)
    v = args[2].view(B, 1, S, R)

    def sdpa():
        # One KV head, the H heads as H query rows of it (enable_gqa would
        # expand the cache H times in the math backend); no mask at S - 1.
        return torch.nn.functional.scaled_dot_product_attention(q_cat, k_cat, v, scale=scale)

    lib = sdpa().view(B, H, R)
    lib_err = (lib.float() - ref.mla_latent_attention(*args, pos, scale).float()).abs().max().item()
    del lib
    k_ms32, p_ms32, l_ms32, raw = time_pair(
        lambda: md.mla_flash_decode_cuda(*args, pos, scale),
        lambda: ref.mla_latent_attention(*args, pos, scale),
        flush, reps=5, library=sdpa,
    )
    nbytes, nops = mla_bytes(args, pos), mla_ops(args, pos)
    b_ms32, b_by32 = bound(nbytes, nops, BF16_TENSOR_OPS_PER_S)
    timings["mla_flash_decode"] = (k_ms32, p_ms32, l_ms32, b_ms32, b_by32)
    alone = kernel_device_ms(lambda: md.mla_flash_decode_cuda(*args, pos, scale),
                             ("mla_tc_kernel", "mla_combine_kernel"))
    alone_txt = ", ".join(f"{k} {v:.4f} ms" if v else f"{k} not measured"
                          for k, v in alone.items())
    print(f"phase 9b: mla_flash_decode at decode_32k (B={B}, S={S}, H={H}, r={R}, rr={RR}, "
          f"bf16, pos={pos}, scores spread {scenarios.PEAKED}; splits "
          f"{md.split_plan(B, H, pos + 1, sms)}): kernel == plain (allclose 3e-2 and max "
          f"|diff| {err:.3g} <= {MLA_REL} x max |plain|); kernel {raw[0]:.3f}/{raw[1]:.3f} ms, plain "
          f"{raw[2]:.3f}/{raw[3]:.3f} ms, scaled_dot_product_attention {l_ms32:.3f} ms "
          f"(max |diff| to plain {lib_err:.3g}); {nbytes} bytes, {nops} ops; bound "
          f"{b_ms32:.4f} ms ({b_by32}; bytes at {HBM_BYTES_PER_S / 1e12} TB/s, ops at "
          f"{BF16_TENSOR_OPS_PER_S / 1e12} TFLOP/s bf16 tensor cores)")
    share = f"{100 * b_ms32 / alone['mla_tc_kernel']:.1f}%" if alone["mla_tc_kernel"] else "not measured"
    print(f"phase 9b: kernel alone by torch.profiler: {alone_txt}; wrapper {k_ms32:.4f} ms; share "
          f"of the bound reached: wrapper {100 * b_ms32 / k_ms32:.1f}%, split kernel alone {share}")
    del args, q_cat, k_cat, v, gen
    torch.cuda.empty_cache()

    # -- 9c. card vs CPU on the six smoke configs --------------------------- #
    card_vs_cpu = {}
    for arch in ZOO:
        card_vs_cpu[arch] = zoo_card_vs_cpu(arch, dev)
    print("phase 9c: the smoke configs of " + ", ".join(ZOO) + " (float32, TF32 off) from "
          "seed 7 on both devices: greedy tokens identical, decode and prefill logits "
          "allclose 1e-4, forward vs decode on the card within 1e-3 x scale; " + json.dumps(
              {a: {k: float(f"{v:.3g}") if isinstance(v, float) else v for k, v in r.items()}
               for a, r in card_vs_cpu.items()}))

    # -- 9d. Qwen3-8B whole, on the card ----------------------------------- #
    cfg = get_config(WHOLE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    print(f"phase 9d: {WHOLE_ARCH} whole ({cfg.num_layers} layers {M.scan_groups(cfg)}, d_model "
          f"{cfg.d_model}, GQA {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim} with "
          f"qk-norm, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}): "
          f"{sum(t.numel() for t in _leaves(params))} parameters, {M.param_bytes(cfg)} bytes from "
          f"seed {SERVE['seed']} in {time.perf_counter() - t0:.3f} s")
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve_mod.serve_batch(WHOLE_ARCH, cfg=cfg, params=params, device=DEVICE, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_whole = dict(native.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = served["tokens"]
    if any(launches_whole.values()):
        raise AssertionError(f"phase 9d: native launches {launches_whole}, want none")
    if tokens.shape != (SERVE["requests"], SERVE["gen_len"]) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"phase 9d: tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    print(f"phase 9d: serve_batch on the card: tokens {tokens.shape} in [0, {cfg.vocab_size}); "
          f"no native kernel launched (GQA attention is plain PyTorch, as the reference's is "
          f"plain jnp); wall {wall:.2f} s")
    prompts = serve_prompts(cfg, dev)
    step_host, step_dev, step_moe, at_prompt = decode_alone(cfg, params, prompts, SERVE["gen_len"],
                                                      ServeCapture(timed=True))
    serve_numbers("phase 9d", cfg, served, step_host, step_dev, step_moe, peak_gb)
    whole_decode_ms = float(np.median(step_dev))
    step = make_decode_step(cfg)
    cache = M.init_cache(cfg, SERVE["requests"], steps + 1, device=dev)
    print("phase 9d: decode step device time by kernel (torch.profiler): "
          + profile_rows(lambda: step(params, cache, prompts[:, :1], steps - 1), reps=2))
    prefill_check("phase 9d", cfg, params, prompts, at_prompt, ServeCapture())
    del params, cache, served, step, prompts, at_prompt
    torch.cuda.empty_cache()

    # -- 11. the legacy runtime at full width ------------------------------ #
    t_phase = time.perf_counter()
    trainer = DistributedTrainer(parts_main, device=DEVICE, runtime="legacy", **RUN)
    steps = trainer.epochs * trainer.mb_per_epoch
    clock = StageClock(AGGREGATION_KERNELS, by_ref=[trainer.features])
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_legacy = dict(native.LAUNCHES)
    check_aggregation("phase 11", launches_legacy, trainer)
    only_kernels("phase 11", launches_legacy, AGGREGATION_KERNELS)
    same, diff = compare_legacy("phase 11 (legacy vs phase 3)", trainer, result, result_main,
                                stats_main, False)
    n_agg = check_captured("phase 11", clock, max_err)
    print(
        f"phase 11: runtime='legacy' on phase 3's graph and run (products scale={MAIN_SCALE}, "
        f"P=4, batch {RUN['batch_size']}, {steps} steps, GraphSAGE on the card): every "
        f"stream ({', '.join(STREAMS)}), epoch_times and the accuracy equal phase 3's "
        f"vectorized run, the buffers' stats sum to its engine.stats; losses "
        + ("bit-identical" if same else f"not bit-identical, allclose (rtol={LOSS_RTOL}, "
           f"atol={LOSS_ATOL}), max |diff| {diff:.3g}")
        + f"; launches {({k: v for k, v in launches_legacy.items() if v})} (P * steps + 1 "
        f"each, no prefetch-step kernel), all {n_agg} bit-exact; wall {wall:.2f} s"
    )
    in_run["phase 11"] = aggregation_in_run("phase 11", clock)
    print("phase 11 vs phase 3, median ms per step: " + json.dumps(
        {"legacy": legacy_stages(clock), "phase 3": {k: round(v, 3) for k, v in stages_main.items()}}))
    del trainer, result, clock

    # The ragged graph with the kernel-backed store, on the legacy loop.
    store = FeatureStore.for_partitions(parts_papers, device=DEVICE, use_kernel=True)
    trainer = DistributedTrainer(parts_papers, device=DEVICE, feature_store=store,
                                 runtime="legacy", **RAGGED)
    clock = StageClock(["gather_rows_batch", "gather_rows", *AGGREGATION_KERNELS])
    native.reset_launches()
    store.kernel_gathers = store.flat_gathers = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_legacy_store = dict(native.LAUNCHES)
    check_aggregation("phase 11 (store)", launches_legacy_store, trainer)
    only_kernels("phase 11 (store)", launches_legacy_store,
                 ("gather_rows_batch", "gather_rows", *AGGREGATION_KERNELS))
    check_store_launches("phase 11 (store)", launches_legacy_store, store, trainer)
    same, diff = compare_legacy("phase 11 (legacy + store vs phase 3b)", trainer, result,
                                result_papers, stats_papers, True)
    gather_caps, flat_caps = check_store_gathers("phase 11 (store)", clock, max_err)
    n_agg = check_captured("phase 11 (store)", clock, max_err)
    gather_in_run = round(float(np.median(clock.device_ms("gather_rows_batch"))), 4)
    print(
        f"phase 11: runtime='legacy' on phase 3b's graph and run (papers scale={RAGGED_SCALE}, "
        f"FeatureStore(use_kernel=True) on the card): every stream and feat_sums, "
        f"bytes_measured, bytes_modeled equal phase 3b's ({result.total_bytes_measured} bytes "
        f"measured == modeled), epoch_times equal; losses "
        + ("bit-identical" if same else f"allclose, max |diff| {diff:.3g}")
        + f"; launches {({k: v for k, v in launches_legacy_store.items() if v})}: "
        f"gather_rows_batch = the store's {store.kernel_gathers} per-home gathers (misses "
        f"and admissions after each PE loop), gather_rows = its {store.flat_gathers} flat "
        f"gathers (each PE's training rows), all {len(gather_caps)} + {len(flat_caps)} "
        f"bit-exact, and all {n_agg} segment_sum_equal; gather_rows_batch device ms per "
        f"launch (CUDA events), median {gather_in_run}; wall {wall:.2f} s"
    )
    in_run["phase 11 (store)"] = aggregation_in_run("phase 11 (store)", clock)
    print("phase 11 (store) vs phase 3b, median ms per step: " + json.dumps(
        {"legacy": legacy_stages(clock), "phase 3b": stages_papers}))
    del trainer, result, clock, store, gather_caps, flat_caps

    # Telemetry on the legacy loop: per-PE tracks, the vectorized digest.
    tr = DistributedTrainer(p1g, device=DEVICE, trace=True, telemetry=True, runtime="legacy",
                            **SMALL)
    tr.run()
    pes = sorted({sp.pe for sp in tr.last_telemetry.tracer.spans})
    if pes != [-1, 0, 1, 2, 3]:
        raise AssertionError(f"phase 11: legacy telemetry spans on PEs {pes}")
    if tr.last_trace.exact_digest() != digest_small:
        raise AssertionError("phase 11: the legacy digest differs from phase 4b's")
    print(f"phase 11: legacy run at scale={SMALL_SCALE} with telemetry: spans on PEs {pes} "
          f"(host track and one per PE), exact_digest equals phase 4b's vectorized run; "
          f"phase 11 wall {time.perf_counter() - t_phase:.1f} s")
    del tr

    # -- 12. the classifier plane ----------------------------------------- #
    from repro_torch.core import make_classifier
    from repro_torch.core.classifiers import CLASSIFIERS, GradientClassifier
    from repro_torch.gnn.train import collect_traces

    t_phase = time.perf_counter()
    trace_kw = dict(buffer_frac=RUN["buffer_frac"], batch_size=RUN["batch_size"],
                    epochs=RUN["epochs"])
    native.reset_launches()
    X, y = collect_traces(parts_main, device=DEVICE, **trace_kw)
    launches_traces = dict(native.LAUNCHES)
    X_cpu, y_cpu = collect_traces(parts_main, device="cpu", **trace_kw)
    if not (np.array_equal(X, X_cpu) and np.array_equal(y, y_cpu)):
        raise AssertionError("phase 12: collect_traces on the card != on the CPU")
    only_kernels("phase 12 (collect_traces)", launches_traces, ("fused_frontier_step",))
    fitted, decide_times = {}, {}
    for name in sorted(CLASSIFIERS):
        pair = []
        for where in (DEVICE, "cpu"):
            clf = make_classifier(name, device=where)
            if isinstance(clf, GradientClassifier):
                init = {k: v.numpy() for k, v in clf.init_params().items()}
                clf.fit(X, y, init=init)
            else:
                clf.fit(X, y)
            pair.append(clf)
        on_card, on_cpu = pair
        if isinstance(on_card, GradientClassifier):
            xs = torch.from_numpy(X)
            with torch.no_grad():
                z_card = on_card.logits(on_card.params, xs.to(dev)).cpu().numpy()
                z_cpu = on_cpu.logits(on_cpu.params, xs).numpy()
            np.testing.assert_allclose(z_card, z_cpu, rtol=1e-5, atol=1e-5,
                                       err_msg=f"phase 12: {name} logits")
        elif on_card.stumps != on_cpu.stumps:
            raise AssertionError(f"phase 12: {name} stumps differ")
        d_card = np.array([on_card.decide(x) for x in X])
        d_cpu = np.array([on_cpu.decide(x) for x in X])
        if not np.array_equal(d_card, d_cpu):
            rows = np.nonzero(d_card != d_cpu)[0]
            if isinstance(on_card, GradientClassifier):
                print(f"phase 12: {name} decisions flip on rows {rows.tolist()}: logits "
                      f"{z_card[rows].tolist()} (card) / {z_cpu[rows].tolist()} (CPU), the "
                      f"threshold's logit {math.log(on_card.threshold / (1 - on_card.threshold))}")
            raise AssertionError(f"phase 12: {name} decisions differ on rows {rows.tolist()}")
        fitted[name] = on_card
        decide_times[name] = {"card_us": round(decide_us(on_card, X), 1),
                              "cpu_us": round(decide_us(on_cpu, X), 1)}
    print(
        f"phase 12: collect_traces on phase 3's graph (fixed, batch {RUN['batch_size']}, "
        f"{RUN['epochs']} epochs, no training) on the card: X {X.shape}, y {y.shape} "
        f"({int(y.sum())} positive) equal to the CPU's; launches "
        f"{({k: v for k, v in launches_traces.items() if v})}; all {len(CLASSIFIERS)} "
        f"classifiers fitted on the card and the CPU from the same initial arrays: the "
        f"tree models identical, the gradient models' logits allclose (1e-5) on every row, "
        f"every decision identical; host us per decide call: " + json.dumps(decide_times)
    )
    runs = {}
    for runtime in ("vectorized", "legacy"):
        tr = DistributedTrainer(parts_main, device=DEVICE, runtime=runtime,
                                **dict(RUN, deciders=[fitted["mlp"]]))
        clock = StageClock(["fused_frontier_step_batch", "fused_step_readback_batch"])
        native.reset_launches()
        with telemetry.active(clock):
            run = tr.run()
        torch.cuda.synchronize()
        runs[runtime] = (tr, run, dict(native.LAUNCHES), clock)
    (tv, rv, lv, cv), (tl, rl, ll, _) = runs["vectorized"], runs["legacy"]
    launches_clf = lv
    stats_v = {f: getattr(tv.engine.stats, f) for f in STATS}
    same, diff = compare_legacy("phase 12 (mlp-driven legacy vs raw loop)", tl, rl, rv,
                                stats_v, False)
    check_aggregation("phase 12 (raw loop)", lv, tv)
    only_kernels("phase 12 (legacy)", ll, AGGREGATION_KERNELS)
    if lv["fused_frontier_step"] != tv.epochs * tv.mb_per_epoch + 1:
        raise AssertionError(f"phase 12: raw-loop launches {lv}")
    held_clf = check_prefetch_launches("phase 12", cv, max_err)
    rates = {rt: round(r.controllers[0].replacement_interval, 3) for rt, (_, r, _, _) in runs.items()}
    share = {rt: round(float(np.mean([d for log in r.logs for d in log.decisions])), 3)
             for rt, (_, r, _, _) in runs.items()}
    print(
        f"phase 12: rudder with the card-fitted mlp as every PE's decider at phase 3's "
        f"configuration, on the raw device loop and on runtime='legacy': every stream equal, "
        f"losses " + ("bit-identical" if same else f"allclose, max |diff| {diff:.3g}")
        + f"; raw-loop launches {({k: v for k, v in lv.items() if v})}, "
        f"fused_frontier_step bit-exact on all {held_clf['fused_frontier_step']}; decision "
        f"rate r (replacement interval, Table 2) {rates}, share of steps replaced {share}; "
        f"phase 12 wall {time.perf_counter() - t_phase:.1f} s"
    )
    del runs, tv, rv, tl, rl, cv, tr, run, clock, fitted, X, y, X_cpu, y_cpu

    # -- 13. the paper's presets and the sweep ----------------------------- #
    from repro_torch.configs.rudder_gnn import EXPERIMENTS
    from repro_torch.configs.rudder_gnn import build_trainer as build_preset
    from repro_torch.runtime import default_grid, run_sweep, validate_rows

    t_phase = time.perf_counter()
    preset_launches = {}
    for name in ("products_25pct_rudder", "products_massivegnn"):
        got = {}
        for where in (DEVICE, "cpu"):
            tr = build_preset(name, device=where)
            native.reset_launches()
            got[where] = (tr, tr.run(), dict(native.LAUNCHES))
        (ta, ra, la), (tb, rb, _) = got[DEVICE], got["cpu"]
        compare_runs(f"phase 13 ({name}, card vs CPU)", ta, ra, tb, rb, False)
        if ra.epoch_times != rb.epoch_times:
            raise AssertionError(f"phase 13 ({name}): epoch_times differ")
        preset_launches[name] = {k: v for k, v in la.items() if v}
    print(f"phase 13: presets products_25pct_rudder and products_massivegnn at their scale "
          f"({EXPERIMENTS['products_25pct_rudder'].scale}) on the card: every stream, "
          f"engine.stats, the buffer state and epoch_times equal the CPU's; launches "
          + json.dumps(preset_launches))
    grid = default_grid()
    clock = StageClock(["fused_frontier_step_batch", "fused_step_readback_batch"])
    native.reset_launches()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        rows = run_sweep(grid, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_sweep = dict(native.LAUNCHES)
    t0 = time.perf_counter()
    rows_cpu = run_sweep(grid, device="cpu")
    wall_cpu = time.perf_counter() - t0
    for a, b in zip(rows, rows_cpu):
        if a != b:
            raise AssertionError(f"phase 13: sweep row {a['label']} differs: {a} != {b}")
    if len(rows) != len(grid) or len(rows_cpu) != len(grid):
        raise AssertionError(f"phase 13: {len(rows)} / {len(rows_cpu)} rows for {len(grid)} cells")
    problems = validate_rows(rows)
    if problems:
        raise AssertionError(f"phase 13: validate_rows: {problems}")
    only_kernels("phase 13 (sweep)", launches_sweep, ("fused_frontier_step", "fused_step"))
    held_sweep = check_prefetch_launches("phase 13", clock, max_err)
    if held_sweep != {k: launches_sweep[k] for k in held_sweep}:
        raise AssertionError(f"phase 13: held {held_sweep} != launches {launches_sweep}")
    print(
        f"phase 13: run_sweep(default_grid()) ({len(grid)} cells, scale 0.12) on the card in "
        f"{wall:.2f} s (CPU {wall_cpu:.2f} s): rows equal the CPU's on every field, "
        f"validate_rows empty; launches {({k: v for k, v in launches_sweep.items() if v})}, "
        f"all bit-exact ({held_sweep}); phase 13 wall {time.perf_counter() - t_phase:.1f} s"
    )
    del clock, rows, rows_cpu, got, ta, ra, tb, rb, tr

    # -- 14. training at full width ---------------------------------------- #
    t_phase = time.perf_counter()
    trained = {}
    for arch, layers, batch, seq, lr in TRAIN_RUNS:
        row = train_full_width(arch, layers, batch, seq, lr, dev)
        trained[arch] = row
        print_train_row(arch, row)
    print(f"phase 14: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 14c. training card vs CPU on the six smoke configs ----------------- #
    train_vs_cpu = {arch: zoo_train_card_vs_cpu(arch, dev) for arch in ZOO}
    print("phase 14c: the smoke configs of " + ", ".join(ZOO) + f" (float32, TF32 off) from seed "
          f"7, {TRAIN_SMALL['steps']} steps of train() on both devices: losses within "
          f"{TRAIN_TOL} relative, step-1 gradients within {TRAIN_TOL} x each leaf's largest, no "
          "native launch, the card's checkpoint loaded on the CPU bit for bit; " + json.dumps(
              {a: {k: float(f"{v:.3g}") if isinstance(v, float) else v for k, v in r.items()}
               for a, r in train_vs_cpu.items()}))

    # -- 15. the SSM and hybrid models served whole ------------------------- #
    t_phase = time.perf_counter()
    ssm_launches = {}
    served_ssm = {}
    for arch in SSM_ARCHES:
        served_ssm[arch] = ssm_serve(arch, dev)
        ssm_launches[f"phase 15 ({arch})"] = served_ssm[arch]["launches"]
    print(f"phase 15: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 15b. long_500k ----------------------------------------------------- #
    t_phase = time.perf_counter()
    from repro_torch.configs import all_arch_ids
    from repro_torch.launch.steps import shape_supported

    ported = all_arch_ids()
    for arch in ported:
        for shape in SHAPES:
            ok, reason = shape_supported(get_config(arch), shape)
            want = shape != "long_500k" or arch in LONG_500K_OK
            if ok != want or (not ok and "full-attention" not in reason):
                raise AssertionError(f"phase 15b: shape_supported({arch}, {shape}) = "
                                     f"{(ok, reason)}")
    print(f"phase 15b: shape_supported on {len(ported)} configs x {len(SHAPES)} shapes: the "
          f"reference's rule (long_500k for {', '.join(LONG_500K_OK)} only)")
    long_rows = {}
    for arch in SSM_ARCHES:
        long_rows[arch] = long_context(arch, dev)
        ssm_launches[f"phase 15b ({arch})"] = long_rows[arch]["launches"]
    print(f"phase 15b: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 15c. the SSM and hybrid models trained whole ------------------------ #
    t_phase = time.perf_counter()
    for arch in SSM_ARCHES:
        cfg = get_config(arch)
        b, sq = SSM_TRAIN["batch"], SSM_TRAIN["seq"]
        pred = {r: saved_bytes(cfg, b, sq, r) for r in (False, True)}
        print(f"phase 15c ({arch}): predicted, before the run: the recurrences keep "
              f"{pred[False] / 1e9:.2f} GB for backward without remat, {pred[True] / 1e9:.2f} GB "
              f"with it, beyond {M.train_state_bytes(cfg) / 1e9:.2f} GB of parameters, "
              f"gradients and moments")
        row = train_full_width(arch, None, b, sq, SSM_TRAIN["lr"], dev, tag="phase 15c",
                               remat_steps=1, split=False)
        trained[arch] = row
        ssm_launches[f"phase 15c ({arch})"] = row["launches"]
        print_train_row(arch, row, tag="phase 15c")
        print(f"phase 15c ({arch}): peaks above the state held before: train (remat=False) "
              f"{row['peak_bytes'] / 1e9:.2f} GB, remat=False gradient "
              f"{row['no_remat_grad_peak_bytes'] / 1e9:.2f} GB, remat=True step "
              f"{row['remat_step_peak_bytes'] / 1e9:.2f} GB; predicted saved bytes "
              f"{pred[False] / 1e9:.2f} / {pred[True] / 1e9:.2f} GB (no remat / remat)")
    print(f"phase 15c: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 16. Whisper-large-v3 served whole ----------------------------------- #
    media_launches = {}
    t_phase = time.perf_counter()
    served_audio = audio_serve(dev)
    media_launches[f"phase 16 ({AUDIO_ARCH})"] = served_audio["launches"]
    print(f"phase 16: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 16b. Phi-3-vision-4.2B's prefill step whole ------------------------- #
    t_phase = time.perf_counter()
    vision_row = vision_prefill(dev)
    media_launches[f"phase 16b ({VISION_ARCH})"] = vision_row["launches"]
    print(f"phase 16b: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 16c. both trained ------------------------------------------------- #
    t_phase = time.perf_counter()
    for arch, layers, b, sq, lr in MEDIA_TRAIN:
        row = train_full_width(arch, layers, b, sq, lr, dev, tag="phase 16c")
        trained[arch] = row
        media_launches[f"phase 16c ({arch})"] = row["launches"]
        print_train_row(arch, row, tag="phase 16c")
    print(f"phase 16c: wall {time.perf_counter() - t_phase:.1f} s")

    # -- 17. expert parallelism on a mesh of one ---------------------------- #
    ep_launches = ep_phases(dev, flush, phase9_tokens)

    # -- 18. the roofline's counts and the dry-run -------------------------- #
    roofline_phases(whole_decode_ms, trained[ROOF_TRAIN["arch"]]["step_ms_median"])

    # -- 10. results ------------------------------------------------------ #
    replaces = {
        "fused_frontier_step": "src/repro/kernels/fused_step.py:698",
        "fused_step": "src/repro/kernels/fused_step.py:302",
        "gather_rows_batch": "src/repro/kernels/gather_rows.py:73",
        "gather_rows": "src/repro/kernels/gather_rows.py:37",
        "fused_frontier_step_wide": "src/repro/kernels/fused_step.py:873",
        "fused_step_wide": "src/repro/kernels/fused_step.py:445",
        "frontier_unique_batch": "src/repro/kernels/frontier_unique.py:54",
        "frontier_unique_batch_wide": "src/repro/kernels/frontier_unique.py:134",
        "score_update": "src/repro/kernels/score_update.py:52",
        "score_update_batch": "src/repro/kernels/score_update.py:92",
        "score_policy_update_batch": "src/repro/kernels/score_update.py:257",
        "gather_mean": "src/repro/kernels/gather_mean.py:41",
        "segment_sum_equal": "src/repro/kernels/segment_sum.py:41",
        "mla_flash_decode": "src/repro/kernels/mla_decode.py:91",
    }
    sources = {
        "fused_frontier_step": "src/repro_torch/kernels/csrc/fused_frontier_step.cu",
        "fused_step": "src/repro_torch/kernels/csrc/fused_step.cu",
        "gather_rows_batch": "src/repro_torch/kernels/csrc/gather_rows.cu",
        "gather_rows": "src/repro_torch/kernels/csrc/gather_rows.cu",
        "fused_frontier_step_wide": "src/repro_torch/kernels/csrc/fused_frontier_step.cu",
        "fused_step_wide": "src/repro_torch/kernels/csrc/fused_step.cu",
        "frontier_unique_batch": "src/repro_torch/kernels/csrc/frontier_unique.cu",
        "frontier_unique_batch_wide": "src/repro_torch/kernels/csrc/frontier_unique.cu",
        "score_update": "src/repro_torch/kernels/csrc/score_update.cu",
        "score_update_batch": "src/repro_torch/kernels/csrc/score_update.cu",
        "score_policy_update_batch": "src/repro_torch/kernels/csrc/score_update.cu",
        "gather_mean": "src/repro_torch/kernels/csrc/gather_mean.cu",
        "segment_sum_equal": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "mla_flash_decode": "src/repro_torch/kernels/csrc/mla_decode.cu",
    }
    launches = {
        "fused_frontier_step": (launches_raw["fused_frontier_step"], "phase 3 (raw path)"),
        "fused_step": (launches_ragged["fused_step"], "phase 3b (ragged path)"),
        "gather_rows_batch": (
            launches_ragged["gather_rows_batch"],
            "phase 3b (ragged path: the store's miss and admission pulls)",
        ),
        "gather_rows": (
            launches_ragged["gather_rows"],
            "phase 3b (ragged path: the store's flat gathers of each PE's training rows); "
            f"phase 2: {phase2['gather_rows']}",
        ),
        "fused_frontier_step_wide": (
            launches_wide["fused_frontier_step_wide"],
            "phase 6 (wide raw path); phase 7 cadence: "
            f"{launches_cadence_wide['fused_frontier_step_wide']} (wide), narrow "
            f"fused_frontier_step {launches_cadence['fused_frontier_step']}",
        ),
        "fused_step_wide": (launches_wide_ragged["fused_step_wide"], "phase 6b (wide ragged path)"),
        "frontier_unique_batch": (
            launches_staged["frontier_unique_batch"],
            "phase 8 (staged fall-back: the sampler's dedup)",
        ),
        "frontier_unique_batch_wide": (
            phase2["frontier_unique_batch_wide"],
            "phase 2 only: the sampler's keys are local int32 indices",
        ),
        "score_update": (phase2["score_update"], "phase 2 only: no trainer path calls it"),
        "score_update_batch": (
            phase2["score_update_batch"], "phase 2 only: no trainer path calls it"),
        "score_policy_update_batch": (
            launches_staged["score_policy_update_batch"],
            "phase 8 (staged fall-back: the engine's scoring round)",
        ),
        "gather_mean": (
            launches_raw["gather_mean"],
            "phase 3 (raw path: the layer-2 mean of every PE's training step, "
            "plus the accuracy pass); 0 on phase 3b (the store serves the rows)",
        ),
        "segment_sum_equal": (
            launches_raw["segment_sum_equal"],
            "phase 3 (raw path: the layer-1 mean); phase 3b (ragged + store, both "
            f"means): {launches_ragged['segment_sum_equal']}",
        ),
        "mla_flash_decode": (
            launches_serve["mla_flash_decode"],
            f"phase 9 (DeepSeek-V3 serving at full width: {SERVE_LAYERS} layers x "
            f"{SERVE['prompt_len'] + SERVE['gen_len']} steps); timed at decode_32k (phase 9b)",
        ),
    }
    # Phases 11-13: the legacy runs' launches (rows 11-13) and the prefetch
    # steps the classifier-driven run and the sweep launched (rows 1-2).
    for name in ("gather_rows_batch", *AGGREGATION_KERNELS):
        extras.setdefault(name, {})["legacy_launches"] = {
            "phase 11": launches_legacy[name], "phase 11 (store)": launches_legacy_store[name]}
    extras["gather_rows_batch"]["legacy_in_run_ms"] = gather_in_run
    for name in ("fused_frontier_step", "fused_step"):
        extras.setdefault(name, {}).update({
            "collect_traces_launches": launches_traces[name],
            "classifier_launches": launches_clf[name],
            "preset_launches": {k: v.get(name, 0) for k, v in preset_launches.items()},
            "sweep_launches": launches_sweep[name],
        })
    for name in AGGREGATION_KERNELS:  # each phase's in-run median, CUDA events
        extras[name]["in_run_ms"] = {tag: med[name] for tag, med in in_run.items()
                                     if name in med}
    for name in native.KERNELS:  # phases 14 and 15c-16c launch none
        extras.setdefault(name, {})["train_launches"] = sum(
            row["launches"].get(name, 0) for arch, row in trained.items()
            if arch not in SSM_ARCHES and arch not in (AUDIO_ARCH, VISION_ARCH))
        extras[name]["whisper_launches"] = {  # phases 16-16c (Whisper, Phi-3-vision)
            phase: sum(l.get(name, 0) for t, l in media_launches.items()
                       if t.startswith(phase + " "))
            for phase in ("phase 16", "phase 16b", "phase 16c")}
        extras[name]["ep_launches"] = {  # phases 17-17c: 17c serves through the MLA kernel
            phase: l.get(name, 0) for phase, l in ep_launches.items()}
        extras[name]["ssm_launches"] = {  # phases 15-15c launch none
            "phase 15": sum(l.get(name, 0) for t, l in ssm_launches.items()
                            if t.startswith("phase 15 ")),
            "phase 15b": sum(l.get(name, 0) for t, l in ssm_launches.items()
                             if t.startswith("phase 15b")),
            "phase 15c": sum(l.get(name, 0) for t, l in ssm_launches.items()
                             if t.startswith("phase 15c")),
        }
    kernels = []
    for name in native.KERNELS:
        k_ms, p_ms, l_ms, b_ms, b_by = timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": launches[name][0],
            "launches_from": launches[name][1],
            "max_abs_err": max_err[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": l_ms,
            **extras.get(name, {}),
        })
    print("kernels: " + ", ".join(f"{k['name']} launches={k['launches']}" for k in kernels))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
