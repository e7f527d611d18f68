#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU and ``nvcc``; exits non-zero without them.  Phases,
each printing JSON lines:

1. build   — compile every kernel from ``src/repro_torch/csrc`` (one nvcc
             per source, in parallel).
2. kernels — the launch floor (an empty kernel, plainly launched and
             launched as kernel #3 is, cold and warm); each kernel against
             its plain PyTorch version on the card at
             the serving and training paths' shapes, in bf16 and f32, with
             its time, the plain version's time, its bound and (where one
             PyTorch call computes the same function) that call's time;
             RMSNorm at the five main-path shapes (the decode round's three
             and the prefill's two) in turns against F.rms_norm, warm at the
             decode shapes beside the floor, after a clean L2 flush at the
             prefill's (2048, 1024), and batch invariant (rows alone equal
             to the same rows among 2048 or 32768); SwiGLU (#4) in both
             arithmetics (the TPU kernel's and the JAX trunk's, bitwise
             equal to the plain version) at the decode round's (8, 3072),
             the MoE expert buffers (1024, 768) and (5120, 768) (cold and
             warm beside the PDL floor), the prefill's (2048, 3072) and the
             train step's (8192, 2736), its time after the grouped
             up-product ("in place"), and its backward kernel against
             autograd of the plain version (bf16 within one ulp) beside
             the plain backward's time and that of autograd through the
             recomputed plain forward; the
             paged decode also bitwise-invariant to the physical page
             layout, with exact zeros on length-0 lanes; the dense flash
             decode (kernel #5) with exact zeros on length-0 lanes, right
             on a ragged Smax, and bitwise equal to the paged decode over a
             gather_pages view of a shuffled pool; both decode kernels
             bitwise repeatable and batch invariant (each lane alone equal
             to it among the others), timed in turns against the masked
             SDPA call (#1 over the gathered view, the gather excluded), and
             swept over the split size; the low-rank Wgrad
             bitwise repeatable, and its limit shown to catch a kernel that
             rounds x @ V1 to bf16; the flash attention's bf16 output within
             half a bf16 ulp (plus a stated slack) of the f32 function, a
             limit shown to catch P rounded to bf16; #2 and #6 timed in turns
             against their library call (kernel, call, call, kernel; three
             rounds; the median factor); #1 and #5 at the decode head shapes
             of the repo's configs (DEC_HEADS: groups of 16 and 48, head
             widths 96 and 192), each against its plain version, #5 == #1
             bitwise, both batch invariant, and #2 at head widths 96 and 192
             with its rounding row; the norm, activation and attention
             kernels also at the training path's shapes, where each
             autograd Function's gradient must equal the plain version's
             autograd gradient (a check of the wiring: the norm's and the
             attention's backwards recompute the plain version, exactly;
             the activation's is the swiglu_bwd kernel, within one bf16
             ulp).
3. serve   — full-width qwen3-0.6b (bf16, seeded weights) serves 16 seeded
             requests to completion through the port's engine on the paged
             decode round; launch counts must be exactly those the engine's
             calls imply.  In this and the next two phases the request with
             the most new tokens is then served alone and must emit the
             stream it emitted among the 16.
4. serve dense — the same requests on the default dense decode round
             (gather_pages, kernel #5, scatter_token): launch counts exact
             (kernel #5 28 per round, the paged kernel none), token streams
             identical to the paged run's, its round time, tok/s and peak
             memory.
5. serve chunk/share — the same model with chunked prefill (8 pages) and
             prefix sharing on a seeded workload of two 128-token shared
             prefixes: every request completes, prefixes are hit, chunks run,
             launch counts are exact; two requests sharing a prefix go
             through chunked prefill, a forked prefix and 16 dense decode
             steps through the kernels and through the plain versions
             (teacher-forced), held at the parity phase's bf16 limits.
6. parity  — two of the serve requests, prefill and 16 paged decode steps,
             through the kernels and through the plain versions
             (teacher-forced with the kernel path's tokens), in bf16 at full
             depth and in f32 on a 4-layer full-width copy.
7. train   — full-width, full-depth llama-350m (bf16, seeded weights, B=8,
             S=1024, rank 64, FFN recompute) takes 3 MeCeFO training steps in
             each NDB mode (off, dynamic, static, degraded) under the plan
             NDBPlan(n_dp=4, n_stages=8, failed={(1, 3)}); one line per mode
             with losses, step time, tokens/s, peak memory and launches per
             step.  Launch counts must match the ones derived from the model,
             the losses be finite, and the degraded step's peak memory lie
             below the healthy one's.
8. train parity — one step's loss and gradients through the kernels and
             through the plain versions, with the train phase's FFN
             recompute: in bf16 at full depth (dynamic, degraded) and in f32
             on a 4-layer full-width copy (all four modes).
9. trainer — the port's fault-tolerant Trainer (``launch/train.py``) on the
             train phase's cell (full-depth llama-350m, bf16, seed-0
             weights, B=8, S=1024, rank 64, FFN recompute, V1 refreshed
             every 20 steps) replays the committed golden chaos traces:
             ``golden_trace.jsonl`` (30 steps, n_dp 4, n_stages 2) in
             dynamic and in static mode, and ``golden_trace_elastic.jsonl``
             (40 steps: drops, heals, rejoins, rebalanced shares) in dynamic
             mode.  Each run's event stream must verify against the trace,
             its failover/recovery/drop/rejoin counts equal the footer's,
             its whole recovery accounting equal a replay of the same events
             through the FT controller alone for llama-350m (the footer's
             bytes follow the reduced config's parameter count, which a
             reduced-config controller replay must reproduce), every step's
             launches equal ``train_launches_per_step`` for its key's mode,
             and its losses be finite; one line per run with the step ms by
             key mode, the number of step keys, V1 refresh seconds,
             tokens/s and peak memory.  The dynamic golden replay runs a
             second time: whether its losses are bitwise equal is reported,
             not gated.  Last, a 2-layer full-width f32 run with a
             checkpoint every 2 steps is resumed by a new Trainer from its
             newest checkpoint (in a temporary directory, deleted after) and
             must reproduce the uninterrupted run's last loss at rtol 1e-5.
10. statexfer — live state transfer on the card.  (a) The port's CLI, in
             process, replays the two goldens recorded with state transfer
             at the reduced config with their own flags (``--reduced
             --mecefo dynamic --chaos elastic --statexfer``):
             ``golden_trace_statexfer.jsonl`` with ``--incidents-out`` and
             ``--obs-out`` (exit 0: events and the whole footer, 10 peer
             restores, 55782440 measured bytes; its incident log through
             ``python -m repro_torch.obs incidents --verify ... --trace ...
             --require-closed 1``; its exposition parsed; its report's
             snapshot-overhead section), and ``golden_trace_policy.jsonl``
             (exit 0: every pinned decision re-derives).  (b) The Trainer
             replays the statexfer golden at the trainer phase's cell, cut
             to XFER_CELL_LAYERS layers for the script's time limit,
             without and then with state transfer (cadence 1): events and
             counts, launches per step, measured bytes = peer restores x the
             measured state size, and every restored tree's digest (on the
             card) equal to the trainer's state at the receipt's snapshot
             step; one row each with step ms by key kind, tokens/s, peak
             device memory, peak host RSS and, with state transfer, the
             snapshot-blocked share of step time against the 5 % budget and
             the cycles, bytes, copy and transfer seconds.  (c) A Trainer with
             ``ft_policy="adaptive"``, the elastic preset and state transfer
             records 40 steps at full width on XFER_ADAPTIVE_LAYERS layers,
             and a new Trainer replays it: ``verify_replay()`` finds nothing
             (events, accounting and every decision).
11. replicas — the rest of serving: ``ReplicaSet`` with failover,
             preemption, priority admission, spikes, trace record/replay and
             int8 pages.  (a) The port's CLI functions run the three JAX
             serve goldens' headers at their reduced config on the card:
             every event with its token masked, the whole footer and every
             pinned decision equal to the committed file (the port's weights
             are its own), the overload run's incident log verified and
             reconciled; each run recorded on the card is then replayed on
             the card through ``python -m repro_torch.serve.run --replay``
             in process: exit 0, bit-exact with tokens.  (b) The full-width
             cell (CELL_*: qwen3-0.6b, 28 layers, bf16, seed-0 weights, 3
             replicas on the card, priority admission with preemption, 2
             prefills a step, prefix sharing, CELL_PAGES pages, snapshots
             at cadence 2, 32 bursty long-tail requests with two 128-token
             prefixes and three priority classes, a scripted chaos of two
             kills and a spike): every request served under chaos emits
             the stream it emits without chaos on the full page reserve, on
             the paged round and on the dense round, however each run
             admitted it (``differing_requests`` must be empty); the run
             restores by snapshot and by replay, preempts and sheds; its
             recording replays on the card.  (c) restore_bitwise: at the cell's shapes
             one request admitted alone, batched with another prompt, onto
             a forked prefix and in chunks is rebuilt by the replay path and
             by the snapshot path (an older snapshot plus its teacher-forced
             tail) in a fresh engine: the K/V rows below its length bitwise
             equal the original's (the JAX package's batch-1 re-prefill is
             reported beside, not gated, and so is whether two prompts
             sharing the 128-token prefix give its K/V rows alike); "fork
             against whole", unchunked and chunked: a prompt that forks a
             donor's 128-token prefix holds bitwise the pages and first
             token it gets admitted with no prefix registry.  (d)
             The cell with int8 pages and
             no sharing: record/replay and the chaos-vs-reference stream
             gate, peak memory, ``kv_bytes_paged`` against bf16 and the
             share of tokens equal to the bf16 run (reported).  The kernel
             launch counts are read around each cell run; the int8 walk's
             (kernels phase: against its plain version at the decode
             round's and the configs' head shapes, bitwise repeatable,
             batch invariant, length-0 lanes 0, cold, warm and bound) come
             from the int8 chaos run.
12. moe serve — ``qwen3-moe-30b-a3b`` at its published widths and full
             depth (48 layers, 128 experts top-8, bf16, seed-0 weights,
             56.9 GiB) serves the serve phases' 16 requests on the paged
             round, one request alone, and on the dense round: exact launch
             counts of #1 / #5, #2, #3 and #4, streams equal; each run's
             row beside the 17.3 ms a round of reading every expert's
             weights.  Before it, kernel rows at this slice's new shapes
             (#3 at d 2048, 6144, 18432; #4 over expert buffers; #2 at H 32
             / KV 4).  Reported: at bf16 and full depth the share of top-k
             decisions and the logits Δ between the kernel and plain
             paths, and the device time by part (``serve/profile.py``'s
             labelled attention, routing and dispatch, experts, combine).
             Gated: at f32 on a 4-layer full-width copy, logits within
             F32_PATH_TOL of the plain path and every routing decision
             equal.
13. dense serve — ``glm4-9b`` (full depth), ``granite-34b`` (gelu, MQA,
             8 layers) and ``nemotron-4-340b`` (relu2, hd 192, 2 layers) at
             full width serve 4 requests on the paged round: launch counts,
             and f32 logits against the plain path on min(4, depth) layers.
14. moe train — ``qwen3-moe-30b-a3b`` at full width on MOE_TRAIN_LAYERS
             (2, cut from 4 for phase 21's time) layers (B 4, S 1024, rank 64, FFN
             recompute, V1 refreshed once: 384 expert SVDs a layer,
             timed): per NDB mode one step's bf16 gradients through
             the kernels and the plain versions against the f32 step
             (finite, loss at 1e-3, the kernels no farther from f32 than
             1.5x the plain bf16 path; the kernels-vs-plain leaf error and
             the routing decisions that differ are reported) and its
             forward-backward peak (degraded's below off's); per mode the
             same step in f32 (weights upcast), kernels against plain
             versions with routing held equal (the plain run takes the
             kernel run's expert ids; the decisions its own top-k would
             change are reported), every leaf within
             TRAIN_PARITY_TOL["float32"]; then
             MOE_TRAIN_STEPS steps through ``make_train_step`` per mode
             (launch counts, finite losses, aux, step ms, peaks).  One
             degraded step each of ``granite-34b``, ``phi-3-vision-4.2b``
             (576 patches) and ``musicgen-medium`` at full width on 2
             layers.

15. mamba2 train — ``mamba2-2.7b`` at published widths and full depth
             (64 layers, d 2560, d_inner 5120, 80 heads of 64, d_state 128,
             chunk 256, V 50304 padded, tied, bf16, 2.70 B parameters) at
             launch/profile.py's SSM cell (B 1, S 1024, rank 64, FFN
             recompute): kernel rows first (#3 at (1024, 2560) and (1024,
             5120), #6 at in_proj's and out_proj's shapes, each against its
             plain version and in turns against its library call; the
             zero-width FFN's #4 and #6 calls launch nothing); one V1
             refresh (128 SVDs, timed) shared by every row; the
             forward-backward peak per mode (degraded's, where technique II
             recomputes whole SSM blocks, below off's: a gate); bf16
             gradients at full depth (dynamic, degraded) through the kernels
             and the plain versions, gated by the anchor to the f32 step
             (the leaf error reported); f32 gradients on SSM_PARITY_LAYERS
             layers in the four modes at TRAIN_PARITY_TOL; SSM_TRAIN_STEPS
             steps per mode through ``make_train_step`` (exact launch
             counts, finite losses, step ms, peaks); the profile of an off
             and a degraded step with the SSD scan's share.
16. mamba2 decode — phase 15's weights: SSM_PROMPT_LENS prompts
             prefilled alone, then SSM_DECODE_STEPS greedy ``forward_decode``
             steps of the four over the dense conv and SSD caches: bf16
             logits against the plain path, anchored to the f32 path (the
             serve phases' limits reported), exact launches, decode ms and
             peak; at f32 on 4 layers, prefill then decode against the full
             sequence's prefill and against the plain path
             (SSM_F32_LOGIT_REL of max |logit|).
17. hybrid — ``reduced(jamba)`` (attention every 8 layers, MoE every
             second, SSM elsewhere; capacity for every token) in f32: loss
             and every gradient leaf (SSM_F32_LEAF_TOL), kernels against
             plain, in the four modes; prefill then decode through #2 and #5; jamba's smallest
             legal depth (one 8-layer period) at published widths in bytes.
Then accumulation — phase 7's cell with ``accum`` 1, 2 and 4 and with
             ``remat="dots"`` in dynamic and degraded mode (step ms, peaks,
             launches), and at f32 on 4 layers the accumulated gradients
             against accum 1's and ``"dots"``'s against ``"none"``'s within
             1e-4 per leaf.  Phase 11's restore_bitwise rows include an MoE
             prompt forked onto a donor's prefix (reduced qwen3-moe).
18. multi-rank — the data-parallel step (``launch/mesh.py``,
             ``launch/dist.py``): (a) one NCCL rank on phase 7's cell,
             MR_STEPS steps in each mode and ``degraded`` with
             ``lowrank_sync``, replicated and FSDP, params, moments and
             metrics bitwise equal to the one-process step, every
             collective reached; (b) two gloo ranks sharing the card with
             CUDA tensors (the host-staged ``all_reduce`` route) on
             MESH_CELL_LAYERS f32 layers of llama-350m at full width under
             MESH_PLAN, B 8 (4 a rank), each
             leaf within 1e-4 of the one-process global-batch step, the
             replicas bitwise equal, ``degraded_sync``'s factored bytes
             exactly r/n of ``degraded``'s gradient bytes per low-rank
             leaf, FSDP's held bytes half plus the whole leaves; (c) the
             Trainer on those two ranks replays ``golden_trace.jsonl`` at
             the CLI's reduced config, ``REPLAY OK`` agreed by both.
19. model axis — the ``model`` mesh axis (``parallel/collectives.py:
             ModelAxis``) on gloo ranks sharing the card (CUDA tensors,
             host-staged: no measure of NCCL or of TP speed): kernel rows
             first (#2, #3, #4, #6 at the TP-local shapes, each against its
             plain version, #2 and #6 in turns against SDPA / multi_dot);
             (a) mesh (1, 2) on MA_LAYERS f32 layers of llama-350m at full
             width under MESH_PLAN, B 8, S 1024, MA_STEPS steps a run: TP
             in every NDB mode
             and ``degraded_sync``, TP + SP in dynamic and degraded, the 2-D
             ``sharding_mode="fsdp"`` in dynamic; (b) mesh (2, 2), TP +
             FSDP in dynamic and ``degraded_sync``, MA4_STEPS steps; (c)
             mesh (1, 2) on 1 f32 layer of qwen3-moe-30b-a3b at full width
             (64 experts a rank), B 2: EP under ``tp_fsdp`` in off and
             degraded, the experts' all-to-all under ``fsdp`` in off; each
             run's every leaf within 1e-4 of the one-process global-batch
             step (each rank runs the reference in turn and holds its own
             slices against it), the leaves no axis cuts bitwise equal
             across the ranks that share them, the model-cut leaves held at
             exactly 1/M, every collective tag of the run reached, TP's
             all-reduce bytes a step equal to the count from the shapes, and
             for MoE every routing decision of the EP runs under
             ``tp_fsdp`` the reference's own (unforced), while the
             all-to-all run is forced onto the reference's expert ids, its
             own top-k differing only at near-ties (MA_TIE_GAP of max
             |logit|, the count reported); (d) the Trainer on mesh
             (1, 2) replays ``golden_trace.jsonl`` at the CLI's reduced
             config, ``REPLAY OK`` agreed by both ranks; (e) the SSM mixer
             cut by its heads (``ModelAxis.ssm``): mesh (1, 2) on
             MESH_CELL_LAYERS f32 layers of mamba2-2.7b at full width, B 2,
             S 1024, in dynamic, degraded and ``degraded_sync``, and the 2-D
             ``fsdp`` mode (mixer whole) in dynamic, each leaf within 1e-4
             of the one-process step (the per-head ``A_log``, ``D`` and
             ``dt_bias`` within SSM_F32_LEAF_TOL), the B/C columns and the
             whole leaves bitwise equal on both ranks, every slice at the layout's local
             shape (``in_proj`` segmented), the cut mixer's tags reached,
             the split form of #3 launched on every rank; (f)
             ``reduced(jamba)`` in f32 at (1, 2) in dynamic, its SSM, attention,
             FFN and experts all cut, routing forced onto the reference's
             ids (near-ties only), each leaf within SSM_F32_LEAF_TOL.  The
             kernel rows add #3's split form at mamba2's cut gate_norm rows
             (SSM_TP_T of 2560 channels of 5120, and the decode's MS_B
             rows) and #6 at in_proj's local (SSM_TP_T, 2560, 5416, 64).
20. mesh serve — ``launch/steps.py``'s ``make_prefill_step`` and
             ``make_decode_step`` over a (data, model) mesh, MS_B prompts
             of MS_PROMPT tokens into caches of MS_PROMPT + MS_NEW, then MS_NEW
             decode steps: kernel rows first (#2 and #5 at the ranks' head
             shapes MS_HEADS, each against its plain version with its cold
             time, bound and SDPA call); (a) one NCCL rank at (1, 1) on
             full-width, full-depth qwen3-0.6b in bf16, greedy: ids, logits
             and every cache leaf bitwise those of ``forward_prefill`` /
             ``forward_decode`` called directly, every serve kernel
             launched; (b) gloo ranks sharing the card at (1, 2) and (2, 2)
             on the same model in f32, and at (1, 2) qwen3-moe-30b-a3b at
             full width on MS_MOE_LAYERS f32 layer (EP ``"gather"``): each
             rank builds its slices leaf by leaf from the seed and runs
             teacher-forced with the one-process run's ids; its logits and
             cache heads within MS_F32_TOL of that run's rows, vocabulary
             columns and KV heads, its own greedy ids equal but at near-ties
             (the reference's top-2 gap within MS_TIE_GAP, printed), its
             held param bytes exactly the count from the shapes, TP's
             all-reduce bytes of the prefill and of a decode step equal to
             the count from the shapes, and for MoE every routing decision
             the reference's own (near-ties within MA_TIE_GAP aside); (c)
             gloo ranks at (1, 4) on full-width, full-depth glm4-9b in
             bf16 (2 KV heads: each rank's 8 query heads share one, held
             whole), each rank's slices built leaf by leaf, its logits
             against the one-process bf16 run within 2^-3 of max |logit|
             and, on the mean, 2^-5 of mean |logit|.  (b) at (1, 2) also
             serves mamba2-2.7b at full width on MESH_CELL_LAYERS f32
             layers and ``reduced(jamba)`` in f32 with the SSM mixer cut by
             its heads: logits and cache heads (the SSD heads, the conv
             window's ``[x_m | B | C]`` channels) within SSM_F32_LOGIT_REL of
             the largest logit and cache element (phase 16's SSM scale),
             #3's split form launched on every rank.

21. pod — the production meshes' dry run and the ``pod`` mesh axis
             (``launch/{mesh,dryrun,cost,roofline}.py``): (a) phase 7's
             cell (llama-350m, B 8, S 1024, bf16) in DRY_MODES: one real
             step on the card counted by ``launch/cost.py:CostMode``
             against the dry run of the same step on the meta device:
             FLOPs, HBM bytes, launches and each kernel's booked work
             equal exactly, the dry peak within DRY_PEAK_TOL of
             ``max_memory_allocated`` from a reset before the step; the
             step's ms, its roofline ms and ``roofline_fraction`` reported;
             (b) one NCCL rank at the (1, 1, 1) pod mesh: POD_STEPS
             dynamic steps of phase 7's cell and phase 20 (a)'s prefill
             and decode, bitwise the one-process steps; four gloo ranks
             sharing the card at POD_MESH (2, 1, 2) on qwen3-0.6b at full
             width on MESH_CELL_LAYERS f32 layers, B 4, S 256: each leaf
             within 1e-4 of the one-process step, the held bytes and the
             collective bytes by kind and group (``pod`` included) equal to
             the dry run's count from the shapes at that rank; (c) the dry
             runs of DRY_CELLS (qwen3-0.6b train_4k at 16×16,
             nemotron-4-340b train_4k at 16×16, jamba-1.5-large-398b
             decode_32k at 2×16×16), one CPU-only process each, started
             after (a), the phase's last timed work, so that they run
             beside (b) alone (its gloo ranks' ``step_ms`` are taken under
             that load, and are not a measurement), and read at the end:
             each summary line and each cell's per-rank state and peak
             bytes (counts, not times).

Each of phases 12-21 frees the card first and fails with a clear message
when too little memory is free.  Then the kernels' summary line (each
kernel's ``launches`` from the main paths of phases 3, 4, 7 and 11; the
launches of phases 12-21 and the accumulation phase beside them in
``launches_by_later_path``, phases 18's, 19's and 20's per rank; phase
20's NCCL run as ``"mesh serve"``; #3's split form's ``launches`` from
phase 19 (e), summed over its two ranks), the card's name and power limit, and
the final ``{"ok": true, ...}`` line.  Any failed check
raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MeCeFOConfig, ParallelConfig, ShapeConfig, TrainConfig, get_config, reduced,
)
from repro_torch.core.lowrank import refresh_projections  # noqa: E402
from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, make_batch  # noqa: E402
from repro_torch.ft.controller import FTController  # noqa: E402
from repro_torch.ft.failures import SCENARIOS  # noqa: E402
from repro_torch.ft.injectors import chaos_preset  # noqa: E402
from repro_torch.ft.policy import verify_decisions  # noqa: E402
from repro_torch.ft.trace import load_trace, replay_engine, verify_replay  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    PTR, _build, check_launch, kernel_fn, plain_versions, recompute_grads,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ROUND_SLACK, flash_attention, flash_attention_plain, rounding_ratio,
)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    SPLIT_BLOCKS, flash_decode, flash_decode_launch, flash_decode_plain,
)
from repro_torch.kernels.lowrank_wgrad import (  # noqa: E402
    lowrank_wgrad_project, lowrank_wgrad_project_plain,
)
from repro_torch.kernels.kvquant import quantize_pages  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    paged_decode, paged_decode_launch, paged_decode_plain,
)
from repro_torch.kernels.paged_decode_q8 import paged_decode_q8, paged_decode_q8_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm, rmsnorm_apply, rmsnorm_apply_plain, rmsnorm_plain, rmsnorm_sumsq, rmsnorm_sumsq_plain,
)
from repro_torch.kernels.swiglu import (  # noqa: E402
    swiglu, swiglu_bwd, swiglu_bwd_launch, swiglu_bwd_plain, swiglu_launch, swiglu_plain,
)
from repro_torch.launch.profile import (  # noqa: E402
    BATCH as TRAIN_B, CONFIG as TRAIN_CONFIG, FLAGS as TRAIN_FLAGS, PLAN as TRAIN_PLAN,
    RANK as TRAIN_RANK, SEQ_LEN as TRAIN_S, SSM_BATCH, SSM_PLAN, profile_step, train_cell,
)
from repro_torch.launch.state import TrainState, init_state  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    accumulated_loss_and_grads, loss_and_grads, make_train_step, to_device,
)
from repro_torch.launch.train import Trainer, main as train_main  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    ExecFlags, forward_decode, forward_prefill, forward_prefill_chunk,
)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.params import count_params, init_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.optimizers import init_opt_state  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.profile import profile_serve  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.kvpool import (  # noqa: E402
    gather_pages, init_pool, page_nbytes, pages_needed, scatter_pages, scatter_prefill,
    scatter_token,
)
from repro_torch.serve.replicas import KVSnapshot  # noqa: E402
from repro_torch.serve.request import Request, RequestState, WorkloadSpec, build_workload  # noqa: E402
from repro_torch.serve.trace import ServeTraceHeader, load_serve_trace  # noqa: E402
from repro_torch.serve.sampling import greedy_token  # noqa: E402
from repro_torch.statexfer import snapshot as tsnap  # noqa: E402
from repro_torch.utils.trees import host_copy, state_nbytes, tree_flatten  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor cores; f32 FMA

# kernel vs plain version: f32 sums in other orders (a few ulps); bf16
# outputs round on either side of a bf16 boundary (one ulp = 2^-7 relative)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2 ** -7)}

WRAPPERS = {
    "rmsnorm": rmsnorm, "swiglu": swiglu, "swiglu_bwd": swiglu_bwd,
    "flash_attention": flash_attention, "paged_decode": paged_decode,
    "lowrank_wgrad": lowrank_wgrad_project, "flash_decode": flash_decode,
    "paged_decode_q8": paged_decode_q8,
    "rmsnorm_sumsq": rmsnorm_sumsq, "rmsnorm_apply": rmsnorm_apply,
}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
    "swiglu": "src/repro/kernels/swiglu.py:20",
    # the TPU kernel has no backward kernel: autodiff differentiates it
    "swiglu_bwd": "backward of src/repro/kernels/swiglu.py:20; the JAX trunk's autodiff of "
                  "src/repro/models/layers.py:330",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "paged_decode": "src/repro/kernels/paged_decode.py:51",
    "lowrank_wgrad": "src/repro/kernels/lowrank_wgrad.py:44",
    "flash_decode": "src/repro/kernels/flash_decode.py:70",
    # not Pallas: the XLA page walk, the reference's only int8 decode path
    "paged_decode_q8": "src/repro/kernels/xla_paged.py:51",
    # #3's split form, for a row cut over the model axis (the SSM gate_norm)
    "rmsnorm_sumsq": "src/repro/kernels/rmsnorm.py:22",
    "rmsnorm_apply": "src/repro/kernels/rmsnorm.py:22",
}
SERVE_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "paged_decode", "flash_decode")
TRAIN_KERNELS = ("rmsnorm", "swiglu", "swiglu_bwd", "flash_attention", "lowrank_wgrad")
# #3's split form: the SSM mixer's gate_norm where the model axis cuts it
SPLIT_NORM = ("rmsnorm_sumsq", "rmsnorm_apply")
# the source of each kernel, where it is not csrc/<name>.cu
KERNEL_SOURCES = {"swiglu_bwd": "swiglu", "rmsnorm_sumsq": "rmsnorm", "rmsnorm_apply": "rmsnorm"}

# kernel #6 against its plain version, relative to max |ref|.  Both sides
# multiply the same operands (bf16 or f32) with f32 products and sums, so
# they differ only in summation order: at most 1e-6 of max |ref| on the
# H100 in either dtype.  A kernel that rounds P = x @ V1 to bf16 lands
# near 1e-3 (the control in lowrank_rows shows this limit catches it).
LOWRANK_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}

# the training slice's cell (launch/profile.py: llama-350m, B=8, S=1024,
# rank 64, FFN recompute); the low-rank Wgrad's (T, n, m, r) for
# w_gate/w_up and w_down, and an odd one
TRAIN_MODES = ("off", "dynamic", "static", "degraded")
TRAIN_STEPS = 3
LOWRANK_SHAPES = [(8192, 1024, 2736, 64), (8192, 2736, 1024, 64), (300, 100, 260, 12)]
# train parity: one step's loss and gradients, kernels vs plain versions,
# as (max per-leaf ||Δg||/||g||, loss |Δ|/|loss|).  f32: the same arithmetic
# summed in other orders.  bf16: each layer rounds its norm, activation and
# attention outputs to bf16 where the two paths may land one ulp (2^-8
# relative) apart, and 24 layers of such differences reach every gradient
# leaf: at most 2.6 % (dynamic) and 2.5 % (degraded) on the H100, so the
# limit is 5 %; a wrong kernel moves a leaf by its whole norm.  The bf16
# check is also anchored to the f32 step (TRAIN_ANCHOR_RATIO).
TRAIN_PARITY_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-3)}
TRAIN_ANCHOR_RATIO = 1.5
# the trainer phase: the port's Trainer replays the committed golden chaos
# traces on the train cell (full-depth llama-350m, B=8, S=1024, rank 64,
# FFN recompute), V1 refreshed every TRAINER_SVD_PERIOD steps as the CLI
# does; the checkpoint round trip runs on a 2-layer full-width f32 copy
TRAINER_DATA = os.path.join(ROOT, "tests", "data")
TRAINER_RUNS = (("dynamic golden", "golden_trace.jsonl", "dynamic"),
                ("dynamic elastic", "golden_trace_elastic.jsonl", "dynamic"),
                ("static golden", "golden_trace.jsonl", "static"))
TRAINER_SVD_PERIOD = 20
TRAINER_CKPT = {"n_layers": 2, "steps": 6, "every": 2, "fail_step": 5, "rtol": 1e-5}
# the statexfer phase: the two goldens recorded with live state transfer,
# replayed through the CLI at the reduced config (every gate of the JAX
# package's acceptance run), the statexfer golden at the train cell cut to
# XFER_CELL_LAYERS layers (24 take ~45 s more of the script's 1200) without
# and with state transfer (snapshot cadence 1), and an adaptive-policy
# record/replay round trip at full width on XFER_ADAPTIVE_LAYERS layers
XFER_TRACE, XFER_POLICY_TRACE = "golden_trace_statexfer.jsonl", "golden_trace_policy.jsonl"
XFER_INCIDENTS = "golden_incidents_statexfer.jsonl"
XFER_CLI = ["--reduced", "--mecefo", "dynamic", "--chaos", "elastic", "--statexfer",
            "--device", "cuda"]
XFER_BUDGET = 0.05  # obs/report.py SNAPSHOT_BUDGET_FRAC: blocked share of step time
XFER_ADAPTIVE_LAYERS, XFER_ADAPTIVE_STEPS = 4, 40
XFER_CELL_LAYERS = 8
DIGEST_CHUNK = 1 << 24  # elements a digest moves at a time

# the serving slice's shapes (qwen3-0.6b)
B_PRE, S_PRE, H, KV, HD, D, DFF = 4, 512, 16, 8, 128, 1024, 3072
B_DEC, PS, P_DEC = 8, 16, 64
DEC_LENS = [0, 1, 15, 16, 17, 300, 777, 1024]
# kernel #5 at the dense round's shapes: the dense view is (B_DEC, P_DEC *
# PS) rows, walked in page-sized blocks; and a ragged Smax
SMAX_DEC, SMAX_RAGGED = P_DEC * PS, 1000
BLOCK_SWEEP = (16, 32, 64, 128)
# fold blocks per split of the decode kernels (SPLIT_BLOCKS is the one the
# wrappers pass)
SPLIT_SWEEP = (2, 4, 8, 16)
# RMSNorm's main-path shapes: the decode round's (B_DEC, D) sublayer and
# final norms, its (B_DEC * H, HD) q_norm and (B_DEC * KV, HD) k_norm; the
# prefill's (B_PRE * S_PRE, D) and (B_PRE * S_PRE * H, HD)
NORM_DECODE = [(B_DEC, D), (B_DEC * H, HD), (B_DEC * KV, HD)]
NORM_PREFILL = [(B_PRE * S_PRE, D), (B_PRE * S_PRE * H, HD)]
# the decode head shapes of the repo's configs, one chip's share of heads:
# (H, KV, hd) of glm4-9b and qwen3-moe (G 16), granite-34b (G 48),
# nemotron-4-340b (hd 192, G 12) and phi-3-vision (hd 96, G 1)
DEC_HEADS = [(32, 2, 128), (48, 1, 128), (24, 2, 192), (32, 32, 96)]
# prefill attention at the new head widths: phi-3-vision, nemotron's share
PRE_HEADS = [(32, 32, 96), (24, 2, 192)]
# kernel #4 (SwiGLU) at the main path's (rows, f) in bf16: the decode
# round's FFN hidden, the MoE expert buffers of a decode round and of a
# 512-token prefill (qwen3-moe: 128 experts x capacity 8 / 40, d_ff_expert
# 768), the prefill's and the train step's FFN hidden (the first three also
# warm); the backward at the train step's, the prefill's and the two expert
# buffers'.
SWIGLU_SHAPES = [(B_DEC, DFF), (128 * 8, 768), (128 * 40, 768), (B_PRE * S_PRE, DFF),
                 (TRAIN_B * TRAIN_S, 2736)]
SWIGLU_WARM = SWIGLU_SHAPES[:3]
SWIGLU_BWD_SHAPES = [(TRAIN_B * TRAIN_S, 2736), (B_PRE * S_PRE, DFF), (128 * 40, 768),
                     (128 * 8, 768)]
# #4's forward must equal its plain version bitwise: the flat walk with a
# plain launch did at every main-path shape and dtype on the card (PERF.md
# §6)
SWIGLU_BITWISE = True
# the in-place row: qwen3-moe's grouped up-product over a decode round's
# buffer (experts, capacity, d_model, d_ff_expert), then #4
SWIGLU_IN_PLACE = (128, 8, 2048, 768)
ECFG = EngineConfig(max_slots=8, page_size=16, pages_per_slot=64)
PAGED_ECFG = dataclasses.replace(ECFG, use_paged_kernel=True)
SPEC = WorkloadSpec(n_requests=16, vocab_size=151936, prompt_len=(64, 512),
                    new_tokens=(16, 64), seed=0)
# chunked prefill and prefix sharing: two 128-token system prompts
CHUNK_PAGES = 8
SHARE_ECFG = dataclasses.replace(ECFG, prefill_chunk_pages=CHUNK_PAGES, prefix_sharing=True)
SHARE_SPEC = dataclasses.replace(SPEC, shared_prefix=128, n_prefix_groups=2)
# path parity in bf16 (parity and chunk/share phases): every layer rounds
# its norm, activation and attention outputs to bf16 at places where the
# two paths can land one ulp (2^-8 relative) apart; over 28 layers such
# differences add up to a few percent of the logits' scale, while a wrong
# kernel moves them by their whole scale.  (max |Δ| / max |logit|, mean
# |Δ| / mean |logit|)
BF16_PATH_TOL = (2 ** -3, 2 ** -5)
# phase 11: the JAX serve goldens at their reduced config, and the
# full-width serving cell (3 replicas of qwen3-0.6b on one card).  The
# chaos script (kills of replica 0 at step 3 for 40 steps and of replica 1
# at step 10 for 30, a 3x spike at step 6 for 6) was chosen so that the run
# restores by snapshot and by replay, preempts and sheds: the schedule does
# not depend on token values, so a run at any width shows it.  With
# CELL_PAGES pages a replica (the full reserve is 513) holds 7 of the
# longest requests (44 pages each), so admissions contend for pages.
REPL_GOLDENS = ("golden_trace_serve.jsonl", "golden_trace_overload.jsonl",
                "golden_trace_serve_policy.jsonl")
REPL_INCIDENTS = "golden_incidents_overload.jsonl"
CELL_PAGES = 320
CELL_ENGINE = dict(max_slots=8, page_size=16, pages_per_slot=64, n_pages=CELL_PAGES,
                   admission="priority", preemption=True, max_prefills_per_step=2,
                   use_paged_kernel=True, prefix_sharing=True)
CELL_SPEC = WorkloadSpec(n_requests=32, vocab_size=151936, seed=0, mean_interarrival_steps=1.5,
                         prompt_len=(64, 512), new_tokens=(16, 64), shared_prefix=128,
                         arrival="bursty", burst_factor=5.0, burst_period=40, burst_duty=0.25,
                         length_dist="longtail", n_prefix_groups=2,
                         priority_classes=((2, 0.25, 0), (1, 0.35, 24), (0, 0.4, 0)))
CELL_CHAOS = {"kind": "scripted", "kills": [[3, 0, 40], [10, 1, 30]], "spikes": [[6, 6, 3.0]]}
CELL_SNAPSHOT_CADENCE = 2
# restore_bitwise: decode rounds before the older snapshot, and in all
RESTORE_SNAP_ROUND, RESTORE_ROUNDS = 3, 6
# phase 12: full-depth qwen3-moe-30b-a3b serves the serve phases' 16
# requests on the paged and the dense round; its logits against the plain
# path at f32 on MOE_LOGIT_LAYERS layers (every routing decision equal), and
# at bf16 at full depth (reported: a bf16 ulp in the router input can swap
# the 8th and 9th expert); the device time by part on MOE_PROFILE_REQUESTS
MOE_CONFIG = "qwen3-moe-30b-a3b"
MOE_LOGIT_LAYERS, MOE_LOGIT_STEPS = 4, 8
MOE_PROFILE_REQUESTS, MOE_PROFILE_TOKENS = 2, 4
# the kernel rows at this slice's new shapes (new_shape_rows)
NEW_ROWS, NEW_NORM_WIDTHS, NEW_SWIGLU_ROWS = 512, (2048, 6144, 18432), (128 * 8, 128 * 40)
F32_PATH_TOL = 1e-4
# phase 13: dense configs, short paged serve runs: (config, layers; 0 =
# full depth), 4 requests, prompts 64-256, 16 new tokens
DENSE_SERVE = (("glm4-9b", 0), ("granite-34b", 8), ("nemotron-4-340b", 2))
DENSE_SPEC = dict(n_requests=4, prompt_len=(64, 256), new_tokens=(16, 16), seed=0)
# phase 14: MeCeFO steps of qwen3-moe at full width on MOE_TRAIN_LAYERS
# layers in the four NDB modes, and one degraded step each of the
# non-gated and frontend configs at full width on 2 layers
# (cut from 4 layers to 2 to make room for phase 21)
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 4, 1024, 3
MOE_TRAIN_PLAN = NDBPlan(n_dp=4, n_stages=2, failed=frozenset({(1, 0)}))
CONFIG_STEPS = (("granite-34b", 2), ("phi-3-vision-4.2b", 2), ("musicgen-medium", 2))
# phase 15: mamba2-2.7b at published widths and full depth, MeCeFO steps
# in the four modes at launch/profile.py's SSM cell (B 1: B 2's healthy
# step runs out of the card's 80 GB), f32 gradient rows on
# SSM_PARITY_LAYERS layers; phase 16: SSM_PROMPT_LENS prompts prefilled,
# then SSM_DECODE_STEPS greedy decode steps.  At f32 the logits of prefill
# then decode, against the whole sequence's prefill and kernels against
# plain, are held within SSM_F32_LOGIT_REL of max |logit|: the chunked
# scan's decays exp(cum_q - cum_k) take differences of cumulative sums that
# reach thousands within a 256-token chunk (one f32 ulp ~5e-4 there), so a
# chunked prefill and the one-token recurrence, or two paths one ulp apart
# upstream, land 4.0e-4 and 9.9e-5 apart on logits up to 5.39 (4 layers,
# full width): 7.5e-5 and 1.8e-5 of the scale.  The reference's own check
# (tests/test_models.py:test_prefill_decode_matches_full) allows 2e-4 on
# the tiny config's logits
SSM_CONFIG, SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = "mamba2-2.7b", SSM_BATCH, 1024, 3
SSM_TRAIN_PLAN = SSM_PLAN
SSM_PARITY_LAYERS = 4
SSM_PROMPT_LENS, SSM_DECODE_STEPS = (64, 128, 192, 256), 16
SSM_F32_LOGIT_REL = 2e-4
# mamba2's f32 gradient rows, kernels against plain, per leaf: the SSD
# scan's decays exp(cum_q - cum_k) come from cumulative sums that reach
# thousands within a 256-token chunk, where one f32 ulp is ~5e-4, so a
# one-ulp difference upstream (#3's summation order) moves decays, and the
# per-head A_log / dt_bias / D gradients, which cancel, by ~1e-4: 1.49e-4
# (A_log, mean leaf 4.8e-5) in the off mode, where only #3 differs; the
# reduced jamba of phase 17 (S 256, chunk 32) 2.20e-4 (A_log, mean leaf
# 1.1e-4).  A wrong kernel moves a leaf by its whole norm
SSM_F32_LEAF_TOL = 1e-3
# phase 17: reduced jamba (16 layers, d 128) in f32
HYBRID_CONFIG, HYBRID_B, HYBRID_S, HYBRID_RANK = "jamba-1.5-large-398b", 4, 256, 16
# accumulation on phase 7's cell: steps per (mode, accum, remat)
ACCUM_STEPS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


class ColdTimer:
    """Median device time of one call, with the 50 MB L2 cache flushed
    before every call (CUDA events around the call alone).  A spin kernel
    between the flush and the start event keeps the stream busy while the
    host enqueues the call, so the host's time to reach its first launch
    (tens of µs for a wrapper) does not fall between the events."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's clock

    def __init__(self, dev, read_flush: bool = False):
        """``read_flush``: flush by reading the buffer instead of zeroing
        it, which leaves L2 full of clean lines rather than of dirty ones
        whose write-back to memory could fall inside the timed call."""
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev).zero_()
        self.read_flush = read_flush

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            if self.read_flush:
                self.flush.max()
            else:
                self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


class WarmTimer:
    """Median device time per call over N back-to-back calls between two
    events: the call finds its inputs in L2, as a decode round finds the
    output of the GEMM before it.  A spin kernel ahead of the start event
    covers the host's enqueue of all N calls; a reading whose enqueue took
    longer than the spin is taken again behind a spin twice as long."""

    N = 100
    SPIN_CYCLES = 8_000_000  # ~4 ms at the H100's clock

    def __call__(self, fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        cycles, times = self.SPIN_CYCLES, []
        while len(times) < reps:
            s0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            s0.record()
            torch.cuda._sleep(cycles)
            s.record()
            t0 = time.perf_counter()
            for _ in range(self.N):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            e.record()
            e.synchronize()
            if host_ms >= s0.elapsed_time(s):
                cycles *= 2
                if cycles > 64 * self.SPIN_CYCLES:
                    raise RuntimeError(f"warm timer: the host's enqueue ({host_ms} ms for "
                                       f"{self.N} calls) outlasts every spin")
                continue
            times.append(s.elapsed_time(e) / self.N)
        times.sort()
        return times[len(times) // 2]


def empty_call(dev, pdl: bool = False):
    """One launch of ``csrc/empty.cu``'s empty kernel on the current stream
    (``pdl``: with programmatic stream serialization, as kernel #3 is
    launched): the launch floor under either timer."""
    fn = kernel_fn("empty", "empty_pdl_launch" if pdl else "empty_launch", [PTR])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        check_launch("empty", fn(stream))
    return call


def turns(name, shape, timer, call_k, call_lib, rounds: int = 3, **extra) -> dict:
    """The kernel against its library call in turns (kernel, call, call,
    kernel), ``rounds`` times, each time a cold median: kernel times move
    several-fold between calls, so the factor is read inside one call."""
    times, factors = [], []
    for _ in range(rounds):
        k1, l1, l2, k2 = timer(call_k), timer(call_lib), timer(call_lib), timer(call_k)
        times.append([k1, l1, l2, k2])
        factors.append((k1 + k2) / (l1 + l2))
    row = {"phase": "kernels", "kernel": name, "dtype": "bfloat16", "shape": shape, **extra,
           "turns_ms": times, "factors": factors,
           "median_factor": sorted(factors)[len(factors) // 2]}
    emit(row)
    return row


def flash_rounding_row(q, k, v, shape) -> None:
    """Kernel #2's bf16 output against the f32 function (the plain version
    on the inputs cast to f32): every element within half a bf16 ulp plus
    ROUND_SLACK of the magnitude of its terms (``rounding_ratio`` <= 1).  The
    control, the plain version with P rounded to bf16 before PV, must fall
    outside; the row prints by how much."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    y = flash_attention_plain(q32, k32, v32)
    mag = flash_attention_plain(q32, k32, v32.abs())
    ratio = rounding_ratio(flash_attention(q, k, v), y, mag)
    control = rounding_ratio(flash_attention_plain(q, k, v, p_precision="bf16"), y, mag)
    ok = float(ratio.max()) <= 1.0
    caught = float(control.max()) > 1.0
    emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "bfloat16", "shape": shape,
          "rounding": "half bf16 ulp + slack x magnitude", "slack": ROUND_SLACK,
          "max_ratio": float(ratio.max()), "n_over": int((ratio > 1).sum()), "ok": ok,
          "control_p_in_bf16_max_ratio": float(control.max()),
          "control_n_over": int((control > 1).sum()), "n": ratio.numel(),
          "control_caught": caught})
    if not ok:
        raise AssertionError(f"flash attention {shape}: bf16 output off the f32 function by "
                             f"{float(ratio.max())} of the rounding limit")
    if not caught:
        raise AssertionError(f"flash attention {shape}: the rounding limit passes a P rounded "
                             f"to bf16 ({float(control.max())})")


def ptxas_info(log: str) -> list:
    """Per compiled kernel, from ``-Xptxas -v``: [mangled name, registers,
    spill store bytes, spill load bytes]."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = [m.group(1), None, None, None]
            out.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                                 r"spill loads", ln)):
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur[1] = int(m.group(1))
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, dtype, shape, out, ref, timer, call_k, call_p, moved, ops, call_lib=None,
            ops_dtype=None, **extra):
    """The kernel's output against its plain version's at TOL, with its cold
    time beside the plain version's, the bound and the library call's (no
    times when ``timer`` is None).  ``ops_dtype``: the type whose peak rate
    bounds the operations, when it is not the output's; ``extra``: more
    fields of the row."""
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all()) and bool(torch.isfinite(out.float()).all())
    b_ms, b_by = bound(moved, ops, ops_dtype or dtype)
    timed = timer is not None
    row = {
        "phase": "kernels", "kernel": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": shape, "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
        "ok": ok, "ms": timer(call_k) if timed else None,
        "plain_ms": timer(call_p) if timed else None,
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(call_lib) if timed and call_lib is not None else None, **extra,
    }
    emit(row)
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: max abs err {row['max_abs_err']}")
    return row


def compare_rel(name, dtype, shape, out, ref, timer, call_k, call_p, moved, ops, call_lib):
    """A row held relative to max |ref| (kernel #6's tolerance)."""
    tol = LOWRANK_TOL[dtype]
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max()) + 1e-6
    ok = err <= tol * scale and bool(torch.isfinite(out).all())
    b_ms, b_by = bound(moved, ops, dtype)
    row = {
        "phase": "kernels", "kernel": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": shape, "max_abs_err": err, "max_abs_ref": scale, "rel_tol": tol, "ok": ok,
        "ms": timer(call_k), "plain_ms": timer(call_p), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(call_lib),
    }
    emit(row)
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: max abs err {err} > {tol} * {scale}")
    return row


def lowrank_rows(dev, timer, randn) -> dict:
    """Kernel #6 at the training path's shapes and an odd one, bitwise
    repeatable; the yardstick is one torch.linalg.multi_dot call.  A control
    rounds P = x @ V1 to bf16 (the precision a tensor-core rewrite could be
    tempted to take) and must fail the same limit."""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for T, n, m, r in LOWRANK_SHAPES:
            x, dy, v1 = randn(T, n, dtype=dtype), randn(T, m, dtype=dtype), randn(n, r, dtype=dtype)
            a = lowrank_wgrad_project(x, dy, v1)
            repeat = bool(torch.equal(a, lowrank_wgrad_project(x, dy, v1)))
            ref = lowrank_wgrad_project_plain(x, dy, v1)
            row = compare_rel(
                "lowrank_wgrad", dtype, [T, n, m, r], a, ref,
                timer, lambda: lowrank_wgrad_project(x, dy, v1),
                lambda: lowrank_wgrad_project_plain(x, dy, v1),
                nbytes(x, dy, v1) + r * m * 4, 2.0 * T * r * (n + m),
                lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
            control = float((lowrank_wgrad_project_plain(x, dy, v1, p_precision="bf16")
                             - ref).abs().max())
            caught = control > LOWRANK_TOL[dtype] * row["max_abs_ref"]
            emit({"phase": "kernels", "kernel": "lowrank_wgrad", "dtype": row["dtype"],
                  "shape": [T, n, m, r], "bitwise_repeat": repeat,
                  "control_p_in_bf16_max_abs_err": control, "control_caught": caught})
            if not repeat:
                raise AssertionError(f"lowrank_wgrad {dtype} {[T, n, m, r]}: not bitwise repeatable")
            if not caught:
                raise AssertionError(f"lowrank_wgrad {dtype} {[T, n, m, r]}: the limit passes "
                                     f"a P rounded to bf16 ({control})")
            rows.setdefault(("lowrank_wgrad", dtype), row)
            if dtype == torch.bfloat16 and T >= 8192:  # the main path's shapes
                turns("lowrank_wgrad", [T, n, m, r], timer,
                      lambda: lowrank_wgrad_project(x, dy, v1),
                      lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
    return rows


def train_shape_rows(timer, randn) -> None:
    """The norm, activation and attention kernels at the training path's
    shapes (the flash kernel's head_dim 64 MHA instantiation among them),
    each held against its plain version as the serving rows are, in bf16
    and f32.  Then the wiring of each autograd Function: its output must
    carry autograd history, and its gradient equal the plain version's
    autograd gradient exactly (the norm's and the attention's backwards
    recompute the plain version, so there this checks the Function; the
    activation's, in the model path's arithmetic, is the swiglu_bwd
    kernel, bitwise autograd's on the card)."""
    import torch.nn.functional as F

    B, S, H, hd, D, FF = TRAIN_B, TRAIN_S, 16, 64, 1024, 2736
    T = B * S
    pairs = B * H * S * (S + 1) // 2  # (query, key) pairs the mask keeps
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        x, sc = randn(T, D, dtype=dtype), randn(D, dtype=dtype)
        g, u = randn(T, FF, dtype=dtype), randn(T, FF, dtype=dtype)
        q, k, v = (randn(B, S, H, hd, dtype=dtype) for _ in range(3))
        cases = {
            "rmsnorm": (rmsnorm, rmsnorm_plain, (x, sc), [T, D],
                        2 * x.numel() * es + D * es, 4.0 * x.numel(),
                        lambda: F.rms_norm(x, (D,), sc, 1e-5)),
            "swiglu": (lambda g_, u_: swiglu(g_, u_, round_silu=True),
                       lambda g_, u_: swiglu_plain(g_, u_, True), (g, u), [T, FF],
                       3 * g.numel() * es, 5.0 * g.numel(), None),
            "flash_attention": (flash_attention, flash_attention_plain, (q, k, v),
                                [B, S, H, H, hd], 4 * nbytes(q), 4.0 * hd * pairs,
                                sdpa_call(q, k, v)),
        }
        for name, (kernel, plain, inputs, shape, moved, ops, lib) in cases.items():
            a = [t.clone().requires_grad_() for t in inputs]
            b = [t.clone().requires_grad_() for t in inputs]
            ya, yb = kernel(*a), plain(*b)
            compare(name, dtype, shape, ya.detach(), yb.detach(), timer,
                    lambda: kernel(*inputs), lambda: plain(*inputs), moved, ops, lib)
            if name == "flash_attention" and dtype == torch.bfloat16:
                flash_rounding_row(q, k, v, shape)
                turns(name, shape, timer, lambda: kernel(*inputs), lib)
            go = torch.randn_like(yb)
            ga = torch.autograd.grad(ya, a, go)
            gb = torch.autograd.grad(yb, b, go)
            err = max(float((x_.float() - y_.float()).abs().max()) for x_, y_ in zip(ga, gb))
            ok = ya.grad_fn is not None and err == 0.0
            emit({"phase": "kernels", "kernel": name, "gradient": "autograd Function wiring",
                  "dtype": str(dtype).replace("torch.", ""),
                  "shapes": [list(t.shape) for t in inputs],
                  "has_grad_fn": ya.grad_fn is not None, "max_abs_grad_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"{name}: gradient through the kernel's Function is off ({err})")
            del a, b, ya, yb, ga, gb


def sdpa_call(q, k, v):
    """One PyTorch call for causal GQA attention, as a yardstick only."""
    import torch.nn.functional as F

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def sdpa_decode_call(q, k, v, lens):
    """One PyTorch call for length-masked GQA decode attention, as a
    yardstick only (a length-0 lane gives NaN there, 0 in the kernel)."""
    import torch.nn.functional as F

    mask = torch.arange(k.shape[1], device=q.device)[None, :] < lens.long()[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :],
                                                  enable_gqa=True)


def flash_decode_rows(dtype, timer, randn, qd, lens, paged_out, kp, vp, tables) -> dict:
    """Kernel #5 at the dense round's shapes (B_DEC lanes of SMAX_DEC rows,
    page-sized blocks, the paged rows' lengths); exact zeros on length-0
    lanes; a ragged Smax; bitwise equal to kernel #1 over a gather_pages
    view of the paged rows' shuffled pool.  Returns the timed row."""
    es = torch.finfo(dtype).bits // 8
    kd, vd = (randn(B_DEC, SMAX_DEC, KV, HD, dtype=dtype) for _ in range(2))
    out = flash_decode(qd, kd, vd, lens, block_k=PS)
    row = compare(
        "flash_decode", dtype, [B_DEC, SMAX_DEC, H, KV, HD, PS], out,
        flash_decode_plain(qd, kd, vd, lens), timer,
        lambda: flash_decode(qd, kd, vd, lens, block_k=PS),
        lambda: flash_decode_plain(qd, kd, vd, lens),
        # q read, o written, and the K/V rows below each lane's length
        2 * nbytes(qd) + 2 * sum(DEC_LENS) * KV * HD * es + nbytes(lens),
        4.0 * H * HD * sum(DEC_LENS), sdpa_decode_call(qd, kd, vd, lens))
    zero_lanes = lens == 0
    zeros = bool(torch.equal(out[zero_lanes], torch.zeros_like(out[zero_lanes])))
    # a ragged Smax: the last block holds SMAX_RAGGED % PS rows
    kr, vr = kd[:, :SMAX_RAGGED].contiguous(), vd[:, :SMAX_RAGGED].contiguous()
    lens_r = lens.clamp(max=SMAX_RAGGED)
    ref_r = flash_decode_plain(qd, kr, vr, lens_r).float()
    err_r = (flash_decode(qd, kr, vr, lens_r, block_k=PS).float() - ref_r).abs()
    atol, rtol = TOL[dtype]
    ragged_ok = bool((err_r <= atol + rtol * ref_r.abs()).all())
    view = gather_pages(({"k": kp[None], "v": vp[None]},), tables, page_size=PS)[0]
    bitwise = bool(torch.equal(flash_decode(qd, view["k"][0], view["v"][0], lens, block_k=PS),
                               paged_out))
    emit({"phase": "kernels", "kernel": "flash_decode", "dtype": row["dtype"],
          "null_lanes_exact_zero": zeros, "ragged_smax": SMAX_RAGGED,
          "ragged_max_abs_err": float(err_r.max()), "ragged_ok": ragged_ok,
          "bitwise_equal_paged_decode_over_gather_pages_view": bitwise})
    if not (zeros and ragged_ok and bitwise):
        raise AssertionError(f"flash decode {dtype}: null lanes {zeros}, ragged Smax "
                             f"{ragged_ok}, bitwise vs paged {bitwise}")
    repeat_and_batch_rows("flash_decode", dtype, out,
                          lambda sl: flash_decode(qd[sl], kd[sl], vd[sl], lens[sl], block_k=PS))
    if dtype == torch.bfloat16:  # the block size the dense round does not fix
        emit({"phase": "kernels", "kernel": "flash_decode", "dtype": row["dtype"],
              "block_k_sweep_ms": {bk: timer(lambda bk=bk: flash_decode(qd, kd, vd, lens,
                                                                        block_k=bk))
                                   for bk in BLOCK_SWEEP}})
        decode_speed_rows(timer, qd, lens, kd, vd, kp, vp, tables, view)
    return row


def repeat_and_batch_rows(name, dtype, out, call_lanes, **extra) -> None:
    """A decode kernel bitwise repeatable over all DEC_LENS lanes, and batch
    invariant: each lane decoded alone (``call_lanes(slice(b, b + 1))``)
    gives bitwise what it gives among the other lanes."""
    repeat = bool(torch.equal(call_lanes(slice(None)), out))
    alone = [bool(torch.equal(call_lanes(slice(b, b + 1)), out[b:b + 1]))
             for b in range(len(DEC_LENS))]
    emit({"phase": "kernels", "kernel": name, "dtype": str(dtype).replace("torch.", ""),
          **extra, "lens": DEC_LENS, "bitwise_repeat": repeat, "batch_invariant": all(alone),
          "lane_alone_equal": alone})
    if not (repeat and all(alone)):
        raise AssertionError(f"{name} {dtype}: bitwise repeat {repeat}, lanes alone equal {alone}")


def decode_speed_rows(timer, qd, lens, kd, vd, kp, vp, tables, view) -> None:
    """bf16 decode kernels against the masked SDPA call in turns (#5 over its
    dense cache; #1 against the call over the gathered view, a yardstick for
    the same attention function that leaves the gather out), then both
    swept over the split size: each split right against the plain version
    and #5 over the view bitwise equal to #1 at it; times are cold medians,
    the sweep taken up and then down."""
    turns("flash_decode", [B_DEC, SMAX_DEC, H, KV, HD, PS], timer,
          lambda: flash_decode(qd, kd, vd, lens, block_k=PS), sdpa_decode_call(qd, kd, vd, lens))
    turns("paged_decode", [B_DEC, H, KV, HD, PS, P_DEC], timer,
          lambda: paged_decode(qd, kp, vp, tables, lens),
          sdpa_decode_call(qd, view["k"][0], view["v"][0], lens),
          yardstick="masked SDPA over the gathered dense view, gather excluded")
    atol, rtol = TOL[torch.bfloat16]
    refs = {"flash_decode": flash_decode_plain(qd, kd, vd, lens).float(),
            "paged_decode": paged_decode_plain(qd, kp, vp, tables, lens).float()}
    calls = {}
    for sb in SPLIT_SWEEP:
        calls[("flash_decode", sb)] = (lambda sb=sb: flash_decode_launch(
            qd, kd, vd, lens, block_k=PS, split_blocks=sb))
        calls[("paged_decode", sb)] = (lambda sb=sb: paged_decode_launch(
            qd, kp, vp, tables, lens, split_blocks=sb))
        outs = {n: calls[(n, sb)]() for n in refs}
        same = bool(torch.equal(flash_decode_launch(qd, view["k"][0], view["v"][0], lens,
                                                    block_k=PS, split_blocks=sb),
                                outs["paged_decode"]))
        errs = {n: (outs[n].float() - ref).abs() for n, ref in refs.items()}
        if not (same and all(bool((e <= atol + rtol * refs[n].abs()).all())
                             for n, e in errs.items())):
            raise AssertionError(f"split sweep {sb}: max errors "
                                 f"{ {n: float(e.max()) for n, e in errs.items()} }, "
                                 f"#5 == #1 bitwise {same}")
    up = {key: timer(call) for key, call in calls.items()}
    down = {key: timer(call) for key, call in reversed(list(calls.items()))}
    emit({"phase": "kernels", "kernel": "flash_decode+paged_decode", "dtype": "bfloat16",
          "split_blocks": SPLIT_BLOCKS, "split_sweep_ms": {
              n: {sb: [up[(n, sb)], down[(n, sb)]] for sb in SPLIT_SWEEP}
              for n in ("flash_decode", "paged_decode")}})


def launch_floor_row(dev, timer, warm) -> dict:
    """The empty kernels' times under both timers: the least any launch can
    read here, plainly launched and launched as kernel #3 is (``pdl_``)."""
    plain, pdl = empty_call(dev), empty_call(dev, pdl=True)
    row = {"phase": "kernels", "kernel": "empty (launch floor)",
           "source": "src/repro_torch/csrc/empty.cu", "cold_ms": timer(plain), "warm_ms": warm(plain),
           "pdl_cold_ms": timer(pdl), "pdl_warm_ms": warm(pdl)}
    emit(row)
    return row


def warm_row(name, shape, row, floor, warm, call_k, call_lib=None, pdl=False, **extra) -> None:
    """A decode-shape kernel warm (WarmTimer) beside its cold time, the
    library call's and the launch floor's (the floor of a launch like the
    kernel's: ``pdl`` for #3 and #4); each time over the floor's."""
    k_warm = warm(call_k)
    lib_warm = warm(call_lib) if call_lib is not None else None
    key = "pdl_" if pdl else ""
    emit({"phase": "kernels", "kernel": name, "dtype": "bfloat16", "shape": shape,
          "ms": row["ms"], "warm_ms": k_warm, "library_ms": row["library_ms"],
          "library_warm_ms": lib_warm, "bound_ms": row["bound_ms"],
          "floor_launch": "programmatic dependent" if pdl else "plain",
          "floor_cold_ms": floor[key + "cold_ms"], "floor_warm_ms": floor[key + "warm_ms"],
          "cold_over_floor": row["ms"] / floor[key + "cold_ms"],
          "warm_over_floor": k_warm / floor[key + "warm_ms"],
          "warm_over_plain_floor": k_warm / floor["warm_ms"],
          "bound_share_warm": row["bound_ms"] / k_warm, **extra})


def bf16_ulps(a, b) -> float:
    """The largest |a - b| in bf16 ulps of b (8 significant bits)."""
    ref = b.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return float(((a.float() - b.float()).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7))
                 .max())


def swiglu_rows(timer, warm, floor, randn) -> dict:
    """Kernel #4 (``csrc/swiglu.cu``).  The forward in both arithmetics at
    SWIGLU_SHAPES in bf16 and at the prefill's shape in f32, against its
    plain version (bitwise where SWIGLU_BITWISE, else TOL with the count of
    elements apart), cold, and warm beside the PDL floor at SWIGLU_WARM;
    the in-place row; the backward kernel against autograd of the plain
    version (TOL, bf16 within one ulp) at SWIGLU_BWD_SHAPES and the train
    step's in f32, the main path's arithmetic timed beside the plain
    backward and the recompute path (``recompute_grads`` of the plain
    forward, the Function's backward before the kernel).
    Returns the final line's rows: the forward's at the prefill's shape
    and the backward's at the train step's, in the trunk's arithmetic."""
    bf, rows = torch.bfloat16, {}
    for dtype, shapes in ((bf, SWIGLU_SHAPES), (torch.float32, [(B_PRE * S_PRE, DFF)])):
        es = torch.finfo(dtype).bits // 8
        for shape in shapes:
            g, u = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            for rs in (False, True):
                out, ref = swiglu(g, u, round_silu=rs), swiglu_plain(g, u, rs)
                apart = int((out != ref).sum())
                r = compare("swiglu", dtype, list(shape), out, ref, timer,
                            lambda: swiglu(g, u, round_silu=rs), lambda: swiglu_plain(g, u, rs),
                            3 * g.numel() * es, 5.0 * g.numel(), ops_dtype=torch.float32,
                            round_silu=rs, n_apart_from_plain=apart,
                            gate="bitwise" if SWIGLU_BITWISE else "TOL")
                if SWIGLU_BITWISE and apart:
                    raise AssertionError(f"swiglu {dtype} {shape} round_silu={rs}: {apart} "
                                         "elements apart from the plain version")
                if dtype == bf and shape in SWIGLU_WARM:
                    warm_row("swiglu", list(shape), r, floor, warm,
                             lambda: swiglu(g, u, round_silu=rs), pdl=True, round_silu=rs)
                if shape == (B_PRE * S_PRE, DFF) and rs:
                    rows[("swiglu", dtype)] = r
    # in place: after the grouped up-product, as the MoE decode round runs it
    E, C, dm, f = SWIGLU_IN_PLACE
    x, w, u = randn(E, C, dm, dtype=bf), randn(E, dm, f, dtype=bf), randn(E, C, f, dtype=bf)
    turn = []
    for _ in range(2):
        both = warm(lambda: swiglu(torch.bmm(x, w), u, round_silu=True))
        alone = warm(lambda: torch.bmm(x, w))
        turn.append([both, alone, both - alone])
    emit({"phase": "kernels", "kernel": "swiglu", "dtype": "bfloat16", "run": "in place",
          "product": f"bmm ({E}, {C}, {dm}) x ({E}, {dm}, {f})", "shape": [E * C, f],
          "turns_ms": turn, "note": "[product then #4, product alone, difference], warm",
          "in_place_ms": min(t_[2] for t_ in turn)})
    del x, w, u
    # the backward
    for shape, dtype in [(s_, bf) for s_ in SWIGLU_BWD_SHAPES] + [
            (SWIGLU_BWD_SHAPES[0], torch.float32)]:
        es = torch.finfo(dtype).bits // 8
        g, u, dy = (randn(*shape, dtype=dtype) for _ in range(3))
        for rs in (False, True):
            a = [g.clone().requires_grad_(), u.clone().requires_grad_()]
            want = torch.autograd.grad(swiglu_plain(*a, rs), a, dy)
            got = swiglu_bwd_launch(g, u, dy, round_silu=rs)
            plain = swiglu_bwd_plain(g, u, dy, rs)
            ulps = max(bf16_ulps(x_, y_) for x_, y_ in zip(got, want)) if dtype == bf else None
            timed = timer if rs else None
            recompute = (timer(lambda: recompute_grads(swiglu_plain, (g, u), (True, True), dy))
                    if rs else None)
            r = compare("swiglu_bwd", dtype, list(shape), torch.stack(got), torch.stack(want),
                        timed, lambda: swiglu_bwd_launch(g, u, dy, round_silu=rs),
                        lambda: swiglu_bwd_plain(g, u, dy, rs), 5 * g.numel() * es,
                        20.0 * g.numel(), ops_dtype=torch.float32, round_silu=rs,
                        against="autograd of swiglu_plain",
                        n_apart=sum(int((x_ != y_).sum()) for x_, y_ in zip(got, want)),
                        max_bf16_ulps=ulps,
                        plain_n_apart=sum(int((x_ != y_).sum()) for x_, y_ in zip(plain, want)),
                        recompute_path_ms=recompute)
            if ulps is not None and ulps > 1:
                raise AssertionError(f"swiglu_bwd {shape} round_silu={rs}: {ulps} bf16 ulps "
                                     "from autograd of the plain version")
            if shape == SWIGLU_BWD_SHAPES[0] and dtype == bf and rs:
                rows[("swiglu_bwd", bf)] = r
            del a, want, got, plain
        del g, u, dy
    return rows


def clean_flush_row(dev, floor, randn) -> None:
    """Kernel #3 at (B_PRE * S_PRE, D) and the empty kernel timed cold after
    an L2 flush that reads (clean lines) beside the default one that writes
    (dirty lines): how much of the cold time is the flush's write-back."""
    timer = ColdTimer(dev, read_flush=True)
    x, s = randn(B_PRE * S_PRE, D, dtype=torch.bfloat16), randn(D, dtype=torch.bfloat16)
    emit({"phase": "kernels", "kernel": "rmsnorm", "dtype": "bfloat16", "shape": [B_PRE * S_PRE, D],
          "flush": "read (clean L2)", "ms": timer(lambda: rmsnorm(x, s, 1e-5)),
          "floor_cold_ms": timer(empty_call(dev, pdl=True)),
          "write_flush_floor_cold_ms": floor["pdl_cold_ms"]})


def norm_batch_rows(randn) -> None:
    """Kernel #3 batch invariant: rows 0..B_DEC-1 of a prefill-shaped input
    are bitwise what the same rows give alone, at d = D and d = HD (the
    engine's determinism contract needs a row's norm independent of the
    rows around it)."""
    for rows_, d in NORM_PREFILL:
        x, s = randn(rows_, d, dtype=torch.bfloat16), randn(d, dtype=torch.bfloat16)
        same = bool(torch.equal(rmsnorm(x, s, 1e-5)[:B_DEC],
                                rmsnorm(x[:B_DEC].contiguous(), s, 1e-5)))
        emit({"phase": "kernels", "kernel": "rmsnorm", "dtype": "bfloat16",
              "shape": [rows_, d], "rows_alone": [B_DEC, d], "batch_invariant": same})
        if not same:
            raise AssertionError(f"rmsnorm ({rows_}, {d}): rows 0..{B_DEC - 1} differ from "
                                 f"the same rows alone")


def head_shape_rows(dtype, timer, randn, gen) -> None:
    """#1 and #5 at the configs' decode head shapes (DEC_HEADS) and #2 at the
    new head widths (PRE_HEADS), each against its plain version; #5 over
    the gathered view bitwise equal to #1, both bitwise repeatable and
    batch invariant.  ``timer`` (bf16) times each shape once."""
    dev = gen.device
    es = torch.finfo(dtype).bits // 8
    dname = str(dtype).replace("torch.", "")
    lens = torch.tensor(DEC_LENS, dtype=torch.int32, device=dev)
    n_pages = 1 + B_DEC * P_DEC
    covered = sum(pages_needed(n, PS) * PS for n in DEC_LENS)
    for h, kv, hd in DEC_HEADS:
        qd = randn(B_DEC, 1, h, hd, dtype=dtype)
        kp, vp = (randn(n_pages, PS, kv, hd, dtype=dtype) for _ in range(2))
        tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).reshape(
            B_DEC, P_DEC).to(torch.int32)
        out = paged_decode(qd, kp, vp, tables, lens)
        compare("paged_decode", dtype, [B_DEC, h, kv, hd, PS, P_DEC], out,
                paged_decode_plain(qd, kp, vp, tables, lens), timer,
                lambda: paged_decode(qd, kp, vp, tables, lens),
                lambda: paged_decode_plain(qd, kp, vp, tables, lens),
                2 * nbytes(qd) + 2 * covered * kv * hd * es + nbytes(tables, lens),
                4.0 * h * hd * sum(DEC_LENS))
        repeat_and_batch_rows("paged_decode", dtype, out,
                              lambda sl: paged_decode(qd[sl], kp, vp, tables[sl], lens[sl]),
                              heads=[h, kv, hd])
        view = gather_pages(({"k": kp[None], "v": vp[None]},), tables, page_size=PS)[0]
        kd, vd = view["k"][0], view["v"][0]
        dense = flash_decode(qd, kd, vd, lens, block_k=PS)
        compare("flash_decode", dtype, [B_DEC, SMAX_DEC, h, kv, hd, PS], dense,
                flash_decode_plain(qd, kd, vd, lens), timer,
                lambda: flash_decode(qd, kd, vd, lens, block_k=PS),
                lambda: flash_decode_plain(qd, kd, vd, lens),
                2 * nbytes(qd) + 2 * sum(DEC_LENS) * kv * hd * es + nbytes(lens),
                4.0 * h * hd * sum(DEC_LENS), sdpa_decode_call(qd, kd, vd, lens))
        bitwise = bool(torch.equal(dense, out))
        emit({"phase": "kernels", "kernel": "flash_decode", "dtype": dname,
              "heads": [h, kv, hd], "bitwise_equal_paged_decode_over_gather_pages_view": bitwise})
        if not bitwise:
            raise AssertionError(f"flash decode {dtype} heads {(h, kv, hd)}: not bitwise equal "
                                 f"to the paged decode over the gathered view")
        repeat_and_batch_rows("flash_decode", dtype, dense,
                              lambda sl: flash_decode(qd[sl], kd[sl], vd[sl], lens[sl],
                                                      block_k=PS),
                              heads=[h, kv, hd])
        del qd, kp, vp, kd, vd, view
    for h, kv, hd in PRE_HEADS:
        q = randn(B_PRE, S_PRE, h, hd, dtype=dtype)
        k, v = (randn(B_PRE, S_PRE, kv, hd, dtype=dtype) for _ in range(2))
        pairs = B_PRE * h * S_PRE * (S_PRE + 1) // 2
        compare("flash_attention", dtype, [B_PRE, S_PRE, h, kv, hd], flash_attention(q, k, v),
                flash_attention_plain(q, k, v), timer, lambda: flash_attention(q, k, v),
                lambda: flash_attention_plain(q, k, v), 2 * nbytes(q) + 2 * nbytes(k),
                4.0 * hd * pairs, sdpa_call(q, k, v))
        if dtype == torch.bfloat16:
            flash_rounding_row(q, k, v, [B_PRE, S_PRE, h, kv, hd])


def kernel_phase(dev, timer) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    warm = WarmTimer()
    floor = launch_floor_row(dev, timer, warm)
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        # rmsnorm: the prefill's (B*S, d) sublayer norms and (B*S*H, hd) q/k
        # norms; in bf16 also the decode round's shapes, warm and in turns
        shapes = NORM_PREFILL + (NORM_DECODE if dtype == torch.bfloat16 else [])
        for rows_, d in shapes:
            x, s = randn(rows_, d, dtype=dtype), randn(d, dtype=dtype)
            lib = (lambda x=x, s=s, d=d: F.rms_norm(x, (d,), s, 1e-5))
            r = compare("rmsnorm", dtype, [rows_, d], rmsnorm(x, s, 1e-5),
                        rmsnorm_plain(x, s, 1e-5), timer,
                        lambda: rmsnorm(x, s, 1e-5), lambda: rmsnorm_plain(x, s, 1e-5),
                        2 * x.numel() * es + d * es, 4.0 * x.numel(), lib)
            rows.setdefault(("rmsnorm", dtype), r)
            if dtype == torch.bfloat16:
                turns("rmsnorm", [rows_, d], timer, lambda: rmsnorm(x, s, 1e-5), lib)
                if (rows_, d) in NORM_DECODE:
                    warm_row("rmsnorm", [rows_, d], r, floor, warm,
                             lambda: rmsnorm(x, s, 1e-5), lib, pdl=True)
        if dtype == torch.bfloat16:
            clean_flush_row(dev, floor, randn)
            norm_batch_rows(randn)
            rows.update(swiglu_rows(timer, warm, floor, randn))
        # causal GQA prefill attention
        q = randn(B_PRE, S_PRE, H, HD, dtype=dtype)
        k, v = randn(B_PRE, S_PRE, KV, HD, dtype=dtype), randn(B_PRE, S_PRE, KV, HD, dtype=dtype)
        pairs = B_PRE * H * S_PRE * (S_PRE + 1) // 2  # (query, key) pairs the mask keeps
        rows[("flash_attention", dtype)] = compare(
            "flash_attention", dtype, [B_PRE, S_PRE, H, KV, HD],
            flash_attention(q, k, v), flash_attention_plain(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
            2 * nbytes(q) + 2 * nbytes(k), 4.0 * HD * pairs, sdpa_call(q, k, v))
        if dtype == torch.bfloat16:
            flash_rounding_row(q, k, v, [B_PRE, S_PRE, H, KV, HD])
            turns("flash_attention", [B_PRE, S_PRE, H, KV, HD], timer,
                  lambda: flash_attention(q, k, v), sdpa_call(q, k, v))
        head_shape_rows(dtype, timer if dtype == torch.bfloat16 else None, randn, gen)
        # paged decode over a shuffled pool, ragged lengths including 0
        n_pages = 1 + B_DEC * P_DEC
        qd = randn(B_DEC, 1, H, HD, dtype=dtype)
        kp, vp = randn(n_pages, PS, KV, HD, dtype=dtype), randn(n_pages, PS, KV, HD, dtype=dtype)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        tables = perm.reshape(B_DEC, P_DEC).to(torch.int32)
        lens = torch.tensor(DEC_LENS, dtype=torch.int32, device=dev)
        covered = sum(pages_needed(n, PS) * PS for n in DEC_LENS)  # KV rows the walk reads
        out = paged_decode(qd, kp, vp, tables, lens)
        rows[("paged_decode", dtype)] = compare(
            "paged_decode", dtype, [B_DEC, H, KV, HD, PS, P_DEC], out,
            paged_decode_plain(qd, kp, vp, tables, lens), timer,
            lambda: paged_decode(qd, kp, vp, tables, lens),
            lambda: paged_decode_plain(qd, kp, vp, tables, lens),
            2 * nbytes(qd) + 2 * covered * KV * HD * es + nbytes(tables, lens),
            4.0 * H * HD * sum(DEC_LENS))
        # the same logical KV in another physical layout: bitwise equal
        move = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1  # page p -> move[p-1]
        kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
        kp2[move], vp2[move] = kp[1:], vp[1:]
        kp2[0], vp2[0] = kp[0], vp[0]
        tables2 = move[(tables - 1).long()].to(torch.int32)
        out2 = paged_decode(qd, kp2, vp2, tables2, lens)
        zero_lanes = [i for i, n in enumerate(DEC_LENS) if n == 0]
        invariant = bool(torch.equal(out, out2))
        zeros = bool(torch.equal(out[zero_lanes], torch.zeros_like(out[zero_lanes])))
        emit({"phase": "kernels", "kernel": "paged_decode", "dtype": str(dtype).replace("torch.", ""),
              "layout_bitwise_invariant": invariant, "null_lanes_exact_zero": zeros})
        if not (invariant and zeros):
            raise AssertionError("paged decode: layout invariance or null lanes failed")
        repeat_and_batch_rows("paged_decode", dtype, out,
                              lambda sl: paged_decode(qd[sl], kp, vp, tables[sl], lens[sl]))
        rows[("flash_decode", dtype)] = flash_decode_rows(dtype, timer, randn, qd, lens, out,
                                                          kp, vp, tables)
        rows[("paged_decode_q8", dtype)] = q8_rows(dtype, timer, warm, floor, randn, gen)
    rows.update(lowrank_rows(dev, timer, randn))
    train_shape_rows(timer, randn)
    torch.cuda.synchronize()
    return rows


def q8_rows(dtype, timer, warm, floor, randn, gen) -> dict:
    """The int8 page walk against its plain version at the decode round's
    shapes (B_DEC lanes of DEC_LENS over a shuffled int8 pool, pages
    quantized by ``kvquant.quantize_pages``) and at the configs' decode
    heads (DEC_HEADS): cold time, plain time and bound; bitwise repeatable
    and batch invariant; length-0 lanes exactly 0; in bf16 also warm beside
    the launch floor.  The walk widens int8 to f32 and does its arithmetic
    in f32 FMAs, so its operations are bounded at the f32 peak."""
    dev = gen.device
    dname = str(dtype).replace("torch.", "")
    lens = torch.tensor(DEC_LENS, dtype=torch.int32, device=dev)
    n_pages = 1 + B_DEC * P_DEC
    covered_pages = sum(pages_needed(n, PS) for n in DEC_LENS)
    main = None
    for h, kv, hd in [(H, KV, HD)] + DEC_HEADS:
        qd = randn(B_DEC, 1, h, hd, dtype=dtype)
        kq, ks = quantize_pages(randn(n_pages, PS, kv, hd, dtype=torch.float32))
        vq, vs = quantize_pages(randn(n_pages, PS, kv, hd, dtype=torch.float32))
        tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).reshape(
            B_DEC, P_DEC).to(torch.int32)
        shape = [B_DEC, h, kv, hd, PS, P_DEC]

        def call(sl=slice(None)):
            return paged_decode_q8(qd[sl], kq, vq, tables[sl], lens[sl], k_scale=ks, v_scale=vs)

        out = call()
        row = compare("paged_decode_q8", dtype, shape, out,
                      paged_decode_q8_plain(qd, kq, vq, ks, vs, tables, lens), timer, call,
                      lambda: paged_decode_q8_plain(qd, kq, vq, ks, vs, tables, lens),
                      2 * nbytes(qd) + 2 * covered_pages * PS * kv * hd + 8 * covered_pages
                      + nbytes(tables, lens), 4.0 * h * hd * sum(DEC_LENS),
                      ops_dtype=torch.float32)
        zero_lanes = [i for i, n in enumerate(DEC_LENS) if n == 0]
        zeros = bool(torch.equal(out[zero_lanes], torch.zeros_like(out[zero_lanes])))
        emit({"phase": "kernels", "kernel": "paged_decode_q8", "dtype": dname, "heads": [h, kv, hd],
              "null_lanes_exact_zero": zeros})
        if not zeros:
            raise AssertionError(f"int8 walk {dtype} heads {(h, kv, hd)}: length-0 lanes not 0")
        repeat_and_batch_rows("paged_decode_q8", dtype, out, call, heads=[h, kv, hd])
        if main is None:
            main = row
            if dtype == torch.bfloat16 and timer is not None:
                warm_row("paged_decode_q8", shape, row, floor, warm, call)
        del qd, kq, vq, ks, vs
    return main


def serve_run(dev, cfg, params, ecfg, workload):
    """Serve ``workload`` to completion on a fresh engine; returns (engine,
    result, launches per kernel, the run's own peak memory in GiB)."""
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run.serve(eng, workload)
    torch.cuda.synchronize()
    launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
    return eng, res, launches, torch.cuda.max_memory_allocated() / 2 ** 30


def check_serve(phase, cfg, ecfg, workload, eng, res, launches, peak, must_launch, **extra):
    """Emit the run's line and hold it to its launch counts (every layer: 2
    sublayer norms, 2 more with qk_norm, 1 SwiGLU (dense or an MoE layer's
    experts; none for gelu and relu2), 1 attention; plus the final norm,
    per prefill, prompt chunk and decode round alike; the chunks after a
    prompt's first take plain history attention), to launching every
    kernel of ``must_launch`` and to completing every request."""
    L = cfg.n_layers
    rounds = res.accounting["decode_rounds"]
    calls = eng.prefill_calls + eng.chunk_calls + rounds
    paged = ecfg.use_paged_kernel
    want = {"rmsnorm": ((2 + 2 * cfg.qk_norm) * L + 1) * calls,
            "swiglu": L * calls if cfg.ffn_act == "swiglu" else 0,
            "flash_attention": L * eng.prefill_calls,
            "paged_decode": L * rounds if paged else 0,
            "flash_decode": 0 if paged else L * rounds}
    s = res.summary()
    emit({"phase": phase, "config": cfg.name, "n_layers": L, "dtype": cfg.dtype,
          "decode": "paged" if paged else "dense", **s, **res.accounting,
          "decode_round_ms": 1e3 * eng.decode_wall_s / max(rounds, 1),
          "prefill_calls": eng.prefill_calls, "chunk_calls": eng.chunk_calls,
          "prefill_ms_per_call": 1e3 * eng.prefill_wall_s
          / max(eng.prefill_calls + eng.chunk_calls, 1),
          "launches": launches, "want_launches": want, "peak_mem_gib": peak, **extra})
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches}, want {want}")
    missing = [n for n in must_launch if launches[n] == 0]
    if missing:
        raise AssertionError(f"{phase}: the run never launched {missing}")
    for rs in res.states.values():
        if not rs.done or len(rs.emitted) != rs.req.max_new_tokens:
            raise AssertionError(f"{phase}: request {rs.rid} emitted {len(rs.emitted)} of "
                                 f"{rs.req.max_new_tokens} tokens")
    if len(res.states) != len(workload):
        raise AssertionError(f"{phase}: {len(res.states)} of {len(workload)} requests served")


def alone_row(phase, dev, cfg, params, ecfg, workload, streams) -> None:
    """Whole-run batch invariance: the request with the most new tokens,
    served alone on a fresh engine, gives the token stream it gave among
    all of ``workload``."""
    req = max(workload, key=lambda r: (r.max_new_tokens, -r.rid))
    res = run.serve(ServeEngine(cfg, params, ecfg, device=dev), [req])
    same = res.streams()[req.rid] == streams[req.rid]
    emit({"phase": phase, "request": req.rid, "prompt_len": len(req.prompt),
          "new_tokens": req.max_new_tokens, "served_with": len(workload),
          "stream_alone_equal_among_all": same})
    if not same:
        raise AssertionError(f"{phase}: request {req.rid} alone streams "
                             f"{res.streams()[req.rid]}, among all {streams[req.rid]}")


def serve_phase(dev):
    """The paged round, then the dense round on the same requests; each
    also with one request served alone."""
    cfg, params = run.build("qwen3-0.6b", device=dev, seed=0)
    workload = build_workload(SPEC)
    eng, res, launches, peak = serve_run(dev, cfg, params, PAGED_ECFG, workload)
    check_serve("serve", cfg, PAGED_ECFG, workload, eng, res, launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "paged_decode"))
    paged_streams = res.streams()
    del eng, res  # the paged engine's pool must not count in the dense run's peak
    alone_row("serve", dev, cfg, params, PAGED_ECFG, workload, paged_streams)
    eng, res, dense_launches, peak = serve_run(dev, cfg, params, ECFG, workload)
    same = res.streams() == paged_streams
    check_serve("serve dense", cfg, ECFG, workload, eng, res, dense_launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "flash_decode"),
                streams_equal_paged=same)
    if not same:
        raise AssertionError("serve dense: token streams differ from the paged round's")
    del eng
    alone_row("serve dense", dev, cfg, params, ECFG, workload, res.streams())
    launches["flash_decode"] = dense_launches["flash_decode"]
    return cfg, params, workload, launches


def chunk_share_logits(params, cfg, prompts, n_shared, n_steps, forced=None):
    """Two prompts through the chunk-and-share path: the first prefilled in
    chunks of CHUNK_PAGES pages; the second forks the first's pages below
    ``n_shared`` and prefills only its tail in chunks; then ``n_steps``
    dense decode rounds (gather_pages, kernel #5, scatter_token) for both.
    Returns (logits per step, tokens fed)."""
    dev, dt = params["embed"].device, params["embed"].dtype
    P = pages_needed(max(len(p) for p in prompts) + n_steps + 1, PS)
    n_fork = n_shared // PS
    pool = init_pool(cfg, 1 + 2 * P, PS, dt, dev)
    pages = torch.arange(1, 2 * P + 1, dtype=torch.int32, device=dev)
    tables = torch.stack([pages[:P], torch.cat([pages[:n_fork], pages[P:2 * P - n_fork]])])
    first = []
    for i, prompt in enumerate(prompts):
        off = n_fork * PS if i else 0
        while off < len(prompt):
            end = min(len(prompt), (off // PS + CHUNK_PAGES) * PS)
            pg_lo, pg_hi = off // PS, pages_needed(end, PS)
            toks = torch.zeros(1, pg_hi * PS - off, dtype=torch.int32, device=dev)
            toks[0, :end - off] = torch.tensor(prompt[off:end], dtype=torch.int32, device=dev)
            dense = gather_pages(pool, tables[i:i + 1], page_size=PS)
            dense, logits = forward_prefill_chunk(params, dense, {"tokens": toks}, off, cfg,
                                                  end - off - 1)
            scatter_pages(pool, dense, tables[i, pg_lo:pg_hi], pg_lo=pg_lo, n_pg=pg_hi - pg_lo,
                          page_size=PS)
            off = end
        first.append(logits[0])
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        dense = gather_pages(pool, tables, page_size=PS)
        dense, logits = forward_decode(params, dense, tok, lens, cfg, page_size=PS)
        scatter_token(pool, dense, tables, lens, page_size=PS)
        out.append(logits)
        lens = lens + 1
    return torch.stack(out), fed


def hold_bf16_path(phase, k_logits, p_logits, **extra) -> None:
    """Kernel path against plain path in bf16, at BF16_PATH_TOL."""
    diff = (k_logits - p_logits).abs()
    scale, mean_ref = float(p_logits.abs().max()), float(p_logits.abs().mean())
    max_err, mean_err = float(diff.max()), float(diff.mean())
    tol, mean_tol = BF16_PATH_TOL
    ok = (max_err <= tol * scale and mean_err <= mean_tol * mean_ref
          and bool(torch.isfinite(k_logits).all()))
    emit({"phase": phase, "dtype": "bfloat16", **extra, "max_abs_err": max_err,
          "mean_abs_err": mean_err, "max_abs_logit": scale, "mean_abs_logit": mean_ref,
          "limit": {"max_abs_err <=": tol * scale, "mean_abs_err <=": mean_tol * mean_ref},
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} bf16 path parity failed: max {max_err}, mean {mean_err}")


def anchored_bf16_path(phase, k_logits, p_logits, f_logits, **extra) -> None:
    """Kernel path against plain path in bf16 where ulp differences grow
    through the depth (mamba2's 64 layers): BF16_PATH_TOL's numbers are
    reported, and the gate is the anchor, the kernel path's logits no
    farther from the f32 plain path's (same weights upcast, same tokens)
    than TRAIN_ANCHOR_RATIO times the plain bf16 path's, in max and mean."""
    def errs(a, b):
        d = (a.float() - b.float()).abs()
        return float(d.max()), float(d.mean())

    kp, kf, pf = errs(k_logits, p_logits), errs(k_logits, f_logits), errs(p_logits, f_logits)
    tol, mean_tol = BF16_PATH_TOL
    scale, mean_ref = float(p_logits.abs().max()), float(p_logits.abs().mean())
    ok = (bool(torch.isfinite(k_logits).all()) and kf[0] <= TRAIN_ANCHOR_RATIO * pf[0]
          and kf[1] <= TRAIN_ANCHOR_RATIO * pf[1])
    emit({"phase": phase, "dtype": "bfloat16", **extra, "max_abs_err": kp[0],
          "mean_abs_err": kp[1], "max_abs_logit": scale, "mean_abs_logit": mean_ref,
          "reported_limit": {"max_abs_err <=": tol * scale, "mean_abs_err <=": mean_tol * mean_ref},
          "within_reported_limit": kp[0] <= tol * scale and kp[1] <= mean_tol * mean_ref,
          "kernels_vs_f32": kf, "plain_vs_f32": pf, "anchor_ratio_limit": TRAIN_ANCHOR_RATIO,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} bf16 path anchor failed: kernels {kf}, plain {pf} "
                             "from the f32 path")


def chunk_share_phase(dev, cfg, params) -> None:
    workload = build_workload(SHARE_SPEC)
    eng, res, launches, peak = serve_run(dev, cfg, params, SHARE_ECFG, workload)
    check_serve("serve chunk/share", cfg, SHARE_ECFG, workload, eng, res, launches, peak,
                ("rmsnorm", "swiglu", "flash_decode"))
    if not (res.accounting["n_prefix_hits"] > 0 and eng.chunk_calls > 0):
        raise AssertionError(f"serve chunk/share: prefix hits {res.accounting['n_prefix_hits']},"
                             f" chunks {eng.chunk_calls}")
    del eng
    alone_row("serve chunk/share", dev, cfg, params, SHARE_ECFG, workload, res.streams())
    # two requests of one prefix group
    head = SHARE_SPEC.shared_prefix
    by_group = {}
    for req in workload:
        by_group.setdefault(tuple(req.prompt[:head]), []).append(list(req.prompt))
    prompts = next(g[:2] for g in by_group.values() if len(g) >= 2)
    k_logits, fed = chunk_share_logits(params, cfg, prompts, head, 16)
    with plain_versions():
        p_logits, _ = chunk_share_logits(params, cfg, prompts, head, 16, forced=fed)
    hold_bf16_path("serve chunk/share parity", k_logits, p_logits, n_layers=cfg.n_layers,
                   prompt_lens=[len(p) for p in prompts], shared=head, steps=1 + len(fed))


def path_logits(params, cfg, prompts, n_steps, forced=None):
    """Prefill each prompt into its own pages, then ``n_steps`` paged decode
    steps for all of them at once.  Returns (logits per step, tokens fed)."""
    dev = params["embed"].device
    dt = params["embed"].dtype
    n = len(prompts)
    P = pages_needed(max(len(p) for p in prompts) + n_steps + 1, PS)
    pool = init_pool(cfg, 1 + n * P, PS, dt, dev)
    tables = (torch.arange(n * P, device=dev, dtype=torch.int32) + 1).reshape(n, P)
    first = []
    for i, prompt in enumerate(prompts):
        n_pg = pages_needed(len(prompt), PS)
        toks = torch.zeros(1, n_pg * PS, dtype=torch.int32, device=dev)
        toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32, device=dev)
        dense, logits = forward_prefill(
            params, {"tokens": toks}, cfg, cache_structs(cfg, 1, n_pg * PS, dt),
            logit_pos=torch.tensor([len(prompt) - 1], device=dev))
        scatter_prefill(pool, dense, tables[i:i + 1, :n_pg], page_size=PS)
        first.append(logits[0])
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        pool, logits = forward_decode(params, pool, tok, lens, cfg, page_tables=tables,
                                      page_size=PS)
        out.append(logits)
        lens = lens + 1
    return torch.stack(out), fed


def parity_phase(dev, cfg, params, workload) -> None:
    prompts = [list(workload[0].prompt), list(workload[1].prompt)]
    f32_cfg, f32_params = run.build("qwen3-0.6b", device=dev, layers=4, dtype="float32",
                                    seed=1)
    k_logits, fed = path_logits(params, cfg, prompts, 16)
    with plain_versions():
        p_logits, _ = path_logits(params, cfg, prompts, 16, forced=fed)
    hold_bf16_path("parity", k_logits, p_logits, n_layers=cfg.n_layers, requests=[0, 1],
                   steps=1 + len(fed))
    # f32: only the summation order differs
    k_logits, fed = path_logits(f32_params, f32_cfg, prompts, 16)
    with plain_versions():
        p_logits, _ = path_logits(f32_params, f32_cfg, prompts, 16, forced=fed)
    max_err = float((k_logits - p_logits).abs().max())
    ok = max_err <= 1e-4 and bool(torch.isfinite(k_logits).all())
    emit({"phase": "parity", "dtype": "float32", "n_layers": f32_cfg.n_layers, "requests": [0, 1],
          "steps": 1 + len(fed), "max_abs_err": max_err,
          "max_abs_logit": float(p_logits.abs().max()), "limit": {"max_abs_err <=": 1e-4},
          "ok": ok})
    if not ok:
        raise AssertionError(f"float32 path parity failed: max {max_err}")


def train_launches_per_step(cfg, mode: str, flags: ExecFlags, mecefo: MeCeFOConfig) -> dict:
    """Kernel launches one training step must make: every layer's forward
    launches its norms (an attention mixer's norm, plus q/k norms with
    qk_norm; an SSM mixer's norm and gate norm; the FFN norm), its SwiGLU
    (dense or an MoE layer's experts; none for gelu and relu2, and none for
    a zero-width FFN, whose empty call launches nothing) and an attention
    layer's attention; the FFN recompute (technique II or remat "ffn")
    launches the FFN norm and the activation again in the backward, and
    technique II's SSM recompute (degraded mode) the SSM mixer's two norms;
    the final norm launches once; each low-rank matmul (an SSM mixer's
    in_proj and out_proj; a dense FFN's 3 with a gate, else 2, unless it
    has zero width) launches kernel #6 once in the backward unless the step
    is exact (the MoE experts' grouped low-rank backward is batched
    products, as in the reference); each SwiGLU (dense or an MoE layer's
    experts, not zero-width) launches its backward kernel once, recompute
    or not.  The backwards of the norm and attention recompute their plain
    versions and launch nothing."""
    if flags.remat not in ("none", "ffn"):
        raise ValueError(f"no launch count derived for remat {flags.remat!r}")
    L = cfg.n_layers
    recompute = flags.remat == "ffn" or (mode == "degraded" and mecefo.recompute_ffn)
    ssm_recompute = mode == "degraded" and mecefo.recompute_ffn
    exact = NDBContext(mode=mode, mecefo=mecefo).lowrank_mode() == "exact"
    gated = cfg.ffn_act == "swiglu"
    moe = sum(cfg.layer_is_moe(i) for i in range(L))
    dense = (L - moe) if cfg.d_ff else 0
    ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(L))
    attn = L - ssm
    return {
        "rmsnorm": ((1 + 2 * cfg.qk_norm) * attn + (2 + 2 * ssm_recompute) * ssm
                    + (1 + recompute) * L + 1),
        "swiglu": (1 + recompute) * (dense + moe) if gated else 0,
        "swiglu_bwd": dense + moe if gated else 0,
        "flash_attention": attn,
        "lowrank_wgrad": 0 if exact else (3 if gated else 2) * dense + 2 * ssm,
    }


def train_phase(dev):
    cell = train_cell(dev)  # V1 refreshed before the first step
    cfg = cell.cfg
    src = cell.source()
    batches = [src.batch(i, TRAIN_B, TRAIN_S) for i in range(TRAIN_STEPS)]
    out = {}
    total = {n: 0 for n in TRAIN_KERNELS}
    for mode in TRAIN_MODES:
        state = cell.state()
        step, ndb = cell.step(mode, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset_launches()
        losses, times = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i], *ndb)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
        want = train_launches_per_step(cfg, mode, TRAIN_FLAGS, cell.mecefo)
        per_step = {n: launches[n] / TRAIN_STEPS for n in TRAIN_KERNELS}
        med = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated()
        ok = per_step == want and bool(np.isfinite([*losses, gnorm]).all())
        emit({"phase": "train", "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
              "mode": mode, "batch": TRAIN_B, "seq_len": TRAIN_S, "rank": TRAIN_RANK,
              "remat": TRAIN_FLAGS.remat, "losses": losses, "last_grad_norm": gnorm,
              "step_ms": [1e3 * t for t in times], "step_ms_median": 1e3 * med,
              "tokens_per_s": TRAIN_B * TRAIN_S / med, "peak_mem_gib": peak / 2 ** 30,
              "peak_above_state_gib": (peak - base_mem) / 2 ** 30,
              "launches_per_step": per_step, "want_launches_per_step": want,
              "svd_refresh_s": cell.svd_s, "ok": ok})
        if not ok:
            raise AssertionError(f"train {mode}: launches {per_step} (want {want}), "
                                 f"losses {losses}, grad norm {gnorm}")
        for n in TRAIN_KERNELS:
            total[n] += launches[n]
        out[mode] = peak
        del state, step
    if not out["degraded"] < out["off"]:
        raise AssertionError(f"degraded peak memory {out['degraded']} not below off {out['off']}")
    missing = [n for n, c in total.items() if c == 0]
    if missing:
        raise AssertionError(f"the train run never launched {missing}")
    return total


def leaf_rel_errs(ga, gb) -> list:
    """Per gradient leaf, ||a - b|| / ||b||."""
    return [float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
            for a, b in zip(tree_leaves(ga), tree_leaves(gb))]


def parity_ctx(mode: str, keep, w, dev) -> NDBContext:
    mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK)
    if mode in ("off", "degraded"):
        return NDBContext(mode=mode, mecefo=mecefo)
    return NDBContext(mode=mode, keep=torch.as_tensor(keep, device=dev),
                      example_weight=torch.as_tensor(w, device=dev), mecefo=mecefo)


def train_parity_phase(dev) -> None:
    """One step's loss and gradients through the kernels and through the
    plain versions, with the train phase's flags (FFN recompute): in bf16
    at full depth in dynamic and degraded mode, in f32 on a 4-layer copy in
    all four modes.  In bf16 both are also held against the same step in
    f32 (plain versions, the same weights upcast): the kernel path may be
    no farther from it than TRAIN_ANCHOR_RATIO times the plain bf16 path
    is."""
    full = get_config(TRAIN_CONFIG)
    checks = (("bfloat16", full, ("dynamic", "degraded")),
              ("float32", dataclasses.replace(full, n_layers=4, dtype="float32"), TRAIN_MODES))
    for dtype, cfg, modes in checks:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
        proj = refresh_projections(params, cfg, TRAIN_RANK)
        keep, w = plan_to_masks(TRAIN_PLAN, cfg, TRAIN_B)
        batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, TRAIN_B, TRAIN_S), dev)
        for mode in modes:
            ctx = parity_ctx(mode, keep, w, dev)
            lk, _, gk = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
            with plain_versions():
                lp, _, gp = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
            rel = leaf_rel_errs(gk, gp)
            tol, loss_tol = TRAIN_PARITY_TOL[dtype]
            loss_err = abs(float(lk) - float(lp))
            ok = (max(rel) <= tol and loss_err <= loss_tol * abs(float(lp))
                  and all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk)))
            row = {"phase": "train parity", "dtype": dtype, "n_layers": cfg.n_layers,
                   "mode": mode, "remat": TRAIN_FLAGS.remat, "loss_kernels": float(lk),
                   "loss_plain": float(lp), "loss_abs_err": loss_err, "loss_limit_rel": loss_tol,
                   "max_leaf_rel_err": max(rel), "mean_leaf_rel_err": sum(rel) / len(rel),
                   "n_leaves": len(rel), "limit_rel": tol}
            if dtype == "bfloat16":
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                up = lambda t: t.float()  # noqa: E731
                with plain_versions():
                    _l32, _, g32 = loss_and_grads(tree_map(up, params), tree_map(up, proj), batch,
                                                  cfg32, ctx, TRAIN_FLAGS)
                to_k, to_p = max(leaf_rel_errs(gk, g32)), max(leaf_rel_errs(gp, g32))
                ok = ok and to_k <= TRAIN_ANCHOR_RATIO * to_p
                row.update({"max_leaf_rel_err_kernels_vs_f32": to_k,
                            "max_leaf_rel_err_plain_vs_f32": to_p,
                            "anchor_ratio_limit": TRAIN_ANCHOR_RATIO})
                del g32
            emit(dict(row, ok=ok))
            if not ok:
                raise AssertionError(f"{dtype} {mode} train parity failed: {row}")
            del gk, gp
            torch.cuda.empty_cache()
        del params, proj


def fresh_state(base: TrainState, train: TrainConfig) -> TrainState:
    """A copy of the seeded state with zero moments (a trainer updates its
    state in place)."""
    params = tree_map(lambda t: t.clone(), base.params)
    return TrainState(step=0, params=params, opt=init_opt_state(params, train),
                      proj=tree_map(lambda t: t.clone(), base.proj))


def count_trainer_launches(trainer):
    """Wrap the trainer's step lookup so that every step call records its
    key's mode and its kernel launches; returns the list they land in, one
    ``(mode, {kernel: launches})`` per step in run order."""
    per_step = []
    get = trainer._get_step

    def get_counted(key):
        step = get(key)

        def run(*args):
            before = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
            out = step(*args)
            per_step.append((key[0], {n: WRAPPERS[n].launches - before[n]
                                      for n in TRAIN_KERNELS}))
            return out
        return run

    trainer._get_step = get_counted
    return per_step


def step_launch_check(cfg, flags, mecefo, per_step) -> tuple:
    """Each counted step's launches against ``train_launches_per_step`` of
    its key's mode: ``(want by mode, the steps that differ)``."""
    want = {m: train_launches_per_step(cfg, m, flags, mecefo) for m, _ in per_step}
    return want, [(i, m, got) for i, (m, got) in enumerate(per_step) if got != want[m]]


def controller_replay(trace, cfg) -> dict:
    """The recovery accounting of the trace's events replayed through the
    FT controller alone (no model) for ``cfg``: its byte totals follow
    ``count_params(cfg)``."""
    h = trace.header
    ctl = FTController(cfg=cfg, mecefo=MeCeFOConfig(mode="dynamic"), n_dp=h.n_dp,
                       n_stages=min(h.n_stages, cfg.n_layers), global_batch=TRAIN_B)
    engine = replay_engine(trace)
    for step in range(trace.footer.total_steps):
        ctl.apply_chaos(engine.step(step))
    return ctl.accounting.as_dict()


def trainer_run(dev, run, trace_name, mode, cfg, base) -> dict:
    """One replay of a golden chaos trace through the port's Trainer at the
    train cell; checks the events, the accounting, each step's launches
    against its key's mode and the losses, and emits one row."""
    trace = load_trace(os.path.join(TRAINER_DATA, trace_name))
    footer = trace.footer.accounting
    steps = trace.footer.total_steps
    train = TrainConfig(steps=steps)
    mecefo = MeCeFOConfig(mode=mode, rank=TRAIN_RANK, svd_period=TRAINER_SVD_PERIOD)
    shape = ShapeConfig("trainer", TRAIN_S, TRAIN_B, "train")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()  # the seeded weights kept for the next runs
    trainer = Trainer(cfg, shape, train, mecefo=mecefo, trace_replay=trace,
                      state=fresh_state(base, train), device=dev)
    per_step = count_trainer_launches(trainer)
    t0 = time.perf_counter()
    hist = trainer.run(log_every=0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del trainer._get_step  # the counting wrapper refers to the trainer
    acc = trainer.controller.accounting.as_dict()
    want_acc = controller_replay(trace, cfg)
    reduced_acc = controller_replay(trace, reduced(cfg, dtype="float32"))
    counts = {k: v for k, v in footer.items() if k.startswith("n_")}
    events_ok = verify_replay(trace, trainer.process) == []
    losses = [r["loss"] for r in hist]
    modes = [m for m, _ in per_step]
    want, bad_launches = step_launch_check(cfg, trainer.flags, mecefo, per_step)
    ms_by = {m: [1e3 * r["seconds"] for r, k in zip(hist, modes) if k == m] for m in want}
    ok = (len(hist) == steps == len(per_step) and events_ok
          and all(acc[k] == v for k, v in counts.items()) and acc == want_acc
          and all(reduced_acc[k] == v for k, v in footer.items())
          and not bad_launches and bool(np.isfinite(losses).all()))
    emit({"phase": "trainer", "run": run, "trace": trace_name, "mecefo": mode,
          "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_B,
          "seq_len": TRAIN_S, "rank": TRAIN_RANK, "remat": trainer.flags.remat,
          "svd_period": TRAINER_SVD_PERIOD, "steps": len(hist),
          "n_events": len(trainer.process.events), "events_verified": events_ok,
          "footer_counts": counts, "accounting": acc, "controller_replay_accounting": want_acc,
          "reduced_controller_replay_equals_footer": all(
              reduced_acc[k] == v for k, v in footer.items()),
          "n_step_keys": len(trainer._step_cache),
          "steps_by_key_mode": {m: len(v) for m, v in ms_by.items()},
          "step_ms_median_by_key_mode": {m: float(np.median(v)) for m, v in ms_by.items()},
          "step_ms_max_by_key_mode": {m: max(v) for m, v in ms_by.items()},
          "launches_per_step_by_key_mode": {m: want[m] for m in sorted(want)},
          "bad_launch_steps": bad_launches[:5], "losses": losses,
          "final_loss": losses[-1], "svd_refresh_s": trainer.refresh_s,
          "run_wall_s": wall, "tokens_per_s": TRAIN_B * TRAIN_S * len(hist) / wall,
          "peak_mem_gib": peak / 2 ** 30,
          "peak_above_kept_weights_gib": (peak - base_mem) / 2 ** 30,
          "dp_size": [r["dp_size"] for r in hist], "failed": [r["failed"] for r in hist],
          "ok": ok})
    if not ok:
        raise AssertionError(f"trainer {run}: events {events_ok}, accounting {acc} vs footer "
                             f"{footer} / controller {want_acc}, launches {bad_launches[:3]}, "
                             f"losses {losses}")
    del trainer
    return {"losses": losses, "launches": {n: sum(got[n] for _, got in per_step)
                                           for n in TRAIN_KERNELS}}


def trainer_checkpoint_row(dev) -> None:
    """A run with checkpoints, resumed by a new trainer from its newest
    one, reproduces the uninterrupted run's last loss (a device failure
    injected at that step makes it a dynamic step through V1 restored from
    the checkpoint)."""
    c = TRAINER_CKPT
    cfg = dataclasses.replace(get_config(TRAIN_CONFIG), n_layers=c["n_layers"], dtype="float32")
    shape = ShapeConfig("trainer ckpt", TRAIN_S, TRAIN_B, "train")
    mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK, svd_period=c["every"])
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train = TrainConfig(steps=c["steps"], checkpoint_every=c["every"],
                            checkpoint_dir=directory)

        def trainer():
            t = Trainer(cfg, shape, train, mecefo=mecefo, n_dp=4, n_stages=2, device=dev)
            t.process.inject(c["fail_step"], (1, 0), down_steps=c["steps"])
            return t

        h1 = trainer().run(log_every=0)
        t2 = trainer()
        resumed = t2.resume_from_checkpoint()
        start = t2.state.step
        h2 = t2.run(steps=c["steps"] - start, log_every=0)
        ref = {r["step"]: r for r in h1}[h2[-1]["step"]]
        rel = abs(h2[-1]["loss"] - ref["loss"]) / abs(ref["loss"])
        ok = (resumed and type(start) is int and start == c["steps"] - 1
              and h2[-1]["failed"] > 0 and rel <= c["rtol"])
        emit({"phase": "trainer", "run": "checkpoint resume", "config": cfg.name,
              "n_layers": cfg.n_layers, "dtype": cfg.dtype, "checkpoint_every": c["every"],
              "resumed_at_step": start, "steps_after_resume": len(h2),
              "loss_uninterrupted": ref["loss"], "loss_resumed": h2[-1]["loss"],
              "loss_rel_err": rel, "limit_rel": c["rtol"], "ok": ok})
        if not ok:
            raise AssertionError(f"trainer checkpoint resume failed: resumed {resumed}, "
                                 f"start {start!r}, rel {rel}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def trainer_phase(dev) -> None:
    """The port's Trainer replays the golden chaos traces at full depth:
    dynamic and static on golden_trace.jsonl, dynamic on the elastic one;
    the dynamic golden replay a second time for repeatability (reported,
    not gated); then the checkpoint round trip."""
    cfg = get_config(TRAIN_CONFIG)
    base = init_state(cfg, TrainConfig(), MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK),
                      torch.Generator().manual_seed(0), device=dev)._replace(opt=None)
    reset_launches()
    total = {n: 0 for n in TRAIN_KERNELS}
    runs = {}
    for run, trace_name, mode in TRAINER_RUNS:
        runs[run] = trainer_run(dev, run, trace_name, mode, cfg, base)
        for n in TRAIN_KERNELS:
            total[n] += runs[run]["launches"][n]
    if {n: WRAPPERS[n].launches for n in TRAIN_KERNELS} != total:
        raise AssertionError("trainer launches outside its steps")
    missing = [n for n, c in total.items() if c == 0]
    if missing:
        raise AssertionError(f"the trainer runs never launched {missing}")
    again = trainer_run(dev, "dynamic golden, again", TRAINER_RUNS[0][1], TRAINER_RUNS[0][2],
                        cfg, base)
    first = np.array(runs[TRAINER_RUNS[0][0]]["losses"])
    second = np.array(again["losses"])
    emit({"phase": "trainer", "run": "repeatability (reported, not gated)",
          "losses_bitwise_equal": bool((first == second).all()),
          "max_rel_diff": float(np.max(np.abs(first - second)
                                       / np.maximum(np.abs(first), 1e-30)))})
    del base
    torch.cuda.empty_cache()
    trainer_checkpoint_row(dev)


def tree_digest(tree, dev) -> list:
    """Bitwise digest of a state tree, computed on the card: per tensor leaf
    the wrapped int64 sum of its raw words times position weights (a host
    leaf crosses to the card a chunk at a time); other leaves as they are."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for x in tree_flatten(tree)[0]:
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        words = x.detach().reshape(-1).view(ints[x.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(0, words.numel(), DIGEST_CHUNK):
            w = words[i:i + DIGEST_CHUNK].to(dev).to(torch.int64)
            pos = torch.arange(i, i + w.numel(), device=dev, dtype=torch.int64) % 65521 + 1
            total += (w * pos).sum()
        out.append(int(total))
    return out


class HostRSS:
    """The process's resident set over a window, sampled every 10 ms from
    ``/proc/self/statm`` (the card machine's ``/proc`` has no VmHWM to
    reset); ``peak_gib`` and ``start_gib`` after the window."""

    def __init__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start_gib = self.peak_gib = self.read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def read(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 2 ** 30

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak_gib = max(self.peak_gib, self.read())

    def stop(self) -> "HostRSS":
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self.read())
        return self


def statexfer_cli_row(trace_name: str, tmp: str) -> None:
    """(a) The port's CLI replays a golden recorded with live state transfer
    on the card, at the reduced config, with the goldens' own flags: exit 0
    means the events, the whole footer and (policy trace) every decision
    re-derived.  The statexfer replay also writes its incident log, which
    ``python -m repro_torch.obs incidents`` must verify against the golden
    log, reconcile with the footer and find closed, and its telemetry,
    whose exposition must parse and whose report must show the snapshot
    overhead."""
    trace = os.path.join(TRAINER_DATA, trace_name)
    inc, dump = os.path.join(tmp, "incidents.jsonl"), os.path.join(tmp, "obs.jsonl")
    xfer = trace_name == XFER_TRACE
    argv = XFER_CLI + ["--trace", "replay", trace]
    if xfer:
        argv += ["--incidents-out", inc, "--obs-out", dump]
    obs.reset()  # the dump reads the process's registry: this run's metrics only
    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        rc = train_main(argv)
    wall = time.perf_counter() - t0
    row = {"phase": "statexfer", "run": "cli reduced", "trace": trace_name, "argv": argv[:-1],
           "exit_code": rc, "wall_s": wall}
    ok = rc == 0
    if xfer:
        verify = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "incidents", inc,
             "--verify", os.path.join(TRAINER_DATA, XFER_INCIDENTS), "--trace", trace,
             "--require-closed", "1"],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        prom = obs.parse_prometheus_text(open(dump + ".prom").read())
        recovery = {r["name"].removeprefix("ft.recovery."): r["value"]
                    for r in obs.load_dump(dump) if r.get("name", "").startswith("ft.recovery.")}
        text = report.getvalue()
        row.update(incidents_verify_exit_code=verify.returncode,
                   incidents_verify=[ln for ln in verify.stdout.splitlines() if " OK" in ln],
                   prom_families=len(prom), recovery=recovery,
                   report_snapshot_section=[ln.strip() for ln in text.splitlines()
                                            if ln.strip().startswith(("cycles=", "blocked/"))])
        ok = (ok and verify.returncode == 0 and "verify OK" in verify.stdout
              and "reconcile OK" in verify.stdout
              and "snapshot overhead (statexfer.snapshot.*):" in text
              and recovery.get("measured_transfer_bytes") == 55782440
              and recovery.get("n_peer_restores") == 10)
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"statexfer CLI replay of {trace_name} failed: {row}")


def statexfer_full_run(dev, cfg, base, statexfer: bool) -> dict:
    """(b) The statexfer golden through the Trainer at the train cell,
    without or with state transfer at snapshot cadence 1.  Gates: events
    verify; every count equals the footer's (without state transfer, those
    that do not come from it); each step's launches equal
    ``train_launches_per_step`` of its key and no launch happens outside the
    steps; finite losses.  With state transfer also the measured bytes
    (restores x the measured state size) and, for every peer restore, the
    restored tree's digest equal to the trainer's state at the receipt's
    snapshot step (digests on the card, at the detach calls and at the
    cadence captures of the steps the trace names; their time is taken out
    of the step times reported)."""
    trace = load_trace(os.path.join(TRAINER_DATA, XFER_TRACE))
    footer, steps = trace.footer.accounting, trace.footer.total_steps
    train = TrainConfig(steps=steps)
    mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK, svd_period=TRAINER_SVD_PERIOD)
    shape = ShapeConfig("statexfer", TRAIN_S, TRAIN_B, "train")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rss = HostRSS()
    reset_launches()
    trainer = Trainer(cfg, shape, train, mecefo=mecefo, trace_replay=trace,
                      state=fresh_state(base, train), device=dev, statexfer=statexfer,
                      snapshot_every=1)
    per_step = count_trainer_launches(trainer)
    named = {e.step for e in trace.events}
    pins, cycles, restored, digest_s = {}, {}, {}, {}

    def timed(step, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        digest_s[step] = digest_s.get(step, 0.0) + time.perf_counter() - t0
        return out

    if statexfer:
        xfer = trainer.xfer
        on_reshard, on_step, retry = xfer.on_reshard, xfer.on_step, xfer.retry_pending

        def reshard_counted(plan, state, step, **kw):
            if plan.dropped:
                d = timed(step, tree_digest, state, dev)
                pins.update({(step, r): d for r in plan.dropped})
            out = on_reshard(plan, state, step, **kw)
            for r, tree in out.restored.items():
                restored[(r, step)] = timed(step, tree_digest, tree, dev)
            return out

        def step_counted(state, step, plan):
            if step in named:
                cycles[step] = timed(step, tree_digest, state, dev)
            return on_step(state, step, plan)

        def retry_counted(step, **kw):
            done = retry(step, **kw)
            for r in done:
                restored[(r.rank, step)] = timed(step, tree_digest, xfer.last_restored[r.rank], dev)
            return done

        xfer.on_reshard, xfer.on_step, xfer.retry_pending = (
            reshard_counted, step_counted, retry_counted)
    t0 = time.perf_counter()
    hist = trainer.run(log_every=0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rss.stop()
    del trainer._get_step  # the wrappers refer to the trainer
    acc = trainer.controller.accounting.as_dict()
    xfer_counts = ("n_peer_restores", "n_ckpt_restores")
    counts = {k: v for k, v in footer.items() if k.startswith("n_")
              and (statexfer or k not in xfer_counts)}
    events_ok = verify_replay(trace, trainer.process) == []
    losses = [r["loss"] for r in hist]
    modes = [m for m, _ in per_step]
    want, bad_launches = step_launch_check(cfg, trainer.flags, mecefo, per_step)
    outside = {n: WRAPPERS[n].launches - sum(got[n] for _, got in per_step) for n in TRAIN_KERNELS}
    seconds = [r["seconds"] - digest_s.get(r["step"], 0.0) for r in hist]
    ms_by = {m: [1e3 * t for t, k in zip(seconds, modes) if k == m] for m in want}
    step_sum = sum(seconds)
    row = {"phase": "statexfer", "run": "train cell " + ("with" if statexfer else "without")
           + " state transfer", "trace": XFER_TRACE, "config": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_B, "seq_len": TRAIN_S,
           "rank": TRAIN_RANK, "statexfer": statexfer, "snapshot_every": 1, "steps": len(hist),
           "events_verified": events_ok, "footer_counts": counts, "accounting": acc,
           "step_ms_median_by_key_mode": {m: float(np.median(v)) for m, v in ms_by.items()},
           "step_ms_max_by_key_mode": {m: max(v) for m, v in ms_by.items()},
           "step_s_sum": step_sum, "digest_s": sum(digest_s.values()),
           "svd_refresh_s": trainer.refresh_s, "run_wall_s": wall,
           "tokens_per_s": TRAIN_B * TRAIN_S * len(hist) / (wall - sum(digest_s.values())),
           "peak_mem_gib": peak / 2 ** 30, "peak_above_kept_weights_gib": (peak - base_mem) / 2 ** 30,
           "host_rss_start_gib": rss.start_gib, "host_rss_peak_gib": rss.peak_gib,
           "launches_per_step_by_key_mode": want, "bad_launch_steps": bad_launches[:5],
           "launches_outside_steps": outside, "final_loss": losses[-1]}
    ok = (len(hist) == steps == len(per_step) and events_ok
          and all(acc[k] == v for k, v in counts.items()) and not bad_launches
          and not any(outside.values()) and bool(np.isfinite(losses).all()))
    if statexfer:
        tele = trainer.xfer.telemetry()
        nbytes = state_nbytes(trainer.state)
        receipts = [r for r in trainer.xfer.receipts if r.ok]
        ckpt_bytes = sum(r.bytes_moved for r in receipts if r.source == "ckpt")
        digests_ok = []
        for r in receipts:
            if r.source != "peer":
                continue
            src = pins.get((r.snapshot_step, r.rank), cycles.get(r.snapshot_step))
            digests_ok.append(src is not None and restored.get((r.rank, r.step)) == src)
        breach = [i.open_step for i in trainer.controller.incidents.mgr.incidents
                  if i.kind == "snapshot_budget_breach"]
        # one host copy of the final state each way, reported: into the
        # snapshot's page-locked buffer and into pageable memory
        copy_s = {}
        for name, fn in (("page_locked", tsnap._host_tree), ("pageable", host_copy)):
            t1 = time.perf_counter()
            fn(trainer.state)
            copy_s[name] = time.perf_counter() - t1
        row.update(state_nbytes=nbytes, telemetry=tele,
                   blocked_share=tele["snapshot_blocked_s"] / step_sum, budget=XFER_BUDGET,
                   budget_breach_incident_steps=breach,
                   receipts=[(r.rank, r.step, r.source, r.bytes_moved, r.snapshot_step)
                             for r in receipts],
                   restore_digests_equal=digests_ok, n_digest_steps=len(cycles) + len(pins),
                   state_host_copy_s=copy_s)
        ok = (ok and acc["measured_transfer_bytes"]
              == acc["n_peer_restores"] * nbytes + ckpt_bytes
              and len(digests_ok) == acc["n_peer_restores"] > 0 and all(digests_ok))
        del trainer.xfer.on_reshard, trainer.xfer.on_step, trainer.xfer.retry_pending
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"statexfer train cell run (statexfer={statexfer}) failed: {row}")
    del trainer
    return {"launches": {n: sum(got[n] for _, got in per_step) for n in TRAIN_KERNELS}}


def statexfer_adaptive_row(dev, tmp: str) -> dict:
    """(c) An adaptive-policy decision round trip at full width: a Trainer
    with ``ft_policy="adaptive"``, the elastic chaos preset and state
    transfer records a trace (the policy golden's settings: n_dp 4, 2
    stages, seed 0), and a new Trainer replays it: ``verify_replay()`` must
    find nothing (events, accounting at the measured full-width bytes and
    every decision)."""
    cfg = dataclasses.replace(get_config(TRAIN_CONFIG), n_layers=XFER_ADAPTIVE_LAYERS)
    train = TrainConfig(steps=XFER_ADAPTIVE_STEPS)
    mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK, svd_period=TRAINER_SVD_PERIOD)
    shape = ShapeConfig("statexfer adaptive", TRAIN_S, TRAIN_B, "train")
    path = os.path.join(tmp, "adaptive.jsonl")
    reset_launches()
    rec = Trainer(cfg, shape, train, mecefo=mecefo, n_dp=4, n_stages=2, step_time_s=3600.0,
                  injectors=chaos_preset("elastic", SCENARIOS["none"]), trace_record=path,
                  statexfer=True, ft_policy="adaptive", device=dev)
    per_step = count_trainer_launches(rec)
    rec.run(log_every=0)
    del rec._get_step
    rep = Trainer(cfg, shape, train, mecefo=mecefo, trace_replay=path, statexfer=True,
                  device=dev)
    replayed = count_trainer_launches(rep)
    rep.run(log_every=0)
    del rep._get_step
    per_step += replayed
    problems = rep.verify_replay()
    outside = {n: WRAPPERS[n].launches - sum(got[n] for _, got in per_step) for n in TRAIN_KERNELS}
    want, bad_launches = step_launch_check(cfg, rep.flags, mecefo, per_step)
    trace = load_trace(path)
    acc = rep.controller.accounting.as_dict()
    nbytes = state_nbytes(rep.state)
    chosen = [d["chosen"] for d in trace.decisions]
    ok = (problems == [] and rep.policy_spec == "adaptive" and len(chosen) > 0
          and not bad_launches and not any(outside.values())
          and acc == rec.controller.accounting.as_dict() and acc["n_peer_restores"] > 0
          and acc["measured_transfer_bytes"] == acc["n_peer_restores"] * nbytes)
    emit({"phase": "statexfer", "run": "adaptive round trip", "config": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_B, "seq_len": TRAIN_S,
          "rank": TRAIN_RANK, "steps": XFER_ADAPTIVE_STEPS, "n_events": len(trace.events),
          "n_decisions": len(chosen), "chosen": chosen, "state_nbytes": nbytes,
          "accounting": acc, "verify_replay_problems": problems[:5],
          "launches_per_step_by_key_mode": want, "bad_launch_steps": bad_launches[:5],
          "launches_outside_steps": outside, "ok": ok})
    if not ok:
        raise AssertionError(f"adaptive round trip failed: {problems[:5]}, {acc}")
    del rec, rep
    return {"launches": {n: sum(got[n] for _, got in per_step) for n in TRAIN_KERNELS}}


def statexfer_phase(dev) -> None:
    """Live state transfer on the card: (a) the goldens through the CLI at
    the reduced config, (b) the statexfer golden at the train cell without
    and with state transfer, (c) an adaptive decision round trip at full
    width.  The kernel launch counts are read around the whole phase."""
    t0 = time.perf_counter()
    reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_statexfer_")
    try:
        for trace_name in (XFER_TRACE, XFER_POLICY_TRACE):
            statexfer_cli_row(trace_name, tmp)
        cli = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
        cfg = dataclasses.replace(get_config(TRAIN_CONFIG), n_layers=XFER_CELL_LAYERS)
        base = init_state(cfg, TrainConfig(), MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK),
                          torch.Generator().manual_seed(0), device=dev)._replace(opt=None)
        total = {n: 0 for n in TRAIN_KERNELS}
        for statexfer in (False, True):
            got = statexfer_full_run(dev, cfg, base, statexfer)["launches"]
            total = {n: total[n] + got[n] for n in TRAIN_KERNELS}
        del base
        torch.cuda.empty_cache()
        got = statexfer_adaptive_row(dev, tmp)["launches"]
        total = {n: total[n] + got[n] for n in TRAIN_KERNELS}
        missing = [n for n in TRAIN_KERNELS if total[n] == 0 or cli[n] == 0]
        if missing:
            raise AssertionError(f"the statexfer phase never launched {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "statexfer", "run": "phase", "seconds": time.perf_counter() - t0,
          "cli_launches": cli, "trainer_launches": total})


def masked(events) -> list:
    """Serve events as JSON with their token values masked."""
    return [dict(ev.to_json(), token=None) for ev in events]


def golden_rows(dev, tmp: str) -> None:
    """(a) The JAX serve goldens' headers through the port on the card,
    tokens masked against the committed file; each recording replayed
    through the CLI in process."""
    for name in REPL_GOLDENS:
        path = os.path.join(TRAINER_DATA, name)
        trace = load_serve_trace(path)
        rec = os.path.join(tmp, name)
        obs.reset()
        res, rset = run.run_from_header(trace.header, record_path=rec, device=dev)
        row = {"phase": "replicas", "run": "golden " + name, "steps": res.n_steps,
               "events_equal_tokens_masked": masked(rset.events) == masked(trace.events),
               "footer_equal": {k: res.accounting.get(k) for k in trace.footer.accounting}
               == trace.footer.accounting,
               "steps_equal": res.n_steps == trace.footer.total_steps}
        if trace.decisions:
            row["decisions_equal"] = not verify_decisions(trace.decisions, rset.policy.decisions)
            row["n_decisions"] = len(trace.decisions)
        if name == "golden_trace_overload.jsonl":
            records = rset.incidents.mgr.records()
            row["incidents_verify"] = obs.verify_incident_log(
                os.path.join(TRAINER_DATA, REPL_INCIDENTS), records)
            row["incidents_reconcile"] = obs.reconcile(records, obs.footer_accounting(path))
            row["incidents_ok"] = not (row["incidents_verify"] or row["incidents_reconcile"])
        obs.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run.main(["--device", "cuda", "--replay", rec])
        row["card_replay_exit"] = rc
        ok = (row["events_equal_tokens_masked"] and row["footer_equal"] and row["steps_equal"]
              and row.get("decisions_equal", True) and row.get("incidents_ok", True) and rc == 0)
        row["ok"] = ok
        emit(row)
        if not ok:
            raise AssertionError(f"replicas golden {name}: {row}")


def cell_header(**engine) -> ServeTraceHeader:
    """The full-width cell's header; ``engine`` overrides CELL_ENGINE and
    ``chaos=None`` runs it without chaos."""
    chaos = engine.pop("chaos", CELL_CHAOS)
    return ServeTraceHeader(
        config="qwen3-0.6b", reduced=False, dtype="bfloat16", seed=0, n_replicas=3,
        ranks_per_pod=1, snapshots=True, snapshot_cadence=CELL_SNAPSHOT_CADENCE, layout_seed=0,
        engine=dataclasses.asdict(EngineConfig(**dict(CELL_ENGINE, **engine))),
        workload=CELL_SPEC.to_json(), chaos=chaos or {"kind": "none"},
    )


def cell_run(dev, params, run_name: str, header: ServeTraceHeader, record=None) -> tuple:
    """One run of the full-width cell (the main path: counts reset before,
    read after); emits its row and returns (result, its events as JSON,
    launches).  The engines and their pools are gone when it returns;
    ``mem_at_start_gib`` is what the process held on the card before the
    run (the params among it)."""
    gc.collect()  # earlier phases' objects in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 2 ** 30
    obs.reset()
    reset_launches()
    res, rset = run.run_from_header(header, record_path=record, device=dev, params=params)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = [ev.to_json() for ev in rset.events]
    del rset
    acct = res.accounting
    s = res.summary()
    rounds = max(acct["decode_rounds"], 1)
    emit({"phase": "replicas", "run": run_name, "config": "qwen3-0.6b", "n_layers": 28,
          "dtype": "bfloat16", "replicas": header.n_replicas, "engine": header.engine,
          "chaos": header.chaos, **s, "decode_round_ms": 1e3 * res.decode_wall_s / rounds,
          "snapshot_ms_per_step": 1e3 * res.snapshot_wall_s / max(res.n_steps, 1),
          "snapshot_ms_per_snapshot": 1e3 * res.snapshot_wall_s / max(acct["n_snapshots"], 1),
          "mem_at_start_gib": start, "peak_mem_gib": peak, **acct, "launches": launches})
    for n in ("rmsnorm", "swiglu", "flash_attention"):
        if launches[n] == 0:
            raise AssertionError(f"{run_name}: the run never launched {n}")
    want = ("paged_decode_q8" if header.engine["kv_dtype"] == "int8" else "paged_decode") \
        if header.engine["use_paged_kernel"] else "flash_decode"
    for n in ("paged_decode", "flash_decode", "paged_decode_q8"):
        if (launches[n] > 0) != (n == want):
            raise AssertionError(f"{run_name}: launches {launches}, want decode by {want} only")
    return res, events, launches


def recipe_tag(recipe) -> str:
    """A prefill recipe without its prompts: how the K/V were built."""
    if recipe is None:
        return "none"
    return " ".join(str(x) for x in recipe)


def stream_gate(run_name, res, ref, fails: list) -> dict:
    """Every request served (not shed) emits exactly its reference stream,
    however each run admitted it: a forked prompt is computed by its
    unforked recipe, so its K/V do not depend on the prefix registry it
    met.  The requests whose recipes differ between the runs (batched
    against alone) are counted; every differing request is listed with how
    each run built it, and the gate wants none."""
    served = {rid: rs.emitted for rid, rs in res.states.items() if not rs.shed}
    refs = ref.streams()
    tags = {rid: (recipe_tag(res.states[rid].prefill_recipe),
                  recipe_tag(ref.states[rid].prefill_recipe)) for rid in served}
    unlike = [rid for rid in served if tags[rid][0] != tags[rid][1]]
    differ = [rid for rid in served if served[rid] != refs[rid]]
    done = all(rs.done for rs in res.states.values() if not rs.shed)
    row = {"phase": "replicas", "run": run_name,
           "gate": "every served request's stream equals the reference run's",
           "served": len(served), "shed": len(res.states) - len(served),
           "streams_equal": not differ, "recipes_differ": len(unlike),
           "recipes_differ_equal": sum(served[rid] == refs[rid] for rid in unlike),
           "all_served_done": done,
           "differing_requests": {rid: {"run": tags[rid][0], "reference": tags[rid][1],
                                        "first_differing_token": next(
                                            i for i, (a, b) in enumerate(
                                                zip(served[rid] + [None], refs[rid] + [None]))
                                            if a != b)}
                                  for rid in differ}}
    emit(row)
    if differ or not done:
        fails.append(f"{run_name}: requests {differ} differ from the reference run "
                     f"(all served done: {done})")
    return row


def card_replay(run_name: str, rec: str, fails: list) -> None:
    """The recording replayed on the card through the CLI in process."""
    obs.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run.main(["--device", "cuda", "--replay", rec])
    emit({"phase": "replicas", "run": run_name, "card_replay_exit": rc})
    if rc != 0:
        fails.append(f"{run_name}: the card's replay of its recording exited {rc}")


def slot_rows(eng: ServeEngine, rs: RequestState) -> tuple:
    """The K/V rows below ``rs``'s length in its engine's pages, on the host."""
    slot = eng.slots.index(rs)
    pages, _, cur_len, _ = eng.snapshot_slot(slot)
    return cur_len, [{k: v.reshape(v.shape[0], -1, *v.shape[3:])[:, :cur_len]
                      for k, v in e.items()} for e in pages]


def rows_equal(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def rows_max_abs(a, b) -> float:
    return max(float((x[k].float() - y[k].float()).abs().max()) for x, y in zip(a, b)
               for k in x)


def restore_case(dev, cfg, params, path, ecfg, groups, target, fails: list) -> None:
    """One restore_bitwise row: the ``groups`` of requests admitted a step
    apart, the ``target``-th decoded RESTORE_ROUNDS rounds, then rebuilt in
    fresh engines by the replay path, the snapshot path and (reported) the
    JAX package's batch-1 re-prefill."""
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    states = []
    for t, group in enumerate(groups):
        pairs = []
        for req in group:
            rs = RequestState(req)
            states.append(rs)
            slot, plan, complex_ = eng.try_bind(rs, t)
            if complex_:
                eng.start_prefill(slot, rs, plan, t)
            else:
                pairs.append((slot, rs))
        if pairs:
            eng.prefill_bound(pairs, t)
    rs, t = states[target], len(groups)
    while not rs.emitted:  # the chunked prompt's later chunks
        eng.step_prefills(t)
        t += 1
    snap = None
    for r in range(RESTORE_ROUNDS):
        if r == RESTORE_SNAP_ROUND:
            pages, n_em, cur, nb = eng.snapshot_slot(eng.slots.index(rs))
            snap = KVSnapshot(rs.rid, 1, t, n_em, cur, pages, nb)
        eng.decode_round(t)
        t += 1
    cur_len, want = slot_rows(eng, rs)
    row = {"phase": "replicas", "run": "restore_bitwise", "path": path,
           "recipe": list(rs.prefill_recipe[:1]) + [x for x in rs.prefill_recipe[1:]
                                                    if isinstance(x, int)],
           "prompt_len": len(rs.req.prompt), "cur_len": cur_len}
    for how, snapshot, recipe in (("replay", None, rs.prefill_recipe),
                                  ("snapshot", snap, rs.prefill_recipe),
                                  ("jax_batch1_replay", None, None)):
        other = ServeEngine(cfg, params, ecfg, device=dev)
        rs2 = dataclasses.replace(rs, emitted=list(rs.emitted), prefill_recipe=recipe)
        try:
            got_path, replayed = other.admit_restored(rs2, snapshot, 0)
            got = slot_rows(other, rs2)[1]
            row[how + "_bitwise"] = rows_equal(got, want)
            row[how + "_max_abs"] = rows_max_abs(got, want)
            row[how + "_replayed"] = replayed
        except AssertionError as e:  # the first-token check
            row[how + "_bitwise"] = False
            row[how + "_error"] = str(e)
        del other
    emit(row)
    if not (row["replay_bitwise"] and row["snapshot_bitwise"]):
        fails.append(f"restore_bitwise {path}: {row}")
    del eng
    torch.cuda.empty_cache()


def moe_fork_restore_row(dev, fails: list) -> None:
    """restore_bitwise for an MoE prompt that forked a donor's 128-token
    prefix (reduced qwen3-moe, bf16, the paged round, prefix sharing): its
    recipe is the fork itself, and the replay path rebuilds the donor and
    runs the tail again.  Capacity for every slot (factor 8): a decode
    round restores bitwise only where no slot can be dropped."""
    cfg = reduced(get_config(MOE_CONFIG))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = np.random.default_rng(6)
    prefix = tuple(int(x) for x in gen.integers(0, cfg.vocab_size, 128))

    def prompt(n):
        return prefix + tuple(int(x) for x in gen.integers(0, cfg.vocab_size, n - len(prefix)))

    ecfg = EngineConfig(max_slots=8, page_size=16, pages_per_slot=64, use_paged_kernel=True,
                        prefix_sharing=True)
    restore_case(dev, cfg, params, "forked, moe", ecfg,
                 [[Request(0, 0, prompt(300), 16)], [Request(1, 0, prompt(260), 16)]], 1, fails)
    del params


def restore_bitwise_rows(dev, cfg, params, fails: list) -> None:
    """(c) One request admitted by each path at the cell's shapes, rebuilt
    in fresh engines by the replay path (its prefill recipe) and by the
    snapshot path (a snapshot RESTORE_SNAP_ROUND rounds in, then the
    teacher-forced tail): the K/V rows below its length bitwise equal the
    original's.  The JAX package's batch-1 re-prefill is reported beside."""
    gen = np.random.default_rng(5)
    prefix = tuple(int(x) for x in gen.integers(0, cfg.vocab_size, 128))

    def prompt(n, head=()):
        return head + tuple(int(x) for x in gen.integers(0, cfg.vocab_size, n - len(head)))

    base = EngineConfig(**CELL_ENGINE)
    cases = {  # path: (engine, [(request, admitted in group)], target index)
        "alone": (base, [[Request(0, 0, prompt(300), 16)]], 0),
        "batched": (base, [[Request(0, 0, prompt(300), 16), Request(1, 0, prompt(290), 16)]], 1),
        "forked": (base, [[Request(0, 0, prompt(300, prefix), 16)],
                          [Request(1, 0, prompt(260, prefix), 16)]], 1),
        "chunked": (dataclasses.replace(base, prefill_chunk_pages=CHUNK_PAGES),
                    [[Request(0, 0, prompt(300), 16)]], 0),
    }
    for path, (ecfg, groups, target) in cases.items():
        restore_case(dev, cfg, params, path, ecfg, groups, target, fails)
    moe_fork_restore_row(dev, fails)
    # fork against whole: a prompt that forks a donor's 128-token prefix
    # holds bitwise the rows it gets admitted with no prefix registry.
    # Unchunked: the donor a 300-token prompt; chunked (CHUNK_PAGES-page
    # chunks, 128 tokens): the donor the bare prefix, prefilled whole, and
    # the prompt chunked when unforked
    for label, ecfg, donor in (
            ("fork against whole", base, prompt(300, prefix)),
            ("fork against whole, chunked",
             dataclasses.replace(base, prefill_chunk_pages=CHUNK_PAGES), prefix)):
        target = prompt(260, prefix)
        got = {}
        for how, e in (("forked", ecfg), ("unforked", dataclasses.replace(ecfg, prefix_sharing=False))):
            eng = ServeEngine(cfg, params, e, device=dev)
            states = [RequestState(Request(i, 0, p, 4))
                      for i, p in enumerate((donor, target) if how == "forked" else (target,))]
            queue, t = list(states), 0
            while queue or eng._pending:
                eng.step_prefills(t)
                if queue:
                    rs = queue.pop(0)
                    slot, plan, complex_ = eng.try_bind(rs, t)
                    if complex_:
                        eng.start_prefill(slot, rs, plan, t)
                    else:
                        eng.prefill_bound([(slot, rs)], t)
                t += 1
            got[how] = (slot_rows(eng, states[-1])[1], states[-1].emitted[0],
                        eng.drain_stats()["n_prefix_hits"], states[-1].prefill_recipe)
            del eng
        (a, ta, hits, recipe), (b, tb, _, recipe_b) = got["forked"], got["unforked"]
        row = {"phase": "replicas", "run": "restore_bitwise", "path": label,
               "prompt_len": len(target), "donor_len": len(donor), "prefix_hits": hits,
               "recipe": list(recipe), "recipe_unforked": list(recipe_b),
               "pages_bitwise": rows_equal(a, b), "max_abs": rows_max_abs(a, b),
               "first_token_equal": ta == tb}
        emit(row)
        if not (hits == 1 and row["pages_bitwise"] and row["first_token_equal"]):
            fails.append(f"restore_bitwise {label}: {row}")
        torch.cuda.empty_cache()
    # reported, not gated: two whole-prompt prefills of prompts that share
    # the 128-token prefix, alone, give the prefix's K/V rows bitwise
    # alike, so a fork's donor rows equal the forker's own
    eng = ServeEngine(cfg, params, base, device=dev)
    rows = [eng._prefill_rows([p])[0] for p in (prompt(300, prefix), prompt(260, prefix))]
    a, b = ([{k: v[:, :, :len(prefix)] for k, v in e.items()} for e in d] for d in rows)
    emit({"phase": "replicas", "run": "restore_bitwise", "path": "prefix rows of two prompts",
          "prompt_lens": [300, 260], "prefix": len(prefix),
          "prefix_rows_bitwise": rows_equal(a, b), "max_abs": rows_max_abs(a, b)})
    del eng, rows, a, b


def replicas_phase(dev) -> int:
    """Phase 11; returns the int8 walk's launches in the int8 cell's chaos
    run."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_replicas_")
    fails: list = []  # every gate is read before the phase fails
    try:
        golden_rows(dev, tmp)
        cfg, params = run.build("qwen3-0.6b", device=dev, seed=0)
        restore_bitwise_rows(dev, cfg, params, fails)
        ref, _, _ = cell_run(dev, params, "cell paged reference (no chaos, full reserve)",
                             cell_header(chaos=None, n_pages=0))
        rec = os.path.join(tmp, "cell.jsonl")
        res, paged_events, _ = cell_run(dev, params, "cell paged chaos", cell_header(),
                                        record=rec)
        acct = res.accounting
        counts = {k: acct[k] for k in ("n_restore_snapshot", "n_restore_replay",
                                       "n_preemptions", "n_shed", "n_kills", "n_spikes")}
        emit({"phase": "replicas", "run": "cell paged chaos", "counts": counts})
        if not all(counts.values()):
            fails.append(f"cell chaos: counts {counts}, want every one >= 1")
        stream_gate("cell paged chaos", res, ref, fails)
        card_replay("cell paged chaos", rec, fails)
        dense, dense_events, _ = cell_run(dev, params, "cell dense chaos",
                                          cell_header(use_paged_kernel=False))
        stream_gate("cell dense chaos", dense, ref, fails)
        same = dense_events == paged_events
        emit({"phase": "replicas", "run": "cell dense chaos", "events_equal_paged": same})
        if not same:
            fails.append("cell dense chaos: events differ from the paged run's")
        q8 = dict(kv_dtype="int8", prefix_sharing=False)
        q8_ref, _, _ = cell_run(dev, params, "cell int8 reference (no chaos, full reserve)",
                                cell_header(chaos=None, n_pages=0, **q8))
        rec8 = os.path.join(tmp, "cell_int8.jsonl")
        q8_res, _, q8_launches = cell_run(dev, params, "cell int8 chaos",
                                          cell_header(**q8), record=rec8)
        stream_gate("cell int8 chaos", q8_res, q8_ref, fails)
        card_replay("cell int8 chaos", rec8, fails)
        pairs = [(a, b) for rid, rs in q8_ref.states.items()
                 for a, b in zip(rs.emitted, ref.states[rid].emitted)]
        bf16_pages = init_pool(cfg, 1, PS, torch.bfloat16, dev)
        q8_pages = init_pool(cfg, 1, PS, torch.bfloat16, dev, kv_dtype="int8")
        emit({"phase": "replicas", "run": "cell int8 vs bf16 (reported)",
              "page_nbytes": {"int8": page_nbytes(q8_pages), "bfloat16": page_nbytes(bf16_pages)},
              "kv_bytes_paged": {"int8": q8_ref.accounting["kv_bytes_paged"],
                                 "bfloat16": ref.accounting["kv_bytes_paged"]},
              "token_share_equal_bf16": sum(a == b for a, b in pairs) / max(len(pairs), 1)})
        del params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "replicas", "run": "phase", "seconds": time.perf_counter() - t0,
          "failed": fails})
    if fails:
        raise AssertionError("replicas phase: " + "; ".join(fails))
    return q8_launches["paged_decode_q8"]

# ---------------------------------------------------------------------------
# phases 12-14: MoE and the other attention configs
# ---------------------------------------------------------------------------


def free_card(phase: str, need_gib: float) -> None:
    """Free earlier phases' objects; fail with a clear message when the card
    has less than ``need_gib`` free (never fall back to a smaller model)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": phase, "card_free_gib": free / 2 ** 30, "card_total_gib": total / 2 ** 30,
          "held_gib": torch.cuda.memory_allocated() / 2 ** 30, "need_gib": need_gib})
    if free < need_gib * 2 ** 30:
        raise AssertionError(f"{phase}: {free / 2 ** 30:.2f} GiB free on the card, "
                             f"the phase needs {need_gib:.2f}")


def params_gib(cfg) -> float:
    return count_params(cfg) * torch.finfo(getattr(torch, cfg.dtype)).bits / 8 / 2 ** 30


@contextlib.contextmanager
def routing_log():
    """Record every MoE layer's expert ids (T, k), in their top-k order,
    while the block runs."""
    log = []
    orig = moe_mod.route

    def rec(xt, router, top_k):
        out = orig(xt, router, top_k)
        log.append(out[2].detach().clone())
        return out

    moe_mod.route = rec
    try:
        yield log
    finally:
        moe_mod.route = orig


def routing_differs(a: list, b: list) -> tuple:
    """(top-k decisions that differ, decisions) between two routing logs."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError("the two paths routed different token counts")
    n = sum(x.shape[0] for x in a)
    return sum(int((x.sort(dim=-1).values != y.sort(dim=-1).values).any(dim=-1).sum())
               for x, y in zip(a, b)), n


@contextlib.contextmanager
def forced_routing(ids_log: list):
    """Every MoE layer takes the expert ids of ``ids_log`` (another run's
    ``routing_log``, call for call) in place of its own top-k, its gates a
    softmax over its own logits at those ids.  Yields ``[decisions its own
    top-k would have made differently, decisions]``."""
    orig = moe_mod.route
    it = iter(ids_log)
    count = [0, 0]

    def forced(xt, router, top_k):
        logits, _, own = orig(xt, router, top_k)
        ids = next(it)
        if ids.shape != own.shape:
            raise AssertionError("the two runs routed different token counts")
        count[0] += int((own.sort(dim=-1).values != ids.sort(dim=-1).values).any(dim=-1).sum())
        count[1] += own.shape[0]
        return logits, torch.softmax(logits.gather(1, ids), dim=-1), ids

    moe_mod.route = forced
    try:
        yield count
    finally:
        moe_mod.route = orig


def f32_logit_row(phase: str, name: str, dev, prompts, layers: int) -> dict:
    """Kernel path against plain path at f32 on a ``layers``-layer
    full-width copy (seed 1): max |Δ| of the logits <= F32_PATH_TOL and, for
    MoE, every routing decision equal."""
    cfg, params = run.build(name, device=dev, layers=layers, dtype="float32", seed=1)
    with routing_log() as k_route:
        k_logits, fed = path_logits(params, cfg, prompts, MOE_LOGIT_STEPS)
    with plain_versions(), routing_log() as p_route:
        p_logits, _ = path_logits(params, cfg, prompts, MOE_LOGIT_STEPS, forced=fed)
    max_err = float((k_logits - p_logits).abs().max())
    flips, n = routing_differs(k_route, p_route)
    ok = max_err <= F32_PATH_TOL and flips == 0 and bool(torch.isfinite(k_logits).all())
    row = {"phase": phase, "config": name, "dtype": "float32", "n_layers": layers,
           "steps": 1 + len(fed), "max_abs_err": max_err,
           "max_abs_logit": float(p_logits.abs().max()), "routing_decisions": n,
           "routing_decisions_differ": flips, "limit": {"max_abs_err <=": F32_PATH_TOL,
                                                       "routing_decisions_differ": 0},
           "ok": ok}
    emit(row)
    del params
    if not ok:
        raise AssertionError(f"{phase} {name} f32 path parity failed: {row}")
    return row


def new_shape_rows(dev, timer) -> None:
    """Kernel rows at the shapes phases 12-14 launch, in bf16, each against
    its plain version with its cold time, bound and library call: #3 over
    a 512-token prefill's rows at d 2048 (qwen3-moe), 6144 (granite's
    warp-a-row branch) and 18432 (nemotron's wide branch); #4 over the
    expert buffers of a decode round (128 experts x 8 places) and of a
    512-token prefill (x 40); #2 at qwen3-moe's heads (H 32, KV 4) on a
    512-token prompt."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(20)
    dt, es = torch.bfloat16, 2

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    for d in NEW_NORM_WIDTHS:
        x, s_ = randn(NEW_ROWS, d), randn(d)
        lib = (lambda x=x, s_=s_, d=d: F.rms_norm(x, (d,), s_, 1e-5))
        compare("rmsnorm", dt, [NEW_ROWS, d], rmsnorm(x, s_, 1e-5), rmsnorm_plain(x, s_, 1e-5),
                timer, lambda: rmsnorm(x, s_, 1e-5), lambda: rmsnorm_plain(x, s_, 1e-5),
                2 * x.numel() * es + d * es, 4.0 * x.numel(), lib)
        turns("rmsnorm", [NEW_ROWS, d], timer, lambda: rmsnorm(x, s_, 1e-5), lib)
    for rows_ in NEW_SWIGLU_ROWS:
        g, u = randn(rows_, 768), randn(rows_, 768)
        compare("swiglu", dt, [rows_, 768], swiglu(g, u), swiglu_plain(g, u), timer,
                lambda: swiglu(g, u), lambda: swiglu_plain(g, u), 3 * g.numel() * es,
                5.0 * g.numel())
    S, H_, KV_ = NEW_ROWS, 32, 4
    q, k, v = randn(1, S, H_, HD), randn(1, S, KV_, HD), randn(1, S, KV_, HD)
    pairs = H_ * S * (S + 1) // 2
    compare("flash_attention", dt, [1, S, H_, KV_, HD], flash_attention(q, k, v),
            flash_attention_plain(q, k, v), timer, lambda: flash_attention(q, k, v),
            lambda: flash_attention_plain(q, k, v), 2 * nbytes(q) + 2 * nbytes(k),
            4.0 * HD * pairs, sdpa_call(q, k, v))
    turns("flash_attention", [1, S, H_, KV_, HD], timer, lambda: flash_attention(q, k, v),
          sdpa_call(q, k, v))


def moe_serve_phase(dev) -> dict:
    """Phase 12; returns the paged run's launches with the dense run's #5."""
    t0 = time.perf_counter()
    new_shape_rows(dev, ColdTimer(dev))
    cfg = get_config(MOE_CONFIG)
    free_card("moe serve", params_gib(cfg) + 6)
    cfg, params = run.build(MOE_CONFIG, device=dev, seed=0)
    init_s = time.perf_counter() - t0
    workload = build_workload(dataclasses.replace(SPEC, vocab_size=cfg.vocab_size))
    moe = cfg.moe
    # the reference's grouped product reads every expert's weights each round
    expert_bytes = cfg.n_layers * moe.n_experts * 3 * cfg.d_model * moe.d_ff_expert * 2
    floor_ms = 1e3 * expert_bytes / HBM_BYTES_PER_S
    eng, res, launches, peak = serve_run(dev, cfg, params, PAGED_ECFG, workload)
    check_serve("moe serve", cfg, PAGED_ECFG, workload, eng, res, launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "paged_decode"),
                n_params=count_params(cfg), n_params_active=count_params(cfg, active_only=True),
                params_gib=params_gib(cfg), init_s=init_s,
                expert_weight_bytes_per_round=expert_bytes, weight_read_floor_ms=floor_ms)
    paged_streams = res.streams()
    del eng, res
    alone_row("moe serve", dev, cfg, params, PAGED_ECFG, workload, paged_streams)
    eng, res, dense_launches, peak = serve_run(dev, cfg, params, ECFG, workload)
    same = res.streams() == paged_streams
    check_serve("moe serve dense", cfg, ECFG, workload, eng, res, dense_launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "flash_decode"),
                streams_equal_paged=same, weight_read_floor_ms=floor_ms)
    if not same:
        raise AssertionError("moe serve dense: token streams differ from the paged round's")
    del eng, res
    launches["flash_decode"] = dense_launches["flash_decode"]
    # bf16 at full depth: reported, not gated
    prompts = [list(workload[0].prompt), list(workload[1].prompt)]
    with routing_log() as k_route:
        k_logits, fed = path_logits(params, cfg, prompts, MOE_LOGIT_STEPS)
    with plain_versions(), routing_log() as p_route:
        p_logits, _ = path_logits(params, cfg, prompts, MOE_LOGIT_STEPS, forced=fed)
    flips, n = routing_differs(k_route, p_route)
    emit({"phase": "moe serve parity", "dtype": "bfloat16", "n_layers": cfg.n_layers,
          "steps": 1 + len(fed), "max_abs_err": float((k_logits - p_logits).abs().max()),
          "mean_abs_err": float((k_logits - p_logits).abs().mean()),
          "max_abs_logit": float(p_logits.abs().max()), "routing_decisions": n,
          "routing_decisions_differ": flips, "routing_share_differ": flips / max(n, 1),
          "gated": False})
    del k_logits, p_logits, k_route, p_route
    # where the device time goes, by part (a few requests, a few tokens
    # each: the profiler's post-processing grows with the events)
    short = [dataclasses.replace(r, max_new_tokens=MOE_PROFILE_TOKENS)
             for r in workload[:MOE_PROFILE_REQUESTS]]
    t1 = time.perf_counter()
    prof = profile_serve(ServeEngine(cfg, params, PAGED_ECFG, device=dev), short)
    emit({"phase": "moe serve profile", "requests": MOE_PROFILE_REQUESTS,
          "new_tokens": MOE_PROFILE_TOKENS, "weight_read_floor_ms": floor_ms,
          "profile_s": time.perf_counter() - t1, **prof})
    del params
    free_card("moe serve f32", 0)
    f32_logit_row("moe serve parity", MOE_CONFIG, dev, prompts, MOE_LOGIT_LAYERS)
    emit({"phase": "moe serve", "run": "phase", "seconds": time.perf_counter() - t0})
    return launches


def dense_serve_phase(dev) -> dict:
    """Phase 13: short paged serve runs of the dense configs at full width,
    each with its f32 logits row on min(4, its depth) layers.  Returns the
    launches summed over the runs."""
    total = {n: 0 for n in SERVE_KERNELS}
    for name, layers in DENSE_SERVE:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        free_card(f"dense serve {name}", params_gib(cfg) + 4)
        cfg, params = run.build(name, device=dev, layers=layers, seed=0)
        workload = build_workload(WorkloadSpec(vocab_size=cfg.vocab_size, **DENSE_SPEC))
        eng, res, launches, peak = serve_run(dev, cfg, params, PAGED_ECFG, workload)
        must = ("rmsnorm", "flash_attention", "paged_decode") + (
            ("swiglu",) if cfg.ffn_act == "swiglu" else ())
        check_serve(f"dense serve {name}", cfg, PAGED_ECFG, workload, eng, res, launches, peak,
                    must, ffn_act=cfg.ffn_act, heads=[cfg.n_heads, cfg.n_kv_heads,
                                                      cfg.resolved_head_dim],
                    n_params=count_params(cfg))
        for n in SERVE_KERNELS:
            total[n] += launches[n]
        prompts = [list(workload[0].prompt), list(workload[1].prompt)]
        del eng, res, params
        free_card(f"dense serve {name} f32", 0)
        f32_logit_row(f"dense serve {name}", name, dev, prompts, min(4, cfg.n_layers))
        emit({"phase": f"dense serve {name}", "run": "phase",
              "seconds": time.perf_counter() - t0})
    return total


def leaf_names(params) -> list:
    """Names of a params tree's leaves in ``tree_leaves`` order
    (``layers`` leaves as ``part.name``)."""
    out = []
    for key in sorted(params):
        if key == "layers":
            for blk in params["layers"]:
                out += [f"{part}.{name}" for part in sorted(blk) for name in sorted(blk[part])]
        else:
            out.append(key)
    return out


def seeded_with_proj(dev, cfg, rank: int, seed: int = 0) -> tuple:
    """(params from ``seed``, their V1, the refresh's seconds)."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proj = refresh_projections(params, cfg, rank)
    torch.cuda.synchronize()
    return params, proj, time.perf_counter() - t0


def config_step(dev, cfg, mode: str, B: int, S: int, steps: int, rank: int, plan,
                base=None) -> dict:
    """``steps`` MeCeFO steps of ``cfg`` in ``mode`` through
    ``make_train_step`` (bf16 params, f32 AdamW, FFN recompute); one row
    with the losses, aux, step ms, peak memory, launches.  ``base``
    (params, V1, refresh seconds) is copied; by default it is seeded and
    refreshed here."""
    train = TrainConfig()
    mecefo = MeCeFOConfig(mode="dynamic", rank=rank)
    shape = ShapeConfig("chip", S, B, "train")
    if base is None:
        params, proj, svd_s = seeded_with_proj(dev, cfg, rank)
    else:
        params, proj, svd_s = tree_map(lambda t: t.clone(), base[0]), base[1], base[2]
    state = TrainState(step=0, params=params, opt=init_opt_state(params, train), proj=proj)
    keep, w = plan_to_masks(plan, cfg, B)
    step = make_train_step(cfg, train, mecefo, shape, ndb_mode=mode,
                           static_ndb=(keep, w) if mode == "static" else None,
                           flags=TRAIN_FLAGS, device=dev)
    ndb = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
    batches = [make_batch(cfg, shape, i) for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launches()
    losses, auxs, times = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i], *ndb)
        losses.append(float(metrics["loss"]))
        auxs.append(float(metrics["aux"]))
        gnorm = float(metrics["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
    want = train_launches_per_step(cfg, mode, TRAIN_FLAGS, mecefo)
    ok = (launches == {n: c * steps for n, c in want.items()}
          and bool(np.isfinite([*losses, *auxs, gnorm]).all()))
    row = {"config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "mode": mode,
           "batch": B, "seq_len": S, "rank": rank, "remat": TRAIN_FLAGS.remat,
           "n_params": count_params(cfg), "losses": losses, "aux": auxs,
           "last_grad_norm": gnorm, "step_ms": [1e3 * t for t in times],
           "step_ms_median": 1e3 * sorted(times)[len(times) // 2],
           "tokens_per_s": B * S / min(times), "peak_mem_gib": peak / 2 ** 30,
           "peak_above_state_gib": (peak - base_mem) / 2 ** 30, "svd_refresh_s": svd_s,
           "launches": launches, "want_launches_per_step": want, "ok": ok}
    del state, params, proj, step
    return row


def moe_f32_grad_rows(params, proj, batch, cfg32, keep, w, names, dev) -> None:
    """The tight gate of phase 14: the same step in f32 (the bf16 weights
    and V1 upcast), kernels against plain versions in the four modes, every
    leaf within TRAIN_PARITY_TOL["float32"], as ``train_parity_phase``
    holds llama.  Routing is held equal (``grad_parity_row``): over 4 x
    4096 tokens a few f32 near-ties of the 8th and 9th expert swap, and one
    swap moves later tokens through attention."""
    up = lambda t: t.float()  # noqa: E731
    p32, v32 = tree_map(up, params), tree_map(up, proj)
    for mode in TRAIN_MODES:
        grad_parity_row("moe train parity", cfg32, p32, v32, batch,
                        parity_ctx(mode, keep, w, dev), names, mode,
                        *TRAIN_PARITY_TOL["float32"], batch=MOE_TRAIN_B, seq_len=MOE_TRAIN_S)
        torch.cuda.empty_cache()
    del p32, v32


def moe_train_phase(dev) -> dict:
    """Phase 14: qwen3-moe MeCeFO steps in the four NDB modes (after a
    bf16 gradient parity row per mode, which also reads each mode's forward
    and backward peak: degraded's must lie below off's, and an f32 row per
    mode with routing equal), then one degraded step each of CONFIG_STEPS.
    Returns the launches summed over its steps."""
    t0 = time.perf_counter()
    total = {n: 0 for n in TRAIN_KERNELS}
    cfg = dataclasses.replace(get_config(MOE_CONFIG), n_layers=MOE_TRAIN_LAYERS)
    free_card("moe train", 6 * params_gib(cfg) + 8)
    # V1 refreshed once (3 x layers x 128 expert SVDs), for every row
    params, proj, svd_s = seeded_with_proj(dev, cfg, TRAIN_RANK)
    emit({"phase": "moe train", "config": cfg.name, "n_layers": cfg.n_layers,
          "svd_refresh_s": svd_s, "svds": 3 * cfg.n_layers * cfg.moe.n_experts,
          "matrix": [cfg.d_model, cfg.moe.d_ff_expert]})
    # gradient parity: bf16 kernels and bf16 plain against the f32 plain step
    keep, w = plan_to_masks(MOE_TRAIN_PLAN, cfg, MOE_TRAIN_B)
    batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, MOE_TRAIN_B, MOE_TRAIN_S), dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    up = lambda t: t.float()  # noqa: E731
    fb_peaks = {}
    names = leaf_names(params)
    for mode in TRAIN_MODES:
        ctx = parity_ctx(mode, keep, w, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with routing_log() as k_route:
            lk, mk, gk = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
        torch.cuda.synchronize()
        fb_peaks[mode] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        with plain_versions(), routing_log() as p_route:
            lp, _, gp = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
        with plain_versions():
            l32, _, g32 = loss_and_grads(tree_map(up, params), tree_map(up, proj), batch,
                                         cfg32, ctx, TRAIN_FLAGS)
        # the first forward's routing (the FFN recompute routes again)
        flips, n_dec = routing_differs(k_route[:cfg.n_layers], p_route[:cfg.n_layers])
        rel = leaf_rel_errs(gk, gp)
        rel_k, rel_p = leaf_rel_errs(gk, g32), leaf_rel_errs(gp, g32)
        to_k, to_p = max(rel_k), max(rel_p)
        tol, loss_tol = TRAIN_PARITY_TOL["bfloat16"]
        loss_err = abs(float(lk) - float(lp))
        finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk))
        # the gate: finite, the loss at the train phase's limit, and the
        # kernels no farther from the f32 step than TRAIN_ANCHOR_RATIO times
        # the plain bf16 path.  The kernels-vs-plain leaf limit is reported:
        # a bf16 ulp in a router input swaps experts, and a swapped token
        # moves its experts' and the router's gradients by its whole share
        ok = (finite and loss_err <= loss_tol * abs(float(lp))
              and to_k <= TRAIN_ANCHOR_RATIO * to_p)
        row = {"phase": "moe train parity", "config": cfg.name, "n_layers": cfg.n_layers,
               "mode": mode, "batch": MOE_TRAIN_B, "seq_len": MOE_TRAIN_S,
               "loss_kernels": float(lk), "loss_plain": float(lp), "loss_f32": float(l32),
               "aux_kernels": float(mk["aux"]), "fwd_bwd_peak_above_held_gib": fb_peaks[mode],
               "routing_decisions": n_dec, "routing_decisions_differ_kernels_vs_plain": flips,
               "max_leaf_rel_err": max(rel), "max_leaf": names[rel.index(max(rel))],
               "max_leaf_vs_f32": names[rel_k.index(to_k)],
               "max_leaf_rel_err_non_moe": max(r for r, nm in zip(rel, names)
                                               if not nm.startswith("ffn.")),
               "max_leaf_rel_err_kernels_vs_f32": to_k, "max_leaf_rel_err_plain_vs_f32": to_p,
               "leaf_limit_rel_reported": tol, "loss_limit_rel": loss_tol,
               "anchor_ratio_limit": TRAIN_ANCHOR_RATIO, "grads_finite": finite, "ok": ok}
        emit(row)
        if not ok:
            raise AssertionError(f"moe train parity {mode} failed: {row}")
        del gk, gp, g32
        torch.cuda.empty_cache()
    moe_f32_grad_rows(params, proj, batch, cfg32, keep, w, names, dev)
    del batch
    emit({"phase": "moe train parity", "fwd_bwd_peak_above_held_gib": fb_peaks,
          "degraded_below_off": fb_peaks["degraded"] < fb_peaks["off"]})
    if not fb_peaks["degraded"] < fb_peaks["off"]:
        raise AssertionError(f"moe train: degraded forward-backward peak {fb_peaks['degraded']}"
                             f" GiB not below off's {fb_peaks['off']}")
    peaks = {}
    for mode in TRAIN_MODES:
        free_card("moe train", 0)
        row = config_step(dev, cfg, mode, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS,
                          TRAIN_RANK, MOE_TRAIN_PLAN, base=(params, proj, svd_s))
        emit({"phase": "moe train", **row})
        if not row["ok"]:
            raise AssertionError(f"moe train {mode}: {row}")
        peaks[mode] = row["peak_mem_gib"]
        for n in TRAIN_KERNELS:
            total[n] += row["launches"][n]
    # reported: the step's peak is AdamW's update over the expert stack,
    # the same in every mode
    emit({"phase": "moe train", "step_peak_mem_gib": peaks})
    del params, proj
    for name, layers in CONFIG_STEPS:
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        free_card(f"config step {name}", 6 * params_gib(cfg) + 8)
        row = config_step(dev, cfg, "degraded", MOE_TRAIN_B, MOE_TRAIN_S, 1, TRAIN_RANK,
                          MOE_TRAIN_PLAN)
        emit({"phase": "config step", "frontend": cfg.frontend, "ffn_act": cfg.ffn_act, **row})
        if not row["ok"]:
            raise AssertionError(f"config step {name}: {row}")
        for n in TRAIN_KERNELS:
            total[n] += row["launches"][n]
    emit({"phase": "moe train", "run": "phase", "seconds": time.perf_counter() - t0})
    return total


# ---------------------------------------------------------------------------
# phases 15-17: the SSM mixer; gradient accumulation and the dots remat
# ---------------------------------------------------------------------------


def ssm_kernel_rows(dev, timer) -> dict:
    """Kernel rows at mamba2's new shapes over one step's SSM_TRAIN_B x
    SSM_TRAIN_S rows, in bf16: #3 at d_model 2560 and d_inner 5120 (the
    gate norm), each against its plain version and in turns against
    F.rms_norm; #6 at in_proj's and out_proj's (T, n, m, 64), each against
    its plain version and in turns against multi_dot; then the zero-width
    FFN's calls (#4 on (T, 0), #6 with m = 0 and with n = 0, both r = 0)
    launch nothing and return empty or zero results.  Returns the zero
    calls' launches (0 each)."""
    import torch.nn.functional as F

    cfg = get_config(SSM_CONFIG)
    d, ssm = cfg.d_model, cfg.ssm
    d_inner = ssm.expand * d
    nh = d_inner // ssm.head_dim
    d_in_proj = 2 * d_inner + 2 * ssm.d_state + nh
    T = SSM_TRAIN_B * SSM_TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(21)
    dt, es = torch.bfloat16, 2

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    for width in (d, d_inner):
        x, s_ = randn(T, width), randn(width)
        lib = (lambda x=x, s_=s_, w=width: F.rms_norm(x, (w,), s_, 1e-5))
        compare("rmsnorm", dt, [T, width], rmsnorm(x, s_, 1e-5), rmsnorm_plain(x, s_, 1e-5),
                timer, lambda: rmsnorm(x, s_, 1e-5), lambda: rmsnorm_plain(x, s_, 1e-5),
                2 * x.numel() * es + width * es, 4.0 * x.numel(), lib)
        turns("rmsnorm", [T, width], timer, lambda: rmsnorm(x, s_, 1e-5), lib)
    for n, m in ((d, d_in_proj), (d_inner, d)):
        r = TRAIN_RANK
        x, dy, v1 = randn(T, n), randn(T, m), randn(n, r)
        compare_rel("lowrank_wgrad", dt, [T, n, m, r], lowrank_wgrad_project(x, dy, v1),
                    lowrank_wgrad_project_plain(x, dy, v1), timer,
                    lambda: lowrank_wgrad_project(x, dy, v1),
                    lambda: lowrank_wgrad_project_plain(x, dy, v1),
                    nbytes(x, dy, v1) + r * m * 4, 2.0 * T * r * (n + m),
                    lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
        turns("lowrank_wgrad", [T, n, m, r], timer, lambda: lowrank_wgrad_project(x, dy, v1),
              lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
    before = {n: WRAPPERS[n].launches for n in WRAPPERS}
    g0 = randn(T, 0)
    outs = {"swiglu (T, 0)": swiglu(g0, g0), "swiglu_bwd (T, 0)": swiglu_bwd(g0, g0, g0)[0],
            "lowrank_wgrad m 0": lowrank_wgrad_project(randn(T, d), randn(T, 0), randn(d, 0)),
            "lowrank_wgrad n 0": lowrank_wgrad_project(randn(T, 0), randn(T, d), randn(0, 0))}
    torch.cuda.synchronize()
    launched = {n: WRAPPERS[n].launches - before[n] for n in WRAPPERS}
    shapes = {k: list(v.shape) for k, v in outs.items()}
    ok = (not any(launched.values()) and shapes["swiglu (T, 0)"] == [T, 0]
          and shapes["swiglu_bwd (T, 0)"] == [T, 0]
          and shapes["lowrank_wgrad m 0"] == [0, 0] and shapes["lowrank_wgrad n 0"] == [0, d])
    emit({"phase": "kernels", "run": "zero-element calls", "shapes": shapes,
          "launches": launched, "ok": ok})
    if not ok:
        raise AssertionError(f"zero-element calls launched {launched} or gave {shapes}")
    return launched


def ssm_tp_kernel_rows(dev, timer) -> dict:
    """#3's split form at mamba2's gate_norm cut over M = 2 (2560 of 5120
    channels a row): the rows of phase 19 (e)'s step (SSM_TP_T) and of
    phase 20's decode (MS_B), each pass against its plain version in bf16
    and f32 with its cold time and bound (no single PyTorch call norms a
    cut row), and the two passes over the two halves equal to the whole
    row's plain norm; #6 at in_proj's local (SSM_TP_T, 2560, 5416, 64)
    against its plain version and in turns against multi_dot.  Returns
    the bf16 rows of the two passes at the step's rows, for the kernels
    line."""
    cfg = get_config(SSM_CONFIG)
    d, ssm = cfg.d_model, cfg.ssm
    d_inner, M = ssm.expand * d, 2
    local = d_inner // M
    w_local = 2 * local + 2 * ssm.d_state + d_inner // ssm.head_dim // M
    gen = torch.Generator(device=dev).manual_seed(26)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        es = torch.finfo(dt).bits // 8

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        for T in (SSM_TP_T, MS_B):
            x, other, sc = randn(T, local), randn(T, local), randn(local)
            extra = dict(d_whole=d_inner, path="model axis")
            r1 = compare("rmsnorm_sumsq", dt, [T, local], rmsnorm_sumsq(x),
                         rmsnorm_sumsq_plain(x), timer, lambda: rmsnorm_sumsq(x),
                         lambda: rmsnorm_sumsq_plain(x), x.numel() * es + T * 4,
                         2.0 * x.numel(), None, ops_dtype=torch.float32, **extra)
            ss = rmsnorm_sumsq_plain(x) + rmsnorm_sumsq_plain(other)  # the model group's sum
            y = rmsnorm_apply(x, ss, sc, d_inner, 1e-5)
            r2 = compare("rmsnorm_apply", dt, [T, local], y,
                         rmsnorm_apply_plain(x, ss, sc, d_inner, 1e-5), timer,
                         lambda: rmsnorm_apply(x, ss, sc, d_inner, 1e-5),
                         lambda: rmsnorm_apply_plain(x, ss, sc, d_inner, 1e-5),
                         2 * x.numel() * es + T * 4 + local * es, 2.0 * x.numel() + T, None,
                         ops_dtype=torch.float32, **extra)
            # the split passes against the whole row's plain norm (scale 1 on the other half)
            whole = rmsnorm_plain(torch.cat([x, other], 1),
                                  torch.cat([sc, torch.ones_like(sc)]), 1e-5)[:, :local]
            atol, rtol = TOL[dt]
            err = float((y.float() - whole.float()).abs().max())
            ok = bool(((y.float() - whole.float()).abs()
                       <= atol + rtol * whole.float().abs()).all())
            emit({"phase": "kernels", "kernel": "rmsnorm split", "dtype": r2["dtype"],
                  "shape": [T, local], "d_whole": d_inner, "max_abs_err_vs_whole_row": err,
                  "atol": atol, "rtol": rtol, "ok": ok})
            if not ok:
                raise AssertionError(f"rmsnorm split {dt} {[T, local]}: {err} from the whole row")
            if dt == torch.bfloat16 and T == SSM_TP_T:
                out[("rmsnorm_sumsq", dt)], out[("rmsnorm_apply", dt)] = r1, r2
            del x, other, sc, ss, y, whole
        r = TRAIN_RANK
        xx, dy, v1 = randn(SSM_TP_T, d), randn(SSM_TP_T, w_local), randn(d, r)
        compare_rel("lowrank_wgrad", dt, [SSM_TP_T, d, w_local, r],
                    lowrank_wgrad_project(xx, dy, v1), lowrank_wgrad_project_plain(xx, dy, v1),
                    timer, lambda: lowrank_wgrad_project(xx, dy, v1),
                    lambda: lowrank_wgrad_project_plain(xx, dy, v1),
                    nbytes(xx, dy, v1) + r * w_local * 4, 2.0 * SSM_TP_T * r * (d + w_local),
                    lambda: torch.linalg.multi_dot([v1.T, xx.T, dy]))
        if dt == torch.bfloat16:
            turns("lowrank_wgrad", [SSM_TP_T, d, w_local, r], timer,
                  lambda: lowrank_wgrad_project(xx, dy, v1),
                  lambda: torch.linalg.multi_dot([v1.T, xx.T, dy]), path="model axis")
        del xx, dy, v1
    return out


def grad_parity_row(phase, cfg, params, proj, inputs, ctx, names, mode, tol, loss_tol,
                    **extra) -> dict:
    """One step's loss and gradients through the kernels and the plain
    versions (TRAIN_FLAGS), every leaf within ``tol`` of the plain one
    (||Δ|| / ||g||), the loss within ``loss_tol``; MoE layers' routing held
    equal (the plain run takes the kernel run's expert ids)."""
    with routing_log() as k_route:
        lk, _, gk = loss_and_grads(params, proj, inputs, cfg, ctx, TRAIN_FLAGS)
    with plain_versions(), forced_routing(k_route) as own:
        lp, _, gp = loss_and_grads(params, proj, inputs, cfg, ctx, TRAIN_FLAGS)
    rel = leaf_rel_errs(gk, gp)
    loss_err = abs(float(lk) - float(lp))
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk))
    ok = finite and max(rel) <= tol and loss_err <= loss_tol * abs(float(lp))
    row = {"phase": phase, "config": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "mode": mode, **extra, "remat": TRAIN_FLAGS.remat, "loss_kernels": float(lk),
           "loss_plain": float(lp), "loss_abs_err": loss_err, "loss_limit_rel": loss_tol,
           "max_leaf_rel_err": max(rel), "max_leaf": names[rel.index(max(rel))],
           "top_leaf_rel_errs": sorted(([r, f"{i} {n}"] for i, (n, r) in
                                        enumerate(zip(names, rel))), reverse=True)[:5],
           "mean_leaf_rel_err": sum(rel) / len(rel), "n_leaves": len(rel), "limit_rel": tol,
           "grads_finite": finite, "ok": ok}
    if own[1]:
        row.update({"routing": "plain run forced to the kernel run's expert ids",
                    "routing_decisions": own[1], "routing_decisions_plain_own_differ": own[0]})
    emit(row)
    if not ok:
        raise AssertionError(f"{phase} {cfg.name} {mode} gradient parity failed: {row}")
    return row


def first_layers(tree, n: int):
    """A params-shaped tree (or V1 tree) cut to its first ``n`` periods."""
    if isinstance(tree, dict):
        return {k: (first_layers(v, n) if k == "layers" else v) for k, v in tree.items()}
    return tuple({part: {k: t[:n] for k, t in blk[part].items()} for part in blk}
                 for blk in tree)


def ssm_train_phase(dev) -> tuple:
    """Phase 15: full-width, full-depth mamba2-2.7b; returns (launches summed
    over its steps, the seeded params) for phase 16."""
    t0 = time.perf_counter()
    total = {n: 0 for n in TRAIN_KERNELS}
    cfg = get_config(SSM_CONFIG)
    B, S = SSM_TRAIN_B, SSM_TRAIN_S
    free_card("mamba2 train", 62)
    params, proj, svd_s = seeded_with_proj(dev, cfg, TRAIN_RANK)
    d_inner = cfg.ssm.expand * cfg.d_model
    emit({"phase": "mamba2 train", "config": cfg.name, "n_layers": cfg.n_layers,
          "n_params": count_params(cfg), "svd_refresh_s": svd_s, "svds": 2 * cfg.n_layers,
          "matrices": [[cfg.d_model, 2 * d_inner + 2 * cfg.ssm.d_state + d_inner // 64],
                       [d_inner, cfg.d_model]]})
    keep, w = plan_to_masks(SSM_TRAIN_PLAN, cfg, B)
    batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, B, S), dev)
    names = leaf_names(params)
    # forward-backward peaks: technique II recomputes whole SSM blocks in
    # degraded mode, so its peak must lie below the healthy step's
    fb = {}
    for mode in TRAIN_MODES:
        ctx = parity_ctx(mode, keep, w, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        loss, _, g = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
        float(loss)
        torch.cuda.synchronize()
        fb[mode] = {"peak_above_held_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                    "ms": 1e3 * (time.perf_counter() - t1), "loss": float(loss)}
        del g
    emit({"phase": "mamba2 train", "run": "forward-backward", "batch": B, "seq_len": S,
          "by_mode": fb, "degraded_below_off": fb["degraded"]["peak_above_held_gib"]
          < fb["off"]["peak_above_held_gib"]})
    if not fb["degraded"]["peak_above_held_gib"] < fb["off"]["peak_above_held_gib"]:
        raise AssertionError(f"mamba2: degraded forward-backward peak not below off's: {fb}")
    # bf16 at full depth, dynamic and degraded, anchored to the f32 step.
    # The gate is the anchor, as for MoE (phase 14): at 64 layers of seeded
    # weights the bf16 gradient is rounding noise of the dt path (its
    # cumulative decays cancel), the plain bf16 path's leaves lying
    # 1.46 (relative) from the f32 step's, so the kernels-vs-plain leaf
    # limit is reported; the f32 rows below gate every leaf
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    up = lambda t: t.float()  # noqa: E731
    tol, loss_tol = TRAIN_PARITY_TOL["bfloat16"]
    for mode in ("dynamic", "degraded"):
        ctx = parity_ctx(mode, keep, w, dev)
        p32, v32 = tree_map(up, params), tree_map(up, proj)
        with plain_versions():
            _l32, _, g32 = loss_and_grads(p32, v32, batch, cfg32, ctx, TRAIN_FLAGS)
        del p32, v32
        torch.cuda.empty_cache()
        lk, _, gk = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
        with plain_versions():
            lp, _, gp = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
        rel = leaf_rel_errs(gk, gp)
        to_k, to_p = max(leaf_rel_errs(gk, g32)), max(leaf_rel_errs(gp, g32))
        loss_err = abs(float(lk) - float(lp))
        finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk))
        ok = (finite and loss_err <= loss_tol * abs(float(lp))
              and to_k <= TRAIN_ANCHOR_RATIO * to_p)
        row = {"phase": "mamba2 train parity", "dtype": "bfloat16", "n_layers": cfg.n_layers,
               "mode": mode, "batch": B, "seq_len": S, "loss_kernels": float(lk),
               "loss_plain": float(lp), "loss_f32": float(_l32), "loss_abs_err": loss_err,
               "loss_limit_rel": loss_tol, "max_leaf_rel_err": max(rel),
               "max_leaf": names[rel.index(max(rel))], "mean_leaf_rel_err": sum(rel) / len(rel),
               "leaf_limit_rel_reported": tol, "max_leaf_rel_err_kernels_vs_f32": to_k,
               "max_leaf_rel_err_plain_vs_f32": to_p, "anchor_ratio_limit": TRAIN_ANCHOR_RATIO,
               "grads_finite": finite, "ok": ok}
        emit(row)
        if not ok:
            raise AssertionError(f"mamba2 bf16 {mode} train parity failed: {row}")
        del gk, gp, g32
        torch.cuda.empty_cache()
    # f32 on the first SSM_PARITY_LAYERS layers, all four modes
    cfg4 = dataclasses.replace(cfg, n_layers=SSM_PARITY_LAYERS, dtype="float32")
    p4, v4 = tree_map(up, first_layers(params, cfg4.n_layers)), tree_map(up, first_layers(proj, cfg4.n_layers))
    keep4, w4 = plan_to_masks(SSM_TRAIN_PLAN, cfg4, B)
    for mode in TRAIN_MODES:
        grad_parity_row("mamba2 train parity", cfg4, p4, v4, batch, parity_ctx(mode, keep4, w4, dev),
                        leaf_names(p4), mode, SSM_F32_LEAF_TOL, TRAIN_PARITY_TOL["float32"][1],
                        batch=B, seq_len=S)
    del p4, v4, batch
    # MeCeFO steps through make_train_step, launch counts exact
    rows = {}
    for mode in TRAIN_MODES:
        free_card("mamba2 train", 0)
        row = config_step(dev, cfg, mode, B, S, SSM_TRAIN_STEPS, TRAIN_RANK, SSM_TRAIN_PLAN,
                          base=(params, proj, svd_s))
        emit({"phase": "mamba2 train", **row})
        if not row["ok"]:
            raise AssertionError(f"mamba2 train {mode}: {row}")
        rows[mode] = row
        for n in TRAIN_KERNELS:
            total[n] += row["launches"][n]
    # the zero-width FFN: its SwiGLU and #6 calls are empty and launch nothing
    L = cfg.n_layers
    zero = {"swiglu": {m: (1 + 1) * L for m in TRAIN_MODES},  # forward + FFN recompute
            "swiglu_bwd": {m: L for m in TRAIN_MODES},
            "lowrank_wgrad": {m: 0 if m == "off" else 3 * L for m in TRAIN_MODES}}
    emit({"phase": "mamba2 train", "run": "zero-width FFN calls per step (no launch)",
          "calls": zero, "swiglu_launches": {m: rows[m]["launches"]["swiglu"] for m in rows},
          "swiglu_bwd_launches": {m: rows[m]["launches"]["swiglu_bwd"] for m in rows}})
    # where the device time goes: the plain SSD scan's share
    for mode in ("off", "degraded"):
        free_card("mamba2 profile", 0)
        cell = train_cell(dev, config=SSM_CONFIG, params=params, proj=proj, svd_s=svd_s)
        emit({"phase": "mamba2 profile", **profile_step(cell, mode, dev)})
        del cell
    emit({"phase": "mamba2 train", "run": "phase", "seconds": time.perf_counter() - t0})
    return total, params


def dense_path_logits(params, cfg, prompts, n_steps, forced=None, step_ms=None):
    """Prefill each prompt alone at its own length into dense caches of
    ``max(len) + n_steps`` rows, then ``n_steps`` greedy ``forward_decode``
    steps for all of them at once (per-prompt lengths; an SSM layer keeps
    its conv window and state per row).  Returns (logits per step, tokens
    fed); ``step_ms`` collects each decode step's wall ms."""
    dev = params["embed"].device
    dt = params["embed"].dtype
    smax = max(len(p) for p in prompts) + n_steps
    parts, first = [], []
    for prompt in prompts:
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        caches, logits = forward_prefill(params, {"tokens": toks}, cfg,
                                         cache_structs(cfg, 1, smax, dt))
        parts.append(caches)
        first.append(logits[0])
    caches = tuple({k: torch.cat([c[i][k] for c in parts], dim=1) for k in parts[0][i]}
                   for i in range(len(parts[0])))
    del parts
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        t1 = time.perf_counter()
        caches, logits = forward_decode(params, caches, tok, lens, cfg)
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
        out.append(logits)
        lens = lens + 1
    return torch.stack(out), fed


def prefill_decode_consistency(phase, cfg, params, prompts) -> dict:
    """Each prompt's last decode logits (kernels) against one prefill of the
    prompt followed by the tokens fed (the reference's
    ``test_prefill_decode_matches_full``), and the kernel path against the
    plain path, at f32, both within SSM_F32_LOGIT_REL of max |logit|."""
    k_logits, fed = dense_path_logits(params, cfg, prompts, SSM_DECODE_STEPS)
    with plain_versions():
        p_logits, _ = dense_path_logits(params, cfg, prompts, SSM_DECODE_STEPS, forced=fed)
    V = cfg.vocab_size
    path_err = float((k_logits[..., :V] - p_logits[..., :V]).abs().max())
    errs = []
    for i, prompt in enumerate(prompts):
        seq = list(prompt) + [int(t[i]) for t in fed]
        toks = torch.tensor([seq], dtype=torch.int32, device=params["embed"].device)
        _, full = forward_prefill(params, {"tokens": toks}, cfg,
                                  cache_structs(cfg, 1, len(seq), params["embed"].dtype))
        errs.append(float((k_logits[-1, i, :V] - full[0, :V]).abs().max()))
    scale = float(p_logits[..., :V].abs().max())
    tol = SSM_F32_LOGIT_REL * scale
    ok = (max(errs) <= tol and path_err <= tol
          and bool(torch.isfinite(k_logits[..., :V]).all()))
    row = {"phase": phase, "config": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
           "prompt_lens": [len(p) for p in prompts], "decode_steps": len(fed),
           "prefill_then_decode_vs_full_prefill_max_abs": errs,
           "kernels_vs_plain_max_abs": path_err, "max_abs_logit": scale,
           "limit": {"max_abs <=": tol, "of max |logit|": SSM_F32_LOGIT_REL}, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"{phase} prefill/decode consistency failed: {row}")
    return row


def ssm_prompts(cfg) -> list:
    rng = np.random.default_rng(16)
    return [[int(x) for x in rng.integers(0, cfg.vocab_size, n)] for n in SSM_PROMPT_LENS]


def ssm_decode_phase(dev, params) -> dict:
    """Phase 16: phase 15's weights (full depth, bf16): SSM_PROMPT_LENS
    prompts through ``forward_prefill``, then SSM_DECODE_STEPS greedy
    ``forward_decode`` steps over the dense caches, through the kernels and
    the plain versions (teacher-forced) at the serve phases' bf16 limits;
    at f32 on SSM_PARITY_LAYERS layers, prefill then decode against the
    full prefill.  Returns the kernel run's launches."""
    t0 = time.perf_counter()
    cfg = get_config(SSM_CONFIG)
    free_card("mamba2 decode", 4)
    prompts = ssm_prompts(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    ms = []
    k_logits, fed = dense_path_logits(params, cfg, prompts, SSM_DECODE_STEPS, step_ms=ms)
    launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    with plain_versions():
        p_logits, _ = dense_path_logits(params, cfg, prompts, SSM_DECODE_STEPS, forced=fed)
    up = lambda t: t.float()  # noqa: E731
    with plain_versions():
        f_logits, _ = dense_path_logits(tree_map(up, params), dataclasses.replace(
            cfg, dtype="float32"), prompts, SSM_DECODE_STEPS, forced=fed)
    V = cfg.vocab_size
    anchored_bf16_path("mamba2 decode parity", k_logits[..., :V], p_logits[..., :V],
                       f_logits[..., :V], n_layers=cfg.n_layers, prompt_lens=SSM_PROMPT_LENS,
                       steps=1 + len(fed))
    L, n = cfg.n_layers, len(prompts)
    # per prefill: 3 norms a layer (ln, gate norm, FFN ln) + the final
    # norm; per decode step the same for the batch
    want = {"rmsnorm": (n + SSM_DECODE_STEPS) * (3 * L + 1), "swiglu": 0, "flash_attention": 0,
            "paged_decode": 0, "flash_decode": 0}
    emit({"phase": "mamba2 decode", "config": cfg.name, "n_layers": L, "batch": n,
          "prompt_lens": SSM_PROMPT_LENS, "decode_steps": len(fed),
          "decode_ms": ms, "decode_ms_median": sorted(ms)[len(ms) // 2],
          "tokens_per_s": n * len(ms) / (sum(ms) / 1e3),
          "peak_above_held_gib": (peak - held) / 2 ** 30, "launches": launches,
          "want_launches": want, "ok": launches == want})
    if launches != want:
        raise AssertionError(f"mamba2 decode launches {launches}, want {want}")
    cfg4 = dataclasses.replace(cfg, n_layers=SSM_PARITY_LAYERS, dtype="float32")
    p4 = tree_map(up, first_layers(params, cfg4.n_layers))
    prefill_decode_consistency("mamba2 decode parity", cfg4, p4, prompts)
    del p4
    emit({"phase": "mamba2 decode", "run": "phase", "seconds": time.perf_counter() - t0})
    return launches


def hybrid_phase(dev) -> dict:
    """Phase 17: reduced jamba (the hybrid trunk: attention every 8 layers,
    MoE every second, SSM elsewhere) in f32 on the card: loss and every
    gradient leaf, kernels against plain versions, in the four NDB modes;
    prefill then decode against the full prefill.  Then jamba's smallest
    legal depth (one 8-layer period) at its published widths, in bytes.
    Returns the launches of its kernel runs."""
    t0 = time.perf_counter()
    free_card("hybrid", 2)
    reset_launches()
    # capacity for every token: a decode step's few tokens and the full
    # prefill's route alike only where no expert drops one
    cfg = reduced(get_config(HYBRID_CONFIG), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params, proj, _ = seeded_with_proj(dev, cfg, HYBRID_RANK, seed=2)
    B, S = HYBRID_B, HYBRID_S
    keep, w = plan_to_masks(MOE_TRAIN_PLAN, cfg, B)
    batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, B, S), dev)
    names = leaf_names(params)
    for mode in TRAIN_MODES:
        grad_parity_row("hybrid parity", cfg, params, proj, batch, parity_ctx(mode, keep, w, dev),
                        names, mode, SSM_F32_LEAF_TOL, TRAIN_PARITY_TOL["float32"][1],
                        batch=B, seq_len=S,
                        layout=[f"{cfg.layer_kind(i)}{'+moe' if cfg.layer_is_moe(i) else ''}"
                                for i in range(cfg.block_period)])
    rng = np.random.default_rng(17)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)] for n in (40, 64, 100, 128)]
    prefill_decode_consistency("hybrid parity", cfg, params, prompts)
    launches = {n: WRAPPERS[n].launches for n in WRAPPERS}
    full = get_config(HYBRID_CONFIG)
    period = dataclasses.replace(full, n_layers=full.block_period)
    n_period = count_params(period)
    emit({"phase": "hybrid", "config": full.name, "smallest_legal_depth_layers": full.block_period,
          "params": n_period, "bf16_bytes": 2 * n_period, "bf16_gb": 2 * n_period / 1e9,
          "full_depth_params": count_params(full), "card_bytes": torch.cuda.mem_get_info()[1],
          "fits_one_card": 2 * n_period < torch.cuda.mem_get_info()[1],
          "note": "jamba at published widths waits for the multi-GPU slice"})
    emit({"phase": "hybrid", "run": "phase", "seconds": time.perf_counter() - t0})
    del params, proj, batch
    return launches


def accum_phase(dev) -> dict:
    """Gradient accumulation and the dots remat on phase 7's cell
    (llama-350m, B 8, S 1024, rank 64): accum 1, 2 and 4 at the same global
    batch in dynamic and degraded mode (step ms, peaks); remat "dots"
    against "ffn" there; at f32 on a 4-layer copy the accumulated
    gradients against accum 1's, and "dots"'s against "none"'s, every leaf
    within TRAIN_PARITY_TOL["float32"].  Returns the launches of its steps."""
    t0 = time.perf_counter()
    free_card("accumulation", 30)
    cell = train_cell(dev)
    cfg = cell.cfg
    batch = cell.source().batch(0, TRAIN_B, TRAIN_S)
    total = {n: 0 for n in TRAIN_KERNELS}
    peaks = {}
    for mode in ("dynamic", "degraded"):
        for accum, remat in ((1, "ffn"), (2, "ffn"), (4, "ffn"), (1, "dots")):
            state = cell.state()
            flags = ExecFlags(remat=remat)
            step = make_train_step(cfg, cell.train, cell.mecefo, cell.shape, ndb_mode=mode,
                                   flags=flags, device=dev,
                                   parallel=ParallelConfig(accum=accum))
            ndb = ({"keep": cell.keep, "example_weight": cell.weight},) if mode == "dynamic" else ()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            losses, times = [], []
            for i in range(ACCUM_STEPS):
                t1 = time.perf_counter()
                state, metrics = step(state, batch, *ndb)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t1))
            peak = torch.cuda.max_memory_allocated()
            launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
            row = {"phase": "accumulation", "config": cfg.name, "mode": mode, "accum": accum,
                   "remat": remat, "global_batch": TRAIN_B, "micro_batch": TRAIN_B // accum,
                   "seq_len": TRAIN_S, "losses": losses, "step_ms": times,
                   "step_ms_min": min(times), "peak_mem_gib": peak / 2 ** 30,
                   "peak_above_state_gib": (peak - base) / 2 ** 30, "launches": launches,
                   "ok": bool(np.isfinite(losses).all())}
            if remat == "ffn":
                want = train_launches_per_step(cfg, mode, flags, cell.mecefo)
                row["want_launches"] = {n: c * accum * ACCUM_STEPS for n, c in want.items()}
                row["ok"] = row["ok"] and all(launches[n] == c for n, c in row["want_launches"].items())
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"accumulation {mode} accum {accum} {remat}: {row}")
            peaks[(mode, accum, remat)] = row["peak_above_state_gib"]
            for n in TRAIN_KERNELS:
                total[n] += launches[n]
            del state, step
    emit({"phase": "accumulation", "peak_above_state_gib": {
        f"{m} accum {a} {r}": p for (m, a, r), p in peaks.items()}})
    # f32 gradient rows on 4 layers (seed 1, as phase 8)
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    params = init_params(cfg4, torch.Generator(device=dev).manual_seed(1), dev)
    proj = refresh_projections(params, cfg4, TRAIN_RANK)
    keep, w = plan_to_masks(TRAIN_PLAN, cfg4, TRAIN_B)
    tb = to_device(batch, dev)
    tol, loss_tol = TRAIN_PARITY_TOL["float32"]
    for mode in ("dynamic", "degraded"):
        ctx = parity_ctx(mode, keep, w, dev)
        l1, _, g1 = loss_and_grads(params, proj, tb, cfg4, ctx, TRAIN_FLAGS)
        for label, (lx, _, gx) in (
                ("accum 2", accumulated_loss_and_grads(params, proj, tb, cfg4, ctx, TRAIN_FLAGS, 2)),
                ("accum 4", accumulated_loss_and_grads(params, proj, tb, cfg4, ctx, TRAIN_FLAGS, 4)),
                ("remat dots vs none", loss_and_grads(params, proj, tb, cfg4, ctx,
                                                      ExecFlags(remat="dots")))):
            ref_l, ref_g = (l1, g1)
            if label.startswith("remat"):
                ref_l, _, ref_g = loss_and_grads(params, proj, tb, cfg4, ctx, ExecFlags(remat="none"))
            rel = leaf_rel_errs(gx, ref_g)
            loss_err = abs(float(lx) - float(ref_l))
            ok = max(rel) <= tol and loss_err <= loss_tol * abs(float(ref_l))
            row = {"phase": "accumulation parity", "dtype": "float32", "n_layers": 4,
                   "mode": mode, "check": label, "against": "accum 1" if "accum" in label
                   else "remat none", "loss": float(lx), "loss_ref": float(ref_l),
                   "loss_abs_err": loss_err, "max_leaf_rel_err": max(rel),
                   "limit_rel": tol, "ok": ok}
            emit(row)
            if not ok:
                raise AssertionError(f"accumulation parity {mode} {label}: {row}")
    del params, proj, cell
    emit({"phase": "accumulation", "run": "phase", "seconds": time.perf_counter() - t0})
    return total


# phase 18, multi-rank: (a) one NCCL rank at full width and depth on phase
# 7's cell, MR_STEPS steps a run, bitwise against the one-process step; (b)
# two gloo ranks sharing the card with CUDA tensors, MESH_CELL_LAYERS f32
# layers of llama-350m at full width, MR_GLOO_STEPS steps a run, each leaf within
# TRAIN_PARITY_TOL["float32"] of the one-process global-batch step; (c) the
# Trainer on those two ranks replaying golden_trace.jsonl at the CLI's
# reduced config
MR_MODES = (("off", False), ("dynamic", False), ("static", False), ("degraded", False),
            ("degraded", True))
# the gloo cells of phases 18 and 19 (llama-350m at full width in f32) run 2
# of its 24 layers since phase 20 came, for the script's time limit (their
# gates do not depend on depth); their plan fails the stage that lands on
# the second layer, so one layer keeps every example and one skips a
# quarter, as the train plan does on 4 layers
MESH_CELL_LAYERS = 2
MESH_PLAN = NDBPlan(n_dp=4, n_stages=8, failed=frozenset({(1, 2)}))
MR_STEPS, MR_GLOO_STEPS, MR_GLOO_LAYERS = 2, 3, MESH_CELL_LAYERS
MR_TRACE = "golden_trace.jsonl"
MR_TIMEOUT_S = 600


def mr_label(mode: str, sync: bool) -> str:
    return "degraded_sync" if sync else mode


def mr_tags_reached(counts: dict, fsdp: bool, sync: bool) -> dict:
    """Whether each collective the step runs was reached in ``counts``."""
    tags = {k: set(t) for k, t in counts.items()}
    ar = tags.get("all_reduce", set())
    want = {"loss_count": "loss_count" in ar, "metrics": "metrics" in ar,
            "grad": any(t.startswith("grad:") for t in ar | tags.get("reduce_scatter", set()))}
    if fsdp:
        want["param all_gather"] = any(t.startswith("param:") for t in tags.get("all_gather", ()))
        want["grad reduce_scatter"] = bool(tags.get("reduce_scatter"))
        want["grad_norm"] = "grad_norm" in ar
    if sync:
        want["lowrank factor"] = any(t.startswith("lowrank:") for t in ar)
    return want


def mr_steps(step, state, batches, ndb, dev) -> tuple:
    """Runs the step over ``batches``; (state, metrics per step as floats,
    step ms)."""
    metrics, times = [], []
    for b in batches:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b, *ndb)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, times


def mr_nccl_rows(dev, tmp: str) -> dict:
    """(a): one NCCL rank on phase 7's cell in every mode, replicated and
    FSDP, against ``make_train_step(..., mesh=None)`` from the same state:
    params, moments and metrics bitwise.  Returns its launches."""
    from repro_torch.launch.dist import destroy, init_process_group
    from repro_torch.launch.state import to_local
    from repro_torch.parallel import collectives

    mesh = init_process_group(0, 1, init_method="file://" + os.path.join(tmp, "nccl"),
                              backend="nccl", device=dev)
    total = {n: 0 for n in TRAIN_KERNELS}
    try:
        cell = train_cell(dev)
        cfg = cell.cfg
        batches = [cell.source().batch(i, TRAIN_B, TRAIN_S) for i in range(MR_STEPS)]
        for mode, sync in MR_MODES:
            mecefo = dataclasses.replace(cell.mecefo, lowrank_sync=sync)
            kw = dict(ndb_mode=mode, static_ndb=(cell.keep, cell.weight) if mode == "static"
                      else None, total_steps=cell.train.steps, flags=TRAIN_FLAGS)
            ndb = ({"keep": cell.keep, "example_weight": cell.weight},) if mode == "dynamic" else ()
            ref_step = make_train_step(cfg, cell.train, mecefo, cell.shape,
                                       device=dev, **kw)
            ref, ref_m, ref_ms = mr_steps(ref_step, cell.state(), batches, ndb, dev)
            for fsdp in (False, True):
                step = make_train_step(cfg, cell.train, mecefo, cell.shape, mesh=mesh,
                                       parallel=ParallelConfig(fsdp=fsdp), **kw)
                state = to_local(cell.state(), step.layout)
                collectives.reset_counts()
                reset_launches()
                state, metrics, ms = mr_steps(step, state, batches, ndb, dev)
                launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
                counts = collectives.counts()
                pairs = list(zip(tree_leaves(state.params) + tree_leaves(state.opt.m)
                                 + tree_leaves(state.opt.v),
                                 tree_leaves(ref.params) + tree_leaves(ref.opt.m)
                                 + tree_leaves(ref.opt.v)))
                unequal = sum(not torch.equal(a, b) for a, b in pairs)
                reached = mr_tags_reached(counts, fsdp, sync)
                ok = unequal == 0 and metrics == ref_m and all(reached.values())
                emit({"phase": "multi-rank", "row": "a: nccl, one rank", "config": cfg.name,
                      "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_B,
                      "seq_len": TRAIN_S, "rank": TRAIN_RANK, "mode": mr_label(mode, sync),
                      "fsdp": fsdp, "backend": mesh.comm.backend, "route": mesh.comm.route,
                      "leaves": len(pairs), "leaves_not_bitwise": unequal,
                      "metrics_bitwise": metrics == ref_m, "losses": [m["loss"] for m in metrics],
                      "step_ms": ms, "step_ms_one_process": ref_ms, "reached": reached,
                      "collectives": {k: {"calls": sum(c["calls"] for c in t.values()),
                                          "bytes": sum(c["bytes"] for c in t.values())}
                                      for k, t in counts.items()},
                      "launches": launches, "ok": ok})
                if not ok:
                    raise AssertionError(f"multi-rank (a) {mode} sync={sync} fsdp={fsdp}: "
                                         f"{unequal} leaves differ, metrics {metrics} vs {ref_m}, "
                                         f"reached {reached}")
                for n in TRAIN_KERNELS:
                    total[n] += launches[n]
                del state, step
            del ref, ref_step
        del cell
    finally:
        destroy()
    return total


def mr_gloo_rank(mesh, tmp: str, cfg, seq_len: int, trainer_cfg) -> None:
    """(b) on ``cfg`` at ``seq_len`` and (c) on ``trainer_cfg``, on one of
    two gloo ranks sharing the card: writes ``rank<r>.pt`` (rows, digests,
    rel errors, counts, launches)."""
    from repro_torch.launch.state import gather_state, to_local
    from repro_torch.parallel import collectives

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = torch.load(os.path.join(tmp, "init.pt"), weights_only=False)
    init = tree_map(lambda t: t.to(dev), init)
    train = TrainConfig()
    shape = ShapeConfig("multi-rank", seq_len, TRAIN_B, "train")
    keep, w = plan_to_masks(MESH_PLAN, cfg, TRAIN_B)
    src = SyntheticLM(cfg.vocab_size)
    batches = [src.batch(i, TRAIN_B, seq_len) for i in range(MR_GLOO_STEPS)]
    tol = TRAIN_PARITY_TOL["float32"][0]

    def fresh():
        params = tree_map(lambda t: t.clone(), init["params"])
        return TrainState(step=0, params=params, opt=init_opt_state(params, train),
                          proj=init["proj"])

    rows, launches = [], {n: 0 for n in TRAIN_KERNELS}
    for mode, sync in MR_MODES:
        mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK, lowrank_sync=sync)
        kw = dict(ndb_mode=mode, static_ndb=(keep, w) if mode == "static" else None,
                  total_steps=train.steps, flags=TRAIN_FLAGS)
        ndb = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
        ref = None
        if mesh.rank == 0:  # the one-process step on the global batch; rank 1 waits
            ref, ref_m, ref_ms = mr_steps(make_train_step(cfg, train, mecefo, shape, device=dev,
                                                          **kw), fresh(), batches, ndb, dev)
        for fsdp in (False, True):
            step = make_train_step(cfg, train, mecefo, shape, mesh=mesh,
                                   parallel=ParallelConfig(fsdp=fsdp), **kw)
            state = to_local(fresh(), step.layout)
            collectives.reset_counts()
            reset_launches()
            state, metrics, ms = mr_steps(step, state, batches, ndb, dev)
            for n in TRAIN_KERNELS:
                launches[n] += WRAPPERS[n].launches
            counts = collectives.counts()
            local = tree_leaves(state.params) + tree_leaves(state.opt.m) + tree_leaves(state.opt.v)
            dims = list(step.layout.dims) * 3
            row = {"mode": mr_label(mode, sync), "fsdp": fsdp, "metrics": metrics, "step_ms": ms,
                   "counts": counts, "paths": step.layout.paths, "dims": step.layout.dims,
                   "leaf_numel": [x.numel() for x in tree_leaves(state.params)],
                   "whole_leaves": step.layout.whole,
                   "held_bytes": sum(x.numel() * x.element_size() for x in local),
                   "replicated_digest": tree_digest([x for x, d in zip(local, dims) if d is None],
                                                    dev),
                   "route": mesh.comm.route, "backend": mesh.comm.backend}
            whole = gather_state(state, step.layout)
            if mesh.rank == 0:
                row["ref_step_ms"] = ref_ms
                row["loss_rel_err"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                          for a, b in zip(metrics, ref_m))
                errs = {what: leaf_rel_errs(getattr(whole, part) if what == "params" else
                                            getattr(whole.opt, what),
                                            getattr(ref, part) if what == "params" else
                                            getattr(ref.opt, what))
                        for what, part in (("params", "params"), ("m", "opt"), ("v", "opt"))}
                row["max_leaf_rel_err"] = {k: max(v) for k, v in errs.items()}
                row["limit_rel"] = tol
            rows.append(row)
            del state, whole, step
        del ref
    # (c): the Trainer replays the golden trace at the CLI's reduced config
    trace = load_trace(os.path.join(TRAINER_DATA, MR_TRACE))
    collectives.reset_counts()
    reset_launches()
    t0 = time.perf_counter()
    trainer = Trainer(trainer_cfg, ShapeConfig("cli", 128, 8, "train"),
                      TrainConfig(steps=trace.footer.total_steps),
                      mecefo=MeCeFOConfig(mode="dynamic", rank=16, svd_period=20),
                      trace_replay=trace, mesh=mesh)
    hist = trainer.run(log_every=0)
    agreed = trainer.replay_agreed()
    trainer_launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
    for n in TRAIN_KERNELS:
        launches[n] += trainer_launches[n]
    torch.save({"rows": rows, "launches": launches,
                "trainer": {"agreed": agreed, "own_verify": trainer.verify_replay(),
                            "steps": len(hist), "losses": [r["loss"] for r in hist],
                            "wall_s": time.perf_counter() - t0, "launches": trainer_launches,
                            "collectives": {k: sum(c["calls"] for c in t.values())
                                            for k, t in collectives.counts().items()}}},
               os.path.join(tmp, f"rank{mesh.rank}.pt"))


def mr_gloo_rows(dev, tmp: str, cfg, seq_len: int, trainer_cfg) -> dict:
    """(b) and (c): spawn the two gloo ranks, then gate their results.
    Returns each rank's launches."""
    from repro_torch.launch.dist import spawn

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    proj = refresh_projections(params, cfg, TRAIN_RANK)
    torch.save(tree_map(lambda t: t.cpu(), {"params": params, "proj": proj}),
               os.path.join(tmp, "init.pt"))
    del params, proj
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(mr_gloo_rank, 2, tmp, cfg, seq_len, trainer_cfg, backend="gloo", device=dev.type,
          timeout=MR_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    tol = TRAIN_PARITY_TOL["float32"][0]
    fails = []
    by = {(r["mode"], r["fsdp"]): r for r in ranks[0]["rows"]}
    for r0, r1 in zip(ranks[0]["rows"], ranks[1]["rows"]):
        bitwise = r0["replicated_digest"] == r1["replicated_digest"]
        ok = (bitwise and r0["metrics"] == r1["metrics"]
              and max(r0["max_leaf_rel_err"].values()) <= tol and r0["loss_rel_err"] <= tol)
        emit({"phase": "multi-rank", "row": "b: gloo, two ranks on one card",
              "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
              "batch": TRAIN_B, "rows_per_rank": TRAIN_B // 2, "seq_len": seq_len,
              "mode": r0["mode"], "fsdp": r0["fsdp"], "backend": r0["backend"],
              "route": r0["route"], "replicas_bitwise": bitwise,
              "losses": [m["loss"] for m in r0["metrics"]],
              "loss_rel_err": r0["loss_rel_err"], "max_leaf_rel_err": r0["max_leaf_rel_err"],
              "limit_rel": tol, "step_ms_rank0": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
              "step_ms_one_process": r0["ref_step_ms"],
              "held_bytes": r0["held_bytes"], "ok": ok})
        if not ok:
            fails.append(f"(b) {r0['mode']} fsdp={r0['fsdp']}")
    # degraded_sync's factored all-reduce: r/n of each low-rank leaf's bytes
    deg = by[("degraded", False)]["counts"]["all_reduce"]
    syn = by[("degraded_sync", False)]["counts"]["all_reduce"]
    ratios = {}
    for tag, c in syn.items():
        if tag.startswith("lowrank:"):
            path = tag[len("lowrank:"):]
            n = cfg.d_ff if path.endswith("w_down") else cfg.d_model  # W's input dim
            r = min(TRAIN_RANK, cfg.d_model, cfg.d_ff)
            grad = deg["grad:" + path]["bytes"]
            ratios[path] = {"factor_bytes": c["bytes"], "gradient_bytes_degraded": grad,
                            "ratio": c["bytes"] / grad, "want": f"{r}/{n}",
                            "ok": c["bytes"] * n == grad * r and "grad:" + path not in syn}
    bytes_ok = len(ratios) == 3 and all(v["ok"] for v in ratios.values())
    # FSDP: half the sharded leaves' params and moments, the whole leaves kept
    rep, fs = by[("dynamic", False)], by[("dynamic", True)]
    whole_bytes = 3 * 4 * sum(n for n, d in zip(fs["leaf_numel"], fs["dims"]) if d is None)
    held_ok = fs["held_bytes"] * 2 == rep["held_bytes"] + whole_bytes
    emit({"phase": "multi-rank", "row": "b: bytes", "lowrank_sync_factor_vs_gradient": ratios,
          "bytes_ok": bytes_ok, "held_bytes_replicated": rep["held_bytes"],
          "held_bytes_fsdp": fs["held_bytes"], "whole_leaves": fs["whole_leaves"],
          "whole_leaf_bytes": whole_bytes, "held_ratio": fs["held_bytes"] / rep["held_bytes"],
          "held_ok": held_ok})
    if not bytes_ok:
        fails.append("(b) degraded_sync bytes")
    if not held_ok:
        fails.append("(b) fsdp held bytes")
    tr = [r["trainer"] for r in ranks]
    ok = all(t["agreed"] and not t["own_verify"] for t in tr) and tr[0]["losses"] == tr[1]["losses"]
    emit({"phase": "multi-rank", "row": "c: trainer, two gloo ranks", "trace": MR_TRACE,
          "config": f"reduced {trainer_cfg.name} {trainer_cfg.dtype}", "steps": tr[0]["steps"],
          "replay": "REPLAY OK" if ok else "REPLAY MISMATCH",
          "agreed": [t["agreed"] for t in tr], "final_loss": tr[0]["losses"][-1],
          "wall_s": [t["wall_s"] for t in tr], "collective_calls": tr[0]["collectives"],
          "launches": [t["launches"] for t in tr], "ok": ok})
    if not ok:
        fails.append("(c) trainer replay")
    emit({"phase": "multi-rank", "row": "b+c spawn", "seconds": spawn_s,
          "launches_by_rank": [r["launches"] for r in ranks]})
    if fails:
        raise AssertionError(f"multi-rank: {fails}")
    return {r: ranks[r]["launches"] for r in range(2)}


def multirank_phase(dev) -> dict:
    """Phase 18.  Returns the launches of each of its paths."""
    t0 = time.perf_counter()
    free_card("multi-rank", 30)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"multi-rank nccl w1": mr_nccl_rows(dev, tmp)}
        torch.cuda.empty_cache()
        full = get_config(TRAIN_CONFIG)
        gloo = mr_gloo_rows(dev, tmp, dataclasses.replace(full, n_layers=MR_GLOO_LAYERS,
                                                          dtype="float32"),
                            TRAIN_S, reduced(full, dtype="float32"))
    out.update({f"multi-rank gloo w2 rank {r}": c for r, c in gloo.items()})
    emit({"phase": "multi-rank", "run": "phase", "seconds": time.perf_counter() - t0})
    return out

# Phase 19: the model axis.  Ranks share the card over gloo with CUDA
# tensors (one card takes one NCCL rank): host-staged, so no time here is a
# measure of NCCL or of tensor parallelism's speed.
MA_LAYERS, MA_STEPS, MA4_STEPS = MESH_CELL_LAYERS, 3, 2
MA_RUNS = (("tp", "off"), ("tp", "dynamic"), ("tp+sp", "dynamic"), ("fsdp", "dynamic"),
           ("tp", "static"), ("tp", "degraded"), ("tp+sp", "degraded"), ("tp", "degraded_sync"))
MA4_RUNS = (("tp", "dynamic"), ("tp", "degraded_sync"))
MA_MOE_LAYERS, MA_MOE_B, MA_MOE_STEPS = 1, 2, 2
MA_MOE_RUNS = (("ep", "off"), ("ep", "degraded"), ("ep-a2a", "off"))
MA_MOE_PLAN = NDBPlan(n_dp=2, n_stages=1, failed=frozenset())
MA_TIMEOUT_S = 900
# (e) the SSM mixer cut by its heads on mamba2-2.7b, (f) on reduced jamba:
# each leaf within 1e-4 of the one-process step for mamba2 but the per-head
# A_log, D and dt_bias, and every leaf of jamba, within SSM_F32_LEAF_TOL:
# those sums over every position cancel (phase 15), and A_log's moment
# lands 1.05e-4 from the one-process step's in the 2-D run, whose mixer is
# whole (1.22e-4 cut, H100 80GB HBM3)
SSM_MA_B, SSM_MA_S, SSM_MA_STEPS = 2, 1024, 2
SSM_MA_RUNS = (("ssm", "dynamic"), ("ssm", "degraded"), ("ssm", "degraded_sync"),
               ("fsdp", "dynamic"))
SSM_MA_PLAN = NDBPlan(n_dp=2, n_stages=2, failed=frozenset({(1, 0)}))
HYBRID_MA_RUNS, HYBRID_MA_STEPS = (("hybrid", "dynamic"),), 2
SSM_TP_T = SSM_MA_B * SSM_MA_S  # the cut gate_norm's rows in a step
MA_KERNELS = TRAIN_KERNELS + SPLIT_NORM
# a routing decision of the all-to-all run may differ from the reference's
# only where the two top-k sets tie within this share of max |logit| (f32
# sums in other orders move a logit by ~1e-7 of it); the EP runs under
# tp_fsdp route the reference's tokens in its order and may differ nowhere
MA_TIE_GAP = 1e-5
MA_FORCED_KINDS = ("ep-a2a", "hybrid")
SSM_TP_TAGS = ("tp:ssm_in", "tp:ssm_out", "tp:ssm_bc", "tp:ssm_heads", "tp:gate_norm")
# the tags each kind of run must reach, by collective kind
MA_TAGS = {
    "tp": {"all_reduce": ("tp:attn_out", "tp:ffn_out", "tp:embed", "tp:ce_in", "tp:ffn_in"),
           "all_reduce_max": ("tp:vocab",)},
    "tp+sp": {"all_gather": ("sp:gather", "sp:split"), "reduce_scatter": ("sp:scatter",),
              "all_reduce": ("sp:norm", "tp:embed"), "all_reduce_max": ("tp:vocab",)},
    "fsdp": {"all_gather": ("param:",), "reduce_scatter": ("grad:",)},
    "ep": {"all_gather": ("ep:split", "ep:gather"), "all_reduce": ("tp:attn_out", "tp:embed"),
           "all_reduce_max": ("tp:vocab",)},
    "ep-a2a": {"all_to_all": ("ep:a2a", "ep:a2a_keep"), "all_gather": ("param:",)},
    "ssm": {"all_reduce": SSM_TP_TAGS + ("tp:embed", "tp:ce_in"),
            "all_reduce_max": ("tp:vocab",)},
    "hybrid": {"all_reduce": SSM_TP_TAGS + ("tp:attn_out", "tp:ffn_out", "tp:embed"),
               "all_gather": ("ep:split", "ep:gather"), "all_reduce_max": ("tp:vocab",)},
}


def ma_mode(label: str) -> tuple:
    return ("degraded", True) if label == "degraded_sync" else (label, False)


def ma_parallel(kind: str, data: int) -> ParallelConfig:
    """The parallel config of a phase 19 run: TP (+ FSDP over ``data`` above
    1), TP + SP, the pure 2-D ``fsdp`` mode; ``ep`` is TP's, ``ep-a2a``
    the 2-D mode's."""
    if kind in ("fsdp", "ep-a2a"):
        return ParallelConfig(fsdp=True, sharding_mode="fsdp")
    return ParallelConfig(fsdp=data > 1, sequence_parallel=kind == "tp+sp")


def ma_reached(counts: dict, kind: str, mode: str, sync: bool) -> dict:
    """Whether each collective tag of the run was reached (a tag ending in
    ``:`` is a prefix)."""
    want = {k: list(v) for k, v in MA_TAGS[kind].items()}
    if kind == "tp" and mode != "degraded":  # the all-degraded program has no MHA backward
        want["all_reduce"].append("tp:attn_in")
    if mode == "degraded" and kind in ("tp", "tp+sp", "ssm"):
        want.setdefault("all_reduce", []).append("lowrank:" if sync else "lowrank_row:")
    out = {}
    for kind_, tags in want.items():
        have = counts.get(kind_, {})
        for t in tags:
            out[f"{kind_} {t}"] = (any(h.startswith(t) for h in have) if t.endswith(":")
                                   else t in have)
    return out


def ma_tp_bytes(cfg, rows: int, seq: int, mode: str) -> int:
    """TP's all-reduce bytes a step (tags ``tp:``) from the shapes, for a
    TP run without SP over ``rows`` rows: forward, the attention's and the
    FFN's outputs a layer and the embedding; backward, the attention's
    (none when every example is degraded) and the FFN's inputs a layer and
    the cross-entropy's input, each (rows, S, d) f32; the cross-entropy's
    sum of exponents and gold logit, (rows, S) f32 each, in the forward and
    again in its recompute."""
    act = rows * seq * cfg.d_model * 4
    per_layer = 3 + (mode != "degraded")
    return act * (2 + cfg.n_layers * per_layer) + 4 * rows * seq * 4


def ma_params0(spec: dict, dev, cache: dict) -> tuple:
    """Whole (params, V1) of a phase 19 cell on ``dev``, new tensors each
    call: from ``init.pt`` (the dense cell, loaded once) or from the seed
    (the MoE cell: made again each call, so no whole copy stays on the
    card), V1 a seeded Gaussian (the parity needs no SVD)."""
    cfg = spec["cfg"]
    if spec["init"] is not None:
        if "init" not in cache:
            init = torch.load(spec["init"], weights_only=False)
            cache["init"] = tree_map(lambda t: t.to(dev), init)
        return (tree_map(lambda t: t.clone(), cache["init"]["params"]),
                tree_map(lambda t: t.clone(), cache["init"]["proj"]))
    from repro_torch.core.lowrank import init_projections

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    proj = tree_map(lambda v: (torch.randn(v.shape, generator=gen, device=dev)
                               / v.shape[-2] ** 0.5).to(v.dtype),
                    init_projections(params, cfg, TRAIN_RANK))
    return params, proj


@contextlib.contextmanager
def ma_forced_routing(ids_log: list, force: bool):
    """Hold the mesh run's routing against the reference's expert ids (this
    rank's rows of them, call for call; an empty log checks nothing).  With
    ``force`` the run takes the reference's ids, as phase 14 forces its
    plain run: in the all-to-all run a rank's GEMMs over its own rows can
    move an f32 near-tie by an ulp, which would swap an expert and spread.
    Yields ``[decisions its own top-k made differently, decisions, the
    largest gap of such a decision relative to max |logit|]``: its own k-th
    logit above the lowest reference one, 0 for a tie."""
    if not ids_log:
        yield [0, 0, 0.0]
        return
    orig = moe_mod.route
    it = iter(ids_log)
    count = [0, 0, 0.0]

    def forced(xt, router, top_k):
        logits, gates, own = orig(xt, router, top_k)
        ids = next(it).to(own.device)
        if ids.shape != own.shape:
            raise AssertionError("the two runs routed different token counts")
        differs = (own.sort(dim=-1).values != ids.sort(dim=-1).values).any(dim=-1)
        count[0] += int(differs.sum())
        count[1] += own.shape[0]
        if bool(differs.any()):
            gap = logits.gather(1, own).min(dim=-1).values - logits.gather(1, ids).min(dim=-1).values
            rel = float(gap[differs].max() / logits.abs().max().clamp(min=1e-30))
            count[2] = max(count[2], rel)
        if not force:
            return logits, gates, own
        return logits, torch.softmax(logits.gather(1, ids), dim=-1), ids

    moe_mod.route = forced
    try:
        yield count
    finally:
        moe_mod.route = orig


def ma_sq_errs(local, ref, layout) -> list:
    """Per leaf, (Σ (local - ref slice)², Σ ref slice²): the ranks' pieces
    sum to the whole leaf's ||Δ||² and ||ref||² (a piece two ranks share
    counts on both, in both sums)."""
    out = []
    for k, (a, b) in enumerate(zip(tree_leaves(local), tree_leaves(ref))):
        b = layout.cut(b, k)
        out.append((float((a.float() - b.float()).square().sum()),
                    float(b.float().square().sum())))
    return out


def ma_rank(mesh, tmp: str, specs: list) -> None:
    """One rank of a phase 19 spawn: each spec on the spawn's mesh in turn."""
    for spec in specs:
        ma_rank_spec(mesh, tmp, spec)


def ma_rank_spec(mesh, tmp: str, spec: dict) -> None:
    """One spec on one rank: per run, the one-process reference on every
    rank (each keeps its own; in turn with ``spec["stagger"]``), then the
    mesh step from the same state; writes ``<tag>.rank<r>.pt`` (rows,
    launches)."""
    from repro_torch.parallel import collectives

    _opt = init_opt_state
    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, B, S, steps = spec["cfg"], spec["batch"], spec["seq"], spec["steps"]
    D, M = mesh.sizes
    train = TrainConfig()
    shape = ShapeConfig("model-axis", S, B, "train")
    keep, w = plan_to_masks(spec["plan"], cfg, B)
    src = SyntheticLM(cfg.vocab_size)
    batches = [src.batch(i, B, S) for i in range(steps)]
    cache, refs, rows = {}, {}, []
    launches = {n: 0 for n in MA_KERNELS}
    world = D * M
    for kind, label in spec["runs"]:
        mode, sync = ma_mode(label)
        mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK, lowrank_sync=sync)
        kw = dict(ndb_mode=mode, static_ndb=(keep, w) if mode == "static" else None,
                  total_steps=train.steps)
        ndb = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
        parallel = ma_parallel(kind, D)
        groups = D * M if parallel.sharding_mode == "fsdp" else D
        key = (mode, sync, groups if cfg.moe is not None else 1)
        if key not in refs:
            refs.clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            # with spec["stagger"] the ranks run it in turn, so a rank that
            # waits holds no reference run's peak
            for r in range(world) if spec.get("stagger") else (mesh.rank,):
                if r == mesh.rank:
                    params, proj = ma_params0(spec, dev, cache)
                    st = TrainState(step=0, params=params, opt=_opt(params, train), proj=proj)
                    flags = dataclasses.replace(TRAIN_FLAGS, n_dp_shards=key[2])
                    with routing_log() as rlog:
                        ref, ref_m, ref_ms = mr_steps(
                            make_train_step(cfg, train, mecefo, shape, device=dev, flags=flags,
                                            **kw), st, batches, ndb, dev)
                    refs[key] = (ref, ref_m, ref_ms, rlog)
                    del st, params
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                if spec.get("stagger"):
                    mesh.world_comm.barrier()
        ref, ref_m, ref_ms, rlog = refs[key]
        step = make_train_step(cfg, train, mecefo, shape, mesh=mesh, parallel=parallel,
                               flags=TRAIN_FLAGS, **kw)
        lay = step.layout
        params, proj = ma_params0(spec, dev, cache)
        local = lay.map(lay.cut, params)
        del params
        state = TrainState(step=0, params=local, opt=_opt(local, train), proj=lay.cut_proj(proj))
        collectives.reset_counts()
        reset_launches()
        tok = slice(step.rows.start * S, step.rows.stop * S)
        with ma_forced_routing([x[tok] for x in rlog], kind in MA_FORCED_KINDS) as forced:
            state, metrics, ms = mr_steps(step, state, batches, ndb, dev)
        run_launches = {n: WRAPPERS[n].launches for n in MA_KERNELS}
        for n in MA_KERNELS:
            launches[n] += run_launches[n]
        counts = collectives.counts()
        shared = [k for k in range(len(lay.dims))
                  if lay.mdims[k] is None and lay.groups[k] != ("data", "model")]
        # a segmented leaf's whole pieces (the SSM's B and C), when data holds it whole
        bc = [p for k, x in enumerate(tree_leaves(state.params))
              if lay.seg(k) is not None and lay.dims[k] is None
              for p, (_, cut) in zip(x.split(lay.local_widths(k), dim=lay.mdims[k]), lay.seg(k))
              if not cut]
        trees = {"params": state.params, "m": state.opt.m, "v": state.opt.v}
        ref_trees = {"params": ref.params, "m": ref.opt.m, "v": ref.opt.v}
        held = [(list(x.shape), list(lay.local_shape(k)))
                for k, x in enumerate(tree_leaves(state.params))]
        row = {"kind": kind, "mode": label, "metrics": metrics, "ref_metrics": ref_m,
               "step_ms": ms, "ref_step_ms": ref_ms, "counts": counts,
               "launches": run_launches, "coords": mesh.coords, "rows": [step.rows.start,
                                                                          step.rows.stop],
               "errs": {t: ma_sq_errs(trees[t], ref_trees[t], lay) for t in trees},
               "digest": tree_digest([x for k, x in enumerate(tree_leaves(state.params))
                                      if k in shared] + bc, dev),
               "segmented": sum(lay.seg(k) is not None for k in range(len(lay.dims))),
               "held": held, "paths": list(lay.paths),
               "model_cut": [lay.paths[k] for k in range(len(lay.dims))
                                           if lay.mdims[k] is not None],
               "route": mesh.model_comm.route, "backend": mesh.model_comm.backend}
        if cfg.moe is not None:
            row["routing_differs"] = forced
        rows.append(row)
        del state, local, step, trees, ref_trees, ref, rlog
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    refs.clear()
    cache.clear()
    out = {"rows": rows, "launches": launches}
    if spec.get("trainer_cfg") is not None:  # (d): the Trainer replays the golden trace
        trace = load_trace(os.path.join(TRAINER_DATA, MR_TRACE))
        reset_launches()
        t0 = time.perf_counter()
        trainer = Trainer(spec["trainer_cfg"], ShapeConfig("cli", 128, 8, "train"),
                          TrainConfig(steps=trace.footer.total_steps),
                          mecefo=MeCeFOConfig(mode="dynamic", rank=16, svd_period=20),
                          trace_replay=trace, mesh=mesh)
        hist = trainer.run(log_every=0)
        out["trainer"] = {"agreed": trainer.replay_agreed(), "own_verify": trainer.verify_replay(),
                          "steps": len(hist), "losses": [r["loss"] for r in hist],
                          "wall_s": time.perf_counter() - t0,
                          "model_cut": sum(d is not None for d in trainer.layout.mdims),
                          "launches": {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}}
        for n in TRAIN_KERNELS:
            out["launches"][n] += out["trainer"]["launches"][n]
    torch.save(out, os.path.join(tmp, f"{spec['tag']}.rank{mesh.rank}.pt"))


def ma_gate(spec: dict, ranks: list, fails: list, on_card: bool) -> None:
    """Emit and gate each run of a phase 19 mesh from its ranks' results
    (``on_card``: each kernel of the run's path launched on every rank)."""
    cfg, D, M = spec["cfg"], spec["mesh"][0], spec["mesh"][1]
    tol = spec.get("tol", TRAIN_PARITY_TOL["float32"][0])
    for i, r0 in enumerate(ranks[0]["rows"]):
        runs = [r["rows"][i] for r in ranks]
        kind, label = r0["kind"], r0["mode"]
        mode, sync = ma_mode(label)
        errs, worst, leaves_ok = {}, {}, True
        for t in ("params", "m", "v"):
            per_leaf = [(sum(r["errs"][t][k][0] for r in runs), sum(r["errs"][t][k][1] for r in runs))
                        for k in range(len(r0["errs"][t]))]
            rel = [(d / max(n, 1e-30)) ** 0.5 for d, n in per_leaf]
            errs[t] = max(rel)
            worst[t] = r0["paths"][rel.index(errs[t])]
            leaves_ok = leaves_ok and all(e <= ma_leaf_tol(spec, p, tol)
                                          for e, p in zip(rel, r0["paths"]))
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(r0["metrics"], r0["ref_metrics"]))
        by_d = {}
        for r in runs:
            by_d.setdefault(r["coords"][0], []).append(r["digest"])
        bitwise = all(all(x == g[0] for x in g) for g in by_d.values())
        metrics_equal = all(r["metrics"] == r0["metrics"] for r in runs)
        held_ok = all(a == b for r in runs for a, b in r["held"])
        reached = ma_reached(r0["counts"], kind, mode, sync)
        ar = r0["counts"].get("all_reduce", {})
        tp_bytes = sum(c["bytes"] for t, c in ar.items() if t.startswith("tp:")) / spec["steps"]
        row = {"phase": "model-axis", "row": spec["row"], "mesh": list(spec["mesh"]),
               "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
               "batch": spec["batch"], "seq_len": spec["seq"], "kind": kind, "mode": label,
               "backend": r0["backend"], "route": r0["route"],
               "losses": [m["loss"] for m in r0["metrics"]], "loss_rel_err": loss_err,
               "max_leaf_rel_err": errs, "max_leaf": worst, "limit_rel": tol,
               "limit_rel_per_head_leaves": spec.get("head_tol", tol),
               "shared_leaves_bitwise": bitwise, "metrics_equal_on_ranks": metrics_equal,
               "model_cut_leaves": len(r0["model_cut"]), "held_exact": held_ok,
               "segmented_leaves": r0.get("segmented", 0),
               "reached": reached, "tp_allreduce_bytes_per_step": tp_bytes,
               "step_ms_by_rank": [r["step_ms"] for r in runs],
               "step_ms_one_process": r0["ref_step_ms"],
               "collectives": {k: {"calls": sum(c["calls"] for c in t.values()),
                                   "bytes": sum(c["bytes"] for c in t.values())}
                               for k, t in r0["counts"].items()}}
        ok = (leaves_ok and loss_err <= tol and bitwise and metrics_equal
              and held_ok and all(reached.values()) and (kind == "fsdp" or row["model_cut_leaves"]))
        if kind in ("ssm", "hybrid"):  # the fused SSM leaves take the segmented cut
            ok = ok and row["segmented_leaves"] > 0
        if on_card:  # every kernel of the run's path launched on every rank
            need = ["rmsnorm"]
            if cfg.d_ff > 0 or cfg.moe is not None:
                need += ["swiglu", "swiglu_bwd"]
            if any(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)):
                need.append("flash_attention")
            if (cfg.moe is None or cfg.ssm is not None) and mode != "off":
                need.append("lowrank_wgrad")
            if kind in ("ssm", "hybrid"):
                need += list(SPLIT_NORM)
            row["launches_by_rank"] = [r["launches"] for r in runs]
            ok = ok and all(r["launches"][n] > 0 for r in runs for n in need)
        if kind == "tp":
            want = ma_tp_bytes(cfg, spec["batch"] // D, spec["seq"], mode)
            row["tp_allreduce_bytes_want"] = want
            ok = ok and tp_bytes == want
        if cfg.moe is not None:  # only the all-to-all's decisions may differ, at a near-tie
            gap = max(r["routing_differs"][2] for r in runs)
            differ = sum(r["routing_differs"][0] for r in runs)
            forced = kind in MA_FORCED_KINDS
            row["routing"] = {"differ": differ,
                              "decisions": sum(r["routing_differs"][1] for r in runs),
                              "forced_onto_reference": forced, "max_rel_gap": gap,
                              "limit_rel_gap": MA_TIE_GAP if forced else 0.0}
            ok = ok and (gap <= MA_TIE_GAP if forced else differ == 0)
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            fails.append(f"({spec['row']}) {kind} {label}")


def ma_leaf_tol(spec: dict, path: str, tol: float) -> float:
    """A leaf's limit: ``spec["head_tol"]`` for the SSM's per-head leaves
    (``A_log``, ``D``, ``dt_bias``: sums over every position that cancel,
    phase 15's SSM_F32_LEAF_TOL), where the spec sets one, else ``tol``."""
    if path.endswith((".A_log", ".D", ".dt_bias")):
        return spec.get("head_tol", tol)
    return tol


def ma_spawn(dev, tmp: str, specs: list) -> list:
    """Spawn one phase 19 mesh for ``specs`` (all on that mesh); each
    spec's ranks' results."""
    from repro_torch.launch.dist import spawn

    D, M = specs[0]["mesh"]
    t0 = time.perf_counter()
    spawn(ma_rank, D * M, tmp, specs, backend="gloo", device=dev.type, model=M,
          timeout=MA_TIMEOUT_S)
    out = [[torch.load(os.path.join(tmp, f"{spec['tag']}.rank{r}.pt"), weights_only=False)
            for r in range(D * M)] for spec in specs]
    emit({"phase": "model-axis", "row": " + ".join(spec["row"] for spec in specs) + " spawn",
          "mesh": [D, M], "seconds": time.perf_counter() - t0,
          "launches_by_rank": [[r["launches"] for r in ranks] for ranks in out]})
    return out


def ma_kernel_rows(dev, timer) -> None:
    """#2, #3, #4 and #6 at the TP-local shapes phase 19 launches (llama-350m
    at M = 2: 8 of 16 heads, S/2 rows under SP, 1368 of 2736 FFN columns,
    w_down's partial factor over 1368 rows), each against its plain
    version in bf16 and f32 with its cold time, bound and library call;
    #2 and #6 in turns against SDPA and ``multi_dot`` in bf16."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(19)
    B, S, H, hd, D, FF, r = TRAIN_B, TRAIN_S, 8, 64, 1024, 1368, TRAIN_RANK
    T = B * S
    pairs = B * H * S * (S + 1) // 2
    for dt in (torch.bfloat16, torch.float32):
        es = torch.finfo(dt).bits // 8

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        q, k, v = (randn(B, S, H, hd) for _ in range(3))
        compare("flash_attention", dt, [B, S, H, H, hd], flash_attention(q, k, v),
                flash_attention_plain(q, k, v), timer, lambda: flash_attention(q, k, v),
                lambda: flash_attention_plain(q, k, v), 4 * nbytes(q), 4.0 * hd * pairs,
                sdpa_call(q, k, v))
        if dt == torch.bfloat16:
            turns("flash_attention", [B, S, H, H, hd], timer, lambda: flash_attention(q, k, v),
                  sdpa_call(q, k, v), path="model axis")
        del q, k, v
        x, sc = randn(T // 2, D), randn(D)
        compare("rmsnorm", dt, [T // 2, D], rmsnorm(x, sc, 1e-5), rmsnorm_plain(x, sc, 1e-5),
                timer, lambda: rmsnorm(x, sc, 1e-5), lambda: rmsnorm_plain(x, sc, 1e-5),
                2 * x.numel() * es + D * es, 4.0 * x.numel(),
                lambda: F.rms_norm(x, (D,), sc, 1e-5))
        g, u = randn(T, FF), randn(T, FF)
        compare("swiglu", dt, [T, FF], swiglu(g, u), swiglu_plain(g, u), timer,
                lambda: swiglu(g, u), lambda: swiglu_plain(g, u), 3 * g.numel() * es,
                5.0 * g.numel())
        del g, u, x
        for n, m in ((D, FF), (FF, D)):
            xx, dy, v1 = randn(T, n), randn(T, m), randn(n, r)
            compare_rel("lowrank_wgrad", dt, [T, n, m, r], lowrank_wgrad_project(xx, dy, v1),
                        lowrank_wgrad_project_plain(xx, dy, v1), timer,
                        lambda: lowrank_wgrad_project(xx, dy, v1),
                        lambda: lowrank_wgrad_project_plain(xx, dy, v1),
                        nbytes(xx, dy, v1) + r * m * 4, 2.0 * T * r * (n + m),
                        lambda: torch.linalg.multi_dot([v1.T, xx.T, dy]))
            if dt == torch.bfloat16:
                turns("lowrank_wgrad", [T, n, m, r], timer,
                      lambda: lowrank_wgrad_project(xx, dy, v1),
                      lambda: torch.linalg.multi_dot([v1.T, xx.T, dy]), path="model axis")
            del xx, dy, v1


def model_axis_phase(dev, timer) -> dict:
    """Phase 19.  Returns the launches of each rank of its paths."""
    t0 = time.perf_counter()
    free_card("model-axis", 60)
    ma_kernel_rows(dev, timer)
    free_card("model-axis", 60)
    full = get_config(TRAIN_CONFIG)
    dense = dataclasses.replace(full, n_layers=MA_LAYERS, dtype="float32")
    moe_full = get_config(MOE_CONFIG)
    moe = dataclasses.replace(moe_full, n_layers=MA_MOE_LAYERS, dtype="float32")
    mamba = dataclasses.replace(get_config(SSM_CONFIG), n_layers=MESH_CELL_LAYERS,
                                dtype="float32")
    jamba = reduced(get_config(HYBRID_CONFIG), dtype="float32")
    jamba = dataclasses.replace(jamba, moe=dataclasses.replace(jamba.moe, capacity_factor=8.0))
    fails, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(dense, torch.Generator(device=dev).manual_seed(1), dev)
        proj = refresh_projections(params, dense, TRAIN_RANK)
        init = os.path.join(tmp, "init.pt")
        torch.save(tree_map(lambda t: t.cpu(), {"params": params, "proj": proj}), init)
        del params, proj
        torch.cuda.empty_cache()
        specs = [
            dict(tag="a", row="a: tp (1, 2)", mesh=(1, 2), cfg=dense, batch=TRAIN_B, seq=TRAIN_S,
                 steps=MA_STEPS, runs=MA_RUNS, plan=MESH_PLAN, init=init,
                 trainer_cfg=reduced(full, dtype="float32")),
            dict(tag="b", row="b: tp + fsdp (2, 2)", mesh=(2, 2), cfg=dense, batch=TRAIN_B,
                 seq=TRAIN_S, steps=MA4_STEPS, runs=MA4_RUNS, plan=MESH_PLAN, init=init),
            dict(tag="c", row="c: ep (1, 2)", mesh=(1, 2), cfg=moe, batch=MA_MOE_B, seq=TRAIN_S,
                 steps=MA_MOE_STEPS, runs=MA_MOE_RUNS, plan=MA_MOE_PLAN, init=None,
                 stagger=True),
            dict(tag="e", row="e: ssm (1, 2)", mesh=(1, 2), cfg=mamba, batch=SSM_MA_B,
                 seq=SSM_MA_S, steps=SSM_MA_STEPS, runs=SSM_MA_RUNS, plan=SSM_MA_PLAN,
                 init=None, head_tol=SSM_F32_LEAF_TOL),
            dict(tag="f", row="f: hybrid (1, 2)", mesh=(1, 2), cfg=jamba, batch=HYBRID_B,
                 seq=HYBRID_S, steps=HYBRID_MA_STEPS, runs=HYBRID_MA_RUNS, plan=MOE_TRAIN_PLAN,
                 init=None, tol=SSM_F32_LEAF_TOL),
        ]
        # one spawn a mesh shape: the (1, 2) specs share theirs
        spawns = [[sp for sp in specs if sp["mesh"] == (1, 2)],
                  [sp for sp in specs if sp["mesh"] == (2, 2)]]
        for group in spawns:
            for spec, ranks in zip(group, ma_spawn(dev, tmp, group)):
                ma_gate(spec, ranks, fails, dev.type == "cuda")
                for r, res in enumerate(ranks):
                    out[f"model-axis {spec['mesh']} {spec['tag']} rank {r}"] = res["launches"]
                if "trainer" in ranks[0]:
                    tr = [x["trainer"] for x in ranks]
                    ok = (all(t["agreed"] and not t["own_verify"] for t in tr)
                          and tr[0]["losses"] == tr[1]["losses"] and tr[0]["model_cut"] > 0)
                    emit({"phase": "model-axis", "row": "d: trainer (1, 2)", "trace": MR_TRACE,
                          "config": f"reduced {full.name} float32", "steps": tr[0]["steps"],
                          "replay": "REPLAY OK" if ok else "REPLAY MISMATCH",
                          "agreed": [t["agreed"] for t in tr], "final_loss": tr[0]["losses"][-1],
                          "model_cut_leaves": tr[0]["model_cut"],
                          "wall_s": [t["wall_s"] for t in tr],
                          "launches": [t["launches"] for t in tr], "ok": ok})
                    if not ok:
                        fails.append("(d) trainer replay")
                del ranks
    emit({"phase": "model-axis", "run": "phase", "seconds": time.perf_counter() - t0})
    if fails:
        raise AssertionError(f"model-axis: {fails}")
    return out


# Phase 20: the prefill and decode steps under a (data, model) mesh.  Gloo
# ranks share the card with CUDA tensors (host-staged), so no time here is a
# measure of NCCL or of tensor parallelism's speed.
MS_CONFIG, MS_BIG = "qwen3-0.6b", "glm4-9b"
MS_B, MS_PROMPT, MS_NEW = 4, 256, 16
MS_F32_TOL = 1e-4  # logits and cache rows, max |Δ| against the one-process f32 run
# a greedy id of the mesh may differ from the reference's only where the
# reference's top-2 logits lie within this of each other (a near-tie)
MS_TIE_GAP = 1e-4
MS_BF16_MAX, MS_BF16_MEAN = 2.0 ** -3, 2.0 ** -5  # of max |logit| / mean |logit|
MS_MOE_LAYERS = 1
MS_TIMEOUT_S = 600
MS_SEED = 1
# (H, KV) of a rank's attention: qwen3-0.6b at M = 2; glm4-9b's (one shared
# KV head) and qwen3-moe-30b-a3b's at M = 4; head_dim 128
MS_HEADS = ((8, 4), (8, 1))
MS_KERNELS = SERVE_KERNELS + SPLIT_NORM


def ms_held_cache(cfg, tp, key: str, want: torch.Tensor) -> torch.Tensor:
    """The part of a one-process cache leaf (n_periods, rows, ...) a rank
    holds: the KV heads its query heads read; where the model axis cuts the
    SSM mixer its SSD heads and its conv window's ``[x_m | B | C]``
    channels."""
    if key in ("k", "v"):
        return want[:, :, :, ms_kv_index(cfg, tp)]
    if tp is None or not tp.ssm:
        return want
    if key == "ssd":
        return want.chunk(tp.size, dim=2)[tp.rank]
    d_inner = cfg.ssm.expand * cfg.d_model
    q = d_inner // tp.size
    return torch.cat([want[..., tp.rank * q:(tp.rank + 1) * q], want[..., d_inner:]], dim=-1)


def ms_prompts(cfg, prompt: int) -> np.ndarray:
    return np.random.default_rng(20).integers(0, cfg.vocab_size, (MS_B, prompt), dtype=np.int32)


def ms_steps(cfg, mesh, parallel, prompt: int, new: int):
    """The prefill and decode steps of the phase's cell on ``mesh``: MS_B
    prompts of ``prompt`` tokens into caches of ``prompt + new``."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    pstep, _ = make_prefill_step(cfg, parallel, mesh, ShapeConfig("ms", prompt, MS_B, "prefill"),
                                 max_len=prompt + new)
    dstep, _ = make_decode_step(cfg, parallel, mesh, ShapeConfig("ms", prompt + new, MS_B,
                                                                 "decode"))
    return pstep, dstep


def ms_run(pstep, dstep, params, cfg, toks, new: int, forced=None, counts=None) -> dict:
    """A prefill of ``toks`` then ``new`` decode steps, fed the given ids
    (``forced``: the reference's, teacher-forced) or their own greedy ids.
    Returns per step the logits and own greedy ids, the caches, and with
    ``counts`` the collectives' counts of the prefill and of decode step 0."""
    from repro_torch.parallel import collectives

    tp = pstep.model_axis
    collectives.reset_counts()
    caches, logits = pstep(params, {"tokens": toks})
    out = {"logits": [logits], "own": [greedy_token(logits, cfg, tp)]}
    if counts is not None:
        counts["prefill"] = collectives.counts()
    for i in range(new):
        tok = out["own"][-1] if forced is None else forced[i]
        collectives.reset_counts()
        caches, logits = dstep(params, caches, tok, toks.shape[1] + i)
        if counts is not None and i == 0:
            counts["decode"] = collectives.counts()
        out["logits"].append(logits)
        out["own"].append(greedy_token(logits, cfg, dstep.model_axis))
    out["caches"] = caches
    return out


def ms_reference(dev, cfg, tmp: str, tag: str, caches: bool, routing: bool = False) -> dict:
    """The one-process run (``make_prefill_step`` / ``make_decode_step``
    without a mesh: ``forward_prefill`` / ``forward_decode``) from the
    phase's seed, greedy; saved to ``<tag>.ref.pt`` for the ranks: logits,
    ids, each step's top-2 gap, the caches (with ``caches``) and the MoE
    layers' expert ids (with ``routing``)."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(MS_SEED), dev)
    pstep, dstep = ms_steps(cfg, None, None, MS_PROMPT, MS_NEW)
    t0 = time.perf_counter()
    with routing_log() as rlog:
        run = ms_run(pstep, dstep, params, cfg,
                     torch.from_numpy(ms_prompts(cfg, MS_PROMPT)).to(dev), MS_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    top2 = [lg[:, :cfg.vocab_size].topk(2, dim=-1).values for lg in run["logits"]]
    ref = {"logits": [lg.cpu() for lg in run["logits"]], "own": [t.cpu() for t in run["own"]],
           "gap": [(t[:, 0] - t[:, 1]).cpu() for t in top2], "wall_s": wall,
           "routing": [x.cpu() for x in rlog] if routing else None,
           "caches": tree_map(lambda t: t.cpu(), run["caches"]) if caches else None}
    path = os.path.join(tmp, f"{tag}.ref.pt")
    torch.save(ref, path)
    del params, run, pstep, dstep
    torch.cuda.empty_cache()
    return {"path": path, "wall_s": wall}


def ms_tp_bytes(cfg, rows: int, seq: int, es: int) -> int:
    """The model axis's all-reduce bytes (tags ``tp:``) of one forward over
    ``rows`` x ``seq`` positions with heads, FFN and vocab cut: the
    embedding's lookup, each layer's attention and FFN outputs, (rows, seq,
    d) each."""
    return (2 * cfg.n_layers + 1) * rows * seq * cfg.d_model * es


def ms_kv_index(cfg, tp) -> list:
    """The KV heads a rank's cache holds, by index (``local_kv``'s rule)."""
    KV, H = cfg.n_kv_heads, cfg.n_heads
    if tp is None or not tp.heads:
        return list(range(KV))
    if tp.kv:
        n = KV // tp.size
        return list(range(tp.rank * n, (tp.rank + 1) * n))
    g, hl = H // KV, H // tp.size
    h0 = tp.rank * hl
    if hl % g == 0:
        return list(range(h0 // g, h0 // g + hl // g))
    if g % hl == 0:
        return [h0 // g]
    return [(h0 + i) // g for i in range(hl)]


def ms_rank_cell(mesh, dev, cell: dict) -> dict:
    """One cell of a phase 20 spawn on this rank: its slices built leaf by
    leaf from the seed, the steps teacher-forced with the reference's ids;
    its logits, own ids and caches held against the reference's rows,
    vocabulary columns and KV heads."""
    cfg, prompt, new = cell["cfg"], cell["prompt"], cell["new"]
    parallel = ParallelConfig(fsdp=mesh.sizes[0] > 1)
    pstep, dstep = ms_steps(cfg, mesh, parallel, prompt, new)
    lay, tp, rows = pstep.layout, pstep.model_axis, pstep.rows
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(MS_SEED), dev, layout=lay)
    held = [(list(x.shape), list(lay.local_shape(k))) for k, x in enumerate(tree_leaves(params))]
    ref = torch.load(cell["ref"], weights_only=False)
    forced = [t[rows].to(dev) for t in ref["own"][:new]]
    toks = torch.from_numpy(ms_prompts(cfg, prompt)).to(dev)
    counts = {}
    reset_launches()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    # the reference's expert ids of this rank's tokens: the prefill's MoE
    # layers first (rows x prompt tokens), then each decode step's (rows)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers)) if cfg.moe else 0
    ids = [x[rows.start * prompt:rows.stop * prompt] if i < n_moe else x[rows]
           for i, x in enumerate(ref["routing"] or [])]
    with ma_forced_routing([x.to(dev) for x in ids], False) as routed:
        run = ms_run(pstep, dstep, params, cfg, toks, new, forced=forced, counts=counts)
    sync()
    wall = time.perf_counter() - t0
    launches = {n: WRAPPERS[n].launches for n in MS_KERNELS}
    V = run["logits"][0].shape[-1]
    cols = slice(tp.rank * V, (tp.rank + 1) * V) if tp is not None and tp.vocab else slice(None)
    err = {"max": 0.0, "sum": 0.0, "ref_sum": 0.0, "ref_max": 0.0, "n": 0}
    own_differ, near_ties = 0, []
    for i, lg in enumerate(run["logits"]):
        r = ref["logits"][i][rows, cols].to(dev)
        real = (torch.arange(V, device=dev) + (cols.start or 0)) < cfg.vocab_size
        d = (lg - r)[:, real].abs()
        err["max"] = max(err["max"], float(d.max()))
        err["sum"] += float(d.double().sum())
        err["ref_sum"] += float(r[:, real].abs().double().sum())
        err["ref_max"] = max(err["ref_max"], float(r[:, real].abs().max()))
        err["n"] += d.numel()
        want = ref["own"][i][rows].to(dev)
        got = run["own"][i]
        for b in torch.nonzero(got != want).flatten().tolist():
            own_differ += 1
            near_ties.append([i, rows.start + b, float(ref["gap"][i][rows.start + b])])
    cache_err = None
    cache_ref = None
    if ref["caches"] is not None:
        cache_err, cache_ref = 0.0, 0.0
        for got_e, want_e in zip(run["caches"], ref["caches"]):
            for k in got_e:
                w = ms_held_cache(cfg, tp, k, want_e[k][:, rows]).to(dev)
                cache_err = max(cache_err, float((got_e[k].float() - w.float()).abs().max()))
                cache_ref = max(cache_ref, float(w.float().abs().max()))
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    tp_bytes = {p: sum(c["bytes"] for t, c in counts[p].get("all_reduce", {}).items()
                       if t.startswith("tp:")) for p in ("prefill", "decode")}
    n_rows = rows.stop - rows.start
    cut_all = tp is not None and tp.heads and tp.mlp and tp.vocab and cfg.ssm is None
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "coords": mesh.coords, "rows": [rows.start, rows.stop],
           "model_axis": None if tp is None else {
               "heads": tp.heads, "kv": tp.kv, "mlp": tp.mlp, "vocab": tp.vocab,
               "expert": tp.expert, "ssm": tp.ssm, "kv_heads_held": len(ms_kv_index(cfg, tp))},
           "held": held, "logit_err": err, "cache_max_abs_err": cache_err,
           "cache_ref_max_abs": cache_ref,
           "own_ids_differ": own_differ, "differ_at": near_ties,
           "tp_allreduce_bytes": tp_bytes, "launches": launches, "wall_s": wall,
           "route": mesh.model_comm.route, "backend": mesh.model_comm.backend,
           "routing_differs": routed if ref["routing"] else None}
    if cut_all and cfg.moe is None:
        out["tp_allreduce_bytes_want"] = {"prefill": ms_tp_bytes(cfg, n_rows, prompt, es),
                                          "decode": ms_tp_bytes(cfg, n_rows, 1, es)}
    del params, run, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ms_rank(mesh, tmp: str, spec: dict) -> None:
    """One rank of a phase 20 spawn: each cell of ``spec`` in turn; writes
    ``<tag>.rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = [ms_rank_cell(mesh, mesh.device, cell) for cell in spec["cells"]]
    torch.save(out, os.path.join(tmp, f"{spec['tag']}.rank{mesh.rank}.pt"))


def ms_gate(spec: dict, ranks: list, fails: list, on_card: bool) -> None:
    """Emit and gate each cell of a phase 20 spawn from its ranks'
    results."""
    for i, cell in enumerate(spec["cells"]):
        runs = [r[i] for r in ranks]
        r0 = runs[0]
        cfg = cell["cfg"]
        err = {"max": max(r["logit_err"]["max"] for r in runs),
               "mean": sum(r["logit_err"]["sum"] for r in runs) / sum(r["logit_err"]["n"]
                                                                     for r in runs),
               "ref_max": max(r["logit_err"]["ref_max"] for r in runs),
               "ref_mean": sum(r["logit_err"]["ref_sum"] for r in runs) / sum(
                   r["logit_err"]["n"] for r in runs)}
        # the model ranks of a data row hold the same rows and ids: count one
        differ_at = [x for r in runs if r["coords"][1] == 0 for x in r["differ_at"]]
        held_ok = all(a == b for r in runs for a, b in r["held"])
        row = {"phase": "mesh-serve", "row": spec["row"], "mesh": list(spec["mesh"]),
               "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
               "batch": MS_B, "prompt": cell["prompt"], "new_tokens": cell["new"],
               "backend": r0["backend"], "route": r0["route"], "model_axis": r0["model_axis"],
               "logits_max_abs_err": err["max"], "logits_mean_abs_err": err["mean"],
               "ref_max_abs_logit": err["ref_max"], "ref_mean_abs_logit": err["ref_mean"],
               "cache_max_abs_err": max((r["cache_max_abs_err"] or 0.0) for r in runs),
               "cache_ref_max_abs": max((r["cache_ref_max_abs"] or 0.0) for r in runs),
               "own_ids_differ": len(differ_at), "differ_at_step_row_ref_gap": differ_at,
               "held_exact": held_ok, "wall_s_by_rank": [r["wall_s"] for r in runs],
               "tp_allreduce_bytes_by_rank": [r["tp_allreduce_bytes"] for r in runs]}
        ok = held_ok
        routed_apart = cfg.moe is not None and sum(r["routing_differs"][0] for r in runs) > 0
        if cfg.dtype == "float32":  # ids differ only at near-ties; bf16's are reported
            lim = {"logits": MS_F32_TOL, "caches": MS_F32_TOL}
            if cfg.ssm is not None:  # phase 16's SSM scale: the scan's f32 decays
                lim = {"logits": SSM_F32_LOGIT_REL * err["ref_max"],
                       "caches": SSM_F32_LOGIT_REL * row["cache_ref_max_abs"]}
            row["limit"], row["limit_ref_gap"] = lim, MS_TIE_GAP
            ok = ok and all(gap <= MS_TIE_GAP for _, _, gap in differ_at)
            if not routed_apart:  # a near-tie routed apart moves that token's logits
                ok = (ok and err["max"] <= lim["logits"]
                      and row["cache_max_abs_err"] <= lim["caches"])
        else:
            row["limits"] = {"max": MS_BF16_MAX * err["ref_max"],
                             "mean": MS_BF16_MEAN * err["ref_mean"]}
            ok = ok and err["max"] <= row["limits"]["max"] and err["mean"] <= row["limits"]["mean"]
        if "tp_allreduce_bytes_want" in r0:
            row["tp_allreduce_bytes_want"] = [r["tp_allreduce_bytes_want"] for r in runs]
            ok = ok and all(r["tp_allreduce_bytes"] == r["tp_allreduce_bytes_want"] for r in runs)
        if cfg.moe is not None:  # EP under tp_fsdp routes the reference's tokens in its order
            differ = sum(r["routing_differs"][0] for r in runs)
            gap = max(r["routing_differs"][2] for r in runs)
            row["routing"] = {"differ": differ,
                              "decisions": sum(r["routing_differs"][1] for r in runs),
                              "max_rel_gap": gap, "limit_rel_gap": MA_TIE_GAP}
            ok = ok and (differ == 0 or gap <= MA_TIE_GAP)
        if cfg.ssm is not None:  # the mixer cut by its heads on every rank
            ok = ok and all(r["model_axis"]["ssm"] for r in runs)
        if on_card:  # every kernel of the path launched on every rank
            row["launches_by_rank"] = [r["launches"] for r in runs]
            need = ["rmsnorm"]
            if cfg.d_ff > 0 or cfg.moe is not None:
                need.append("swiglu")
            if any(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)):
                need += ["flash_attention", "flash_decode"]
            if cfg.ssm is not None:
                need += list(SPLIT_NORM)
            ok = ok and all(r["launches"][n] > 0 for r in runs for n in need)
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            fails.append(f"({spec['row']}) {cfg.name}")


def ms_spawn(dev, tmp: str, spec: dict) -> list:
    """Spawn one phase 20 mesh; its ranks' results."""
    from repro_torch.launch.dist import spawn

    D, M = spec["mesh"]
    t0 = time.perf_counter()
    spawn(ms_rank, D * M, tmp, spec, backend="gloo", device=dev.type, model=M,
          timeout=MS_TIMEOUT_S)
    ranks = [torch.load(os.path.join(tmp, f"{spec['tag']}.rank{r}.pt"), weights_only=False)
             for r in range(D * M)]
    emit({"phase": "mesh-serve", "row": f"{spec['row']} spawn", "mesh": list(spec["mesh"]),
          "seconds": time.perf_counter() - t0})
    return ranks


def ms_nccl_row(dev, tmp: str) -> dict:
    """(a): one NCCL rank at (1, 1): the steps on full-width, full-depth
    qwen3-0.6b in bf16, greedy, against ``forward_prefill`` /
    ``forward_decode`` called directly: ids, logits and every cache leaf
    bitwise.  Returns the mesh run's launches."""
    from repro_torch.launch.dist import destroy, init_process_group

    cfg = get_config(MS_CONFIG)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(MS_SEED), dev)
    toks = torch.from_numpy(ms_prompts(cfg, MS_PROMPT)).to(dev)
    with torch.no_grad():
        caches, logits = forward_prefill(params, {"tokens": toks}, cfg,
                                         cache_structs(cfg, MS_B, MS_PROMPT + MS_NEW))
        ref = {"logits": [logits], "own": [greedy_token(logits, cfg)]}
        for i in range(MS_NEW):
            caches, logits = forward_decode(params, caches, ref["own"][-1], MS_PROMPT + i, cfg)
            ref["logits"].append(logits)
            ref["own"].append(greedy_token(logits, cfg))
    mesh = init_process_group(0, 1, init_method="file://" + os.path.join(tmp, "nccl"),
                              backend="nccl", device=dev)
    try:
        pstep, dstep = ms_steps(cfg, mesh, ParallelConfig(), MS_PROMPT, MS_NEW)
        reset_launches()
        run = ms_run(pstep, dstep, params, cfg, toks, MS_NEW)
        launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
        backend = mesh.comm.backend
    finally:
        destroy()
    ids = all(torch.equal(a, b) for a, b in zip(run["own"], ref["own"]))
    lg = all(torch.equal(a, b) for a, b in zip(run["logits"], ref["logits"]))
    leaves = [torch.equal(a[k], b[k]) for a, b in zip(run["caches"], caches) for k in a]
    need = ("rmsnorm", "swiglu", "flash_attention", "flash_decode")
    ok = ids and lg and all(leaves) and all(launches[n] > 0 for n in need)
    emit({"phase": "mesh-serve", "row": "a: nccl, one rank (1, 1)", "config": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": MS_B, "prompt": MS_PROMPT,
          "new_tokens": MS_NEW, "backend": backend, "ids_bitwise": ids, "logits_bitwise": lg,
          "cache_leaves": len(leaves), "cache_leaves_bitwise": sum(leaves),
          "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"mesh-serve (a): ids {ids}, logits {lg}, caches "
                             f"{sum(leaves)}/{len(leaves)}, launches {launches}")
    del params, caches, run, ref
    return launches


def ms_kernel_rows(dev, timer) -> None:
    """#2 and #5 at the head shapes phase 20's ranks launch (MS_HEADS: H 8
    with KV 4, and with one KV head; hd 128) on its prefill's (4, 256) and
    its last decode step's 272 positions, bf16, each against its plain
    version with its cold time, bound and SDPA call."""
    gen = torch.Generator(device=dev).manual_seed(24)
    dt, es, hd = torch.bfloat16, 2, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    L = MS_PROMPT + MS_NEW
    for h, kv in MS_HEADS:
        q, k, v = randn(MS_B, MS_PROMPT, h, hd), randn(MS_B, MS_PROMPT, kv, hd), \
            randn(MS_B, MS_PROMPT, kv, hd)
        pairs = MS_B * h * MS_PROMPT * (MS_PROMPT + 1) // 2
        compare("flash_attention", dt, [MS_B, MS_PROMPT, h, kv, hd], flash_attention(q, k, v),
                flash_attention_plain(q, k, v), timer, lambda: flash_attention(q, k, v),
                lambda: flash_attention_plain(q, k, v), 2 * nbytes(q) + 2 * nbytes(k),
                4.0 * hd * pairs, sdpa_call(q, k, v))
        qd = randn(MS_B, 1, h, hd)
        kd, vd = randn(MS_B, L, kv, hd), randn(MS_B, L, kv, hd)
        lens = torch.full((MS_B,), L, dtype=torch.int32, device=dev)
        compare("flash_decode", dt, [MS_B, L, h, kv, hd], flash_decode(qd, kd, vd, lens),
                flash_decode_plain(qd, kd, vd, lens), timer,
                lambda: flash_decode(qd, kd, vd, lens), lambda: flash_decode_plain(qd, kd, vd, lens),
                2 * nbytes(qd) + 2 * MS_B * L * kv * hd * es + nbytes(lens),
                4.0 * h * hd * MS_B * L, sdpa_decode_call(qd, kd, vd, lens))
        del q, k, v, qd, kd, vd


def mesh_serve_phase(dev, timer) -> dict:
    """Phase 20.  Returns the launches of its NCCL run and of each rank."""
    t0 = time.perf_counter()
    free_card("mesh-serve", 60)
    ms_kernel_rows(dev, timer)
    fails, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        out["mesh serve"] = ms_nccl_row(dev, tmp)
        free_card("mesh-serve", 60)
        qwen = dataclasses.replace(get_config(MS_CONFIG), dtype="float32")
        moe = dataclasses.replace(get_config(MOE_CONFIG), n_layers=MS_MOE_LAYERS,
                                  dtype="float32")
        big = get_config(MS_BIG)
        mamba = dataclasses.replace(get_config(SSM_CONFIG), n_layers=MESH_CELL_LAYERS,
                                    dtype="float32")
        jamba = reduced(get_config(HYBRID_CONFIG), dtype="float32")
        jamba = dataclasses.replace(jamba, moe=dataclasses.replace(jamba.moe,
                                                                   capacity_factor=8.0))
        lens = dict(prompt=MS_PROMPT, new=MS_NEW)
        refs = {"qwen": ms_reference(dev, qwen, tmp, "qwen", caches=True)["path"],
                "moe": ms_reference(dev, moe, tmp, "moe", caches=True, routing=True)["path"],
                "mamba": ms_reference(dev, mamba, tmp, "mamba", caches=True)["path"],
                "jamba": ms_reference(dev, jamba, tmp, "jamba", caches=True,
                                      routing=True)["path"]}
        free_card("mesh-serve", 60)
        specs = [
            dict(tag="b12", row="b: tp (1, 2)", mesh=(1, 2),
                 cells=[dict(cfg=qwen, ref=refs["qwen"], **lens),
                        dict(cfg=moe, ref=refs["moe"], **lens),
                        dict(cfg=mamba, ref=refs["mamba"], **lens),
                        dict(cfg=jamba, ref=refs["jamba"], **lens)]),
            dict(tag="b22", row="b: tp + fsdp (2, 2)", mesh=(2, 2),
                 cells=[dict(cfg=qwen, ref=refs["qwen"], **lens)]),
        ]
        for spec in specs:
            ranks = ms_spawn(dev, tmp, spec)
            ms_gate(spec, ranks, fails, dev.type == "cuda")
            for r, res in enumerate(ranks):
                tot = {n: sum(c["launches"][n] for c in res) for n in MS_KERNELS}
                out[f"mesh serve {spec['mesh']} rank {r}"] = tot
        free_card("mesh-serve", 60)
        spec = dict(tag="c14", row="c: tp (1, 4), local_kv", mesh=(1, 4),
                    cells=[dict(cfg=big, ref=ms_reference(dev, big, tmp, "big",
                                                          caches=False)["path"], **lens)])
        free_card("mesh-serve", 60)
        ranks = ms_spawn(dev, tmp, spec)
        ms_gate(spec, ranks, fails, dev.type == "cuda")
        for r, res in enumerate(ranks):
            out[f"mesh serve {spec['mesh']} rank {r}"] = res[0]["launches"]
    emit({"phase": "mesh-serve", "run": "phase", "seconds": time.perf_counter() - t0})
    if fails:
        raise AssertionError(f"mesh-serve: {fails}")
    return out


# Phase 21: the production meshes' dry run and the pod axis.  (c)'s dry
# runs start after (a), on the CPU in processes of their own (no card in
# their sight), run beside (b), and are read at the end.
DRY_CELLS = (("qwen3-0.6b", "train_4k", "single"), ("nemotron-4-340b", "train_4k", "single"),
             ("jamba-1.5-large-398b", "decode_32k", "multi"))
DRY_MODES = ("off", "degraded")
DRY_PEAK_TOL = 0.15  # the dry run's peak against max_memory_allocated, relative
DRY_TIMEOUT_S = 900
POD_MESH = (2, 1, 2)  # (pod, data, model)
POD_CONFIG, POD_B, POD_S, POD_STEPS, POD_SEED = "qwen3-0.6b", 4, 256, 2, 2
POD_PLAN = NDBPlan(n_dp=2, n_stages=2, failed=frozenset({(1, 0)}))
POD_TIMEOUT_S = 600


class DryCells:
    """(c): one ``python -m repro_torch.launch.dryrun`` process a cell of
    DRY_CELLS, started at once, on the CPU only; :meth:`collect` waits for
    them and reads their records, :meth:`stop` ends any still running."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="dry_cells_")
        self.procs = []
        self.t0 = time.perf_counter()

    def start(self) -> "DryCells":
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src")]
                                              + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for arch, shape, mesh in DRY_CELLS:
            log = open(os.path.join(self.dir, f"{arch}.{shape}.log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh, "--out", self.dir, "--force"]
            self.procs.append((arch, shape, mesh, log,
                               subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log,
                                                stderr=subprocess.STDOUT)))
        return self

    def collect(self) -> list:
        out = []
        for arch, shape, mesh, log, p in self.procs:
            rc = p.wait(timeout=max(1.0, DRY_TIMEOUT_S - (time.perf_counter() - self.t0)))
            log.close()
            path = os.path.join(self.dir, f"{arch}__{shape}__{mesh}.json")
            rec = None
            if rc == 0 and os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            with open(log.name) as f:
                tail = f.read()[-2000:]
            out.append((arch, shape, mesh, rc, rec, tail))
        return out

    def stop(self) -> None:
        for *_, log, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def dry_count_rows(dev) -> dict:
    """(a): launch/cost.py over one real step of phase 7's cell on the card
    against the dry run of the same step on meta, in DRY_MODES: FLOPs, HBM
    bytes and launches by kernel equal; the dry peak within DRY_PEAK_TOL of
    max_memory_allocated; the step's ms, roofline ms and
    roofline_fraction reported.  Returns the launches of the counted
    steps."""
    from repro_torch.launch.cost import CostMode
    from repro_torch.launch.dryrun import dry_step
    from repro_torch.launch.roofline import RooflineReport, model_flops, summarize

    free_card("pod", 20)
    cell = train_cell(dev)
    cfg = cell.cfg
    # the cell's weights are the state's: no second copy on the card
    state = TrainState(step=0, params=cell.params, opt=init_opt_state(cell.params, cell.train),
                       proj=cell.proj)
    cell.params = None
    batch = to_device(cell.source().batch(0, TRAIN_B, TRAIN_S), dev)
    total = {n: 0 for n in TRAIN_KERNELS}
    fails = []
    for mode in DRY_MODES:
        step, ndb = cell.step(mode, dev)
        state, _ = step(state, batch, *ndb)  # warm: libraries loaded, handles made
        state, _, ms = mr_steps(step, state, [batch], ndb, dev)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        with CostMode((state, batch)) as counted:
            state, _ = step(state, batch, *ndb)
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated()
        launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
        card = counted.cost
        t0 = time.perf_counter()
        dry = dry_step(cfg, cell.shape, None, ndb=mode, mecefo=cell.mecefo, train=cell.train,
                       flags=TRAIN_FLAGS).cost
        dry_s = time.perf_counter() - t0
        rep = RooflineReport(arch=cfg.name, shape=f"B{TRAIN_B} S{TRAIN_S}", mesh="1x1",
                             n_devices=1, flops_per_dev=card.flops, bytes_per_dev=card.bytes,
                             collective_bytes_per_dev=0.0, collectives={},
                             model_flops_global=model_flops(cfg, cell.shape),
                             bytes_per_dev_peak=float(card.peak_bytes))
        roof_ms = 1e3 * max(rep.t_compute, rep.t_memory, rep.t_collective)
        peak_rel = abs(dry.peak_bytes - card_peak) / card_peak
        same = {"flops": card.flops == dry.flops, "bytes": card.bytes == dry.bytes,
                "launches": card.launches == dry.launches
                and {n: c for n, c in launches.items() if c} == dry.launches,
                "kernel_work": card.kernel_work == dry.kernel_work}
        ok = all(same.values()) and peak_rel <= DRY_PEAK_TOL
        emit({"phase": "pod", "row": "a: cost of a real step against the dry run",
              "config": cfg.name, "dtype": cfg.dtype, "batch": TRAIN_B, "seq_len": TRAIN_S,
              "mode": mode, "flops": card.flops, "dry_flops": dry.flops, "bytes": card.bytes,
              "dry_bytes": dry.bytes, "launches": card.launches, "dry_launches": dry.launches,
              "kernel_flops": card.kernel_flops, "kernel_bytes": card.kernel_bytes,
              "equal": same, "card_peak_bytes": card_peak, "dry_peak_bytes": dry.peak_bytes,
              "card_held_bytes_at_start": held, "dry_start_bytes": dry.start_bytes,
              "peak_rel_diff": peak_rel, "peak_limit_rel": DRY_PEAK_TOL, "step_ms": ms[0],
              "roofline_ms": roof_ms, "t_compute_ms": 1e3 * rep.t_compute,
              "t_memory_ms": 1e3 * rep.t_memory, "bottleneck": rep.bottleneck,
              "model_flops": rep.model_flops_global, "useful_flops_ratio": rep.useful_flops_ratio,
              "roofline_fraction": rep.roofline_fraction,
              "roofline_share_of_step": roof_ms / ms[0], "dry_seconds": dry_s,
              "summary": summarize(rep), "ok": ok})
        if not ok:
            fails.append(f"(a) {mode}: {same}, peak {dry.peak_bytes} vs {card_peak}")
        for n in TRAIN_KERNELS:
            total[n] += launches[n]
        del step
    del state, batch, cell
    if fails:
        raise AssertionError(f"pod: {fails}")
    return total


def pod_nccl_rows(dev, tmp: str) -> dict:
    """(b) one NCCL rank at the 1×1×1 pod mesh: POD_STEPS dynamic steps of
    phase 7's cell (FSDP) and a prefill with MS_NEW greedy decode steps of
    full-width qwen3-0.6b (bf16), bitwise the one-process steps.  Returns
    the launches of the mesh runs."""
    from repro_torch.launch.dist import destroy, init_process_group
    from repro_torch.launch.state import to_local

    free_card("pod", 20)
    cell = train_cell(dev)
    batches = [cell.source().batch(i, TRAIN_B, TRAIN_S) for i in range(POD_STEPS)]
    ndb = ({"keep": cell.keep, "example_weight": cell.weight},)
    ref_step, _ = cell.step("dynamic", dev)
    ref, ref_m, _ = mr_steps(ref_step, cell.state(), batches, ndb, dev)
    scfg = get_config(MS_CONFIG)
    params = init_params(scfg, torch.Generator(device=dev).manual_seed(MS_SEED), dev)
    toks = torch.from_numpy(ms_prompts(scfg, MS_PROMPT)).to(dev)
    with torch.no_grad():
        caches, logits = forward_prefill(params, {"tokens": toks}, scfg,
                                         cache_structs(scfg, MS_B, MS_PROMPT + MS_NEW))
        sref = {"logits": [logits], "own": [greedy_token(logits, scfg)]}
        for i in range(MS_NEW):
            caches, logits = forward_decode(params, caches, sref["own"][-1], MS_PROMPT + i, scfg)
            sref["logits"].append(logits)
            sref["own"].append(greedy_token(logits, scfg))
    mesh = init_process_group(0, 1, init_method="file://" + os.path.join(tmp, "pod_nccl"),
                              backend="nccl", device=dev, pod=1)
    try:
        step = make_train_step(cell.cfg, cell.train, cell.mecefo, cell.shape, ndb_mode="dynamic",
                               total_steps=cell.train.steps, flags=TRAIN_FLAGS, mesh=mesh,
                               parallel=ParallelConfig())
        reset_launches()
        state, metrics, _ = mr_steps(step, to_local(cell.state(), step.layout), batches, ndb,
                                     dev)
        train_launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
        pstep, dstep = ms_steps(scfg, mesh, ParallelConfig(), MS_PROMPT, MS_NEW)
        reset_launches()
        run = ms_run(pstep, dstep, params, scfg, toks, MS_NEW)
        serve_launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
        shape, backend = mesh.shape, mesh.world_comm.backend
    finally:
        destroy()
    pairs = list(zip(tree_leaves(state.params) + tree_leaves(state.opt.m)
                     + tree_leaves(state.opt.v),
                     tree_leaves(ref.params) + tree_leaves(ref.opt.m) + tree_leaves(ref.opt.v)))
    unequal = sum(not torch.equal(a, b) for a, b in pairs)
    ids = all(torch.equal(a, b) for a, b in zip(run["own"], sref["own"]))
    lg = all(torch.equal(a, b) for a, b in zip(run["logits"], sref["logits"]))
    leaves = [torch.equal(a[k], b[k]) for a, b in zip(run["caches"], caches) for k in a]
    launched = all(train_launches.values()) or dev.type != "cuda"  # plain on a CPU rehearsal
    ok = (unequal == 0 and metrics == ref_m and ids and lg and all(leaves) and launched
          and shape == {"pod": 1, "data": 1, "model": 1})
    emit({"phase": "pod", "row": "b: nccl, one rank (1, 1, 1)", "mesh": shape,
          "backend": backend, "train_config": cell.cfg.name, "steps": POD_STEPS,
          "leaves": len(pairs), "leaves_not_bitwise": unequal, "metrics_bitwise": metrics == ref_m,
          "serve_config": scfg.name, "ids_bitwise": ids, "logits_bitwise": lg,
          "cache_leaves_bitwise": f"{sum(leaves)}/{len(leaves)}",
          "train_launches": train_launches, "serve_launches": serve_launches, "ok": ok})
    if not ok:
        raise AssertionError(f"pod (b) nccl: {unequal} leaves differ, ids {ids}, logits {lg}, "
                             f"caches {sum(leaves)}/{len(leaves)}")
    del state, ref, params, caches, run, sref, cell
    return {**train_launches, **{f"serve {n}": c for n, c in serve_launches.items()}}


def pod_cell():
    cfg = dataclasses.replace(get_config(POD_CONFIG), n_layers=MESH_CELL_LAYERS,
                              dtype="float32")
    return (cfg, ShapeConfig("pod", POD_S, POD_B, "train"),
            MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK), TrainConfig(), TRAIN_FLAGS)


def pod_gloo_rank(mesh, tmp: str) -> None:
    """(b) one of the gloo ranks at POD_MESH: POD_STEPS dynamic steps from
    the seeded state, its slices against the one-process run's, its held
    bytes and its collectives by group."""
    from repro_torch.launch.state import to_local
    from repro_torch.parallel import collectives

    dev = mesh.device
    cfg, shape, mecefo, train, flags = pod_cell()
    init = tree_map(lambda t: t.to(dev),
                    torch.load(os.path.join(tmp, "pod_init.pt"), weights_only=False))
    step = make_train_step(cfg, train, mecefo, shape, ndb_mode="dynamic", flags=flags,
                           mesh=mesh, parallel=ParallelConfig())
    state = to_local(TrainState(step=0, params=init["params"],
                                opt=init_opt_state(init["params"], train), proj=init["proj"]),
                     step.layout)
    del init
    keep, w = plan_to_masks(POD_PLAN, cfg, POD_B)
    src = SyntheticLM(cfg.vocab_size)
    collectives.reset_counts()
    reset_launches()
    state, metrics, ms = mr_steps(step, state, [src.batch(i, POD_B, POD_S)
                                                for i in range(POD_STEPS)],
                                  ({"keep": keep, "example_weight": w},), dev)
    groups = collectives.group_counts()
    ref = torch.load(os.path.join(tmp, "pod_ref.pt"), weights_only=False)
    lay = step.layout
    errs = {}
    for part, mine, whole in (("params", state.params, ref["params"]),
                              ("m", state.opt.m, ref["m"]), ("v", state.opt.v, ref["v"])):
        cut = lay.map(lambda x, k: lay.cut(x.to(dev), k), whole)
        errs[part] = max(leaf_rel_errs(mine, cut))
    held = sum(t.numel() * t.element_size() for t in
               tree_leaves(state.params) + tree_leaves(state.opt.m) + tree_leaves(state.opt.v)
               + tree_leaves(state.proj))
    torch.save({"coord": mesh.coord, "metrics": metrics, "errs": errs, "held": held,
                "groups": groups, "rows": step.rows, "step_ms": ms,
                "route": mesh.comm_of(("pod",)).route,
                "launches": {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}},
               os.path.join(tmp, f"pod.rank{mesh.rank}.pt"))


def pod_gloo_rows(dev, tmp: str) -> dict:
    """(b) four gloo ranks sharing the card at POD_MESH, against the
    one-process step and the dry run's counts from the shapes.  Returns
    each rank's launches."""
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.dryrun import dry_step
    from repro_torch.launch.mesh import dry_mesh

    free_card("pod", 20)
    cfg, shape, mecefo, train, flags = pod_cell()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(POD_SEED), dev)
    state = TrainState(step=0, params=params, opt=init_opt_state(params, train),
                       proj=refresh_projections(params, cfg, TRAIN_RANK))
    torch.save(tree_map(lambda t: t.cpu(), {"params": params, "proj": state.proj}),
               os.path.join(tmp, "pod_init.pt"))
    keep, w = plan_to_masks(POD_PLAN, cfg, POD_B)
    step = make_train_step(cfg, train, mecefo, shape, ndb_mode="dynamic", flags=flags, device=dev)
    src = SyntheticLM(cfg.vocab_size)
    ref, ref_m, _ = mr_steps(step, state, [src.batch(i, POD_B, POD_S) for i in range(POD_STEPS)],
                             ({"keep": keep, "example_weight": w},), dev)
    torch.save(tree_map(lambda t: t.cpu(), {"params": ref.params, "m": ref.opt.m,
                                             "v": ref.opt.v}), os.path.join(tmp, "pod_ref.pt"))
    del params, state, ref, step
    torch.cuda.empty_cache()
    P, D, M = POD_MESH
    t0 = time.perf_counter()
    spawn(pod_gloo_rank, P * D * M, tmp, backend="gloo", device=dev.type, model=M, pod=P,
          timeout=POD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"pod.rank{r}.pt"), weights_only=False)
             for r in range(P * D * M)]
    tol = TRAIN_PARITY_TOL["float32"][0]
    fails = []
    for r, x in enumerate(ranks):
        dry = dry_step(cfg, shape, dry_mesh(P, D, M, rank=r), ndb="dynamic",
                       parallel=ParallelConfig(), mecefo=mecefo, train=train, flags=flags)
        want_groups = {k: {g: {"calls": POD_STEPS * e["calls"], "bytes": POD_STEPS * e["bytes"]}
                           for g, e in t.items()}
                       for k, t in dry.cost.collectives_by_group.items()}
        want_held = sum(v for k, v in dry.state_bytes.items() if k != "grads")
        ok = (max(x["errs"].values()) <= tol and x["metrics"] == ranks[0]["metrics"]
              and x["groups"] == want_groups and x["held"] == want_held)
        emit({"phase": "pod", "row": "b: gloo, four ranks on one card", "mesh": list(POD_MESH),
              "rank": r, "coord": x["coord"], "config": cfg.name, "n_layers": cfg.n_layers,
              "dtype": cfg.dtype, "batch": POD_B, "seq_len": POD_S, "rows": [x["rows"].start,
                                                                             x["rows"].stop],
              "route": x["route"], "losses": [m["loss"] for m in x["metrics"]],
              "max_leaf_rel_err": x["errs"], "limit_rel": tol, "held_bytes": x["held"],
              "held_bytes_from_shapes": want_held,
              "bytes_by_group": {k: {g: e["bytes"] for g, e in t.items()}
                                 for k, t in x["groups"].items()},
              "groups_equal_count_from_shapes": x["groups"] == want_groups,
              "step_ms": x["step_ms"], "launches": x["launches"], "ok": ok})
        if not ok:
            fails.append(f"(b) gloo rank {r}")
    emit({"phase": "pod", "row": "b: gloo spawn", "seconds": spawn_s})
    if fails:
        raise AssertionError(f"pod: {fails}")
    return {r: x["launches"] for r, x in enumerate(ranks)}


def dry_cell_rows(cells: DryCells) -> None:
    """(c): the dry runs' records: each summary line, state and peak."""
    fails = []
    for arch, shape, mesh, rc, rec, tail in cells.collect():
        ok = rc == 0 and rec is not None and "skipped" not in rec
        row = {"phase": "pod", "row": "c: dry run", "arch": arch, "shape": shape, "mesh": mesh,
               "rc": rc, "ok": ok}
        if rec is not None:
            row.update({k: rec.get(k) for k in (
                "n_devices", "state_bytes_per_dev", "peak_bytes_per_dev", "fits", "t_compute",
                "t_memory", "t_collective", "bottleneck", "useful_flops_ratio",
                "roofline_fraction", "seconds", "accum", "launches")})
            row["state_gib_per_dev"] = rec["state_bytes_per_dev"] / 2 ** 30
            row["peak_gib_per_dev"] = rec["peak_bytes_per_dev"] / 2 ** 30
            row["summary"] = (
                f"{arch:22s} {shape:12s} {mesh:6s} compute={rec['t_compute'] * 1e3:9.3f}ms "
                f"memory={rec['t_memory'] * 1e3:9.3f}ms coll={rec['t_collective'] * 1e3:9.3f}ms "
                f"-> {rec['bottleneck']:10s} useful={rec['useful_flops_ratio']:6.1%} "
                f"roofline={rec['roofline_fraction']:6.1%}")
        else:
            row["log_tail"] = tail
        emit(row)
        if not ok:
            fails.append(f"(c) {arch} {shape} {mesh}: rc {rc}")
    if fails:
        raise AssertionError(f"pod: {fails}")


def pod_phase(dev) -> dict:
    """Phase 21.  Returns the launches of each of its paths."""
    t0 = time.perf_counter()
    out = {"pod a: counted steps": dry_count_rows(dev)}
    cells = DryCells().start()  # (c), on the CPU beside (b), after every timed phase
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["pod b: nccl (1, 1, 1)"] = pod_nccl_rows(dev, tmp)
            gloo = pod_gloo_rows(dev, tmp)
        out.update({f"pod b: gloo {POD_MESH} rank {r}": c for r, c in gloo.items()})
        dry_cell_rows(cells)
    finally:
        cells.stop()
    emit({"phase": "pod", "run": "phase", "seconds": time.perf_counter() - t0,
          "dry_cells_wall_s": time.perf_counter() - cells.t0})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "sources": sorted(logs),
          "kernels_registers_spills": {n: ptxas_info(log) for n, log in logs.items()}})
    return run_phases(dev)


def run_phases(dev) -> int:
    timer = ColdTimer(dev)
    rows = kernel_phase(dev, timer)
    ssm_kernel_rows(dev, timer)
    rows.update(ssm_tp_kernel_rows(dev, timer))
    cfg, params, workload, launches = serve_phase(dev)
    chunk_share_phase(dev, cfg, params)
    parity_phase(dev, cfg, params, workload)
    del cfg, params, workload
    torch.cuda.empty_cache()
    # each kernel's launches from its own path: the paged serve run's for
    # #1-#4, the dense serve run's for #5, the training run's for #6 and
    # #4's backward
    train = train_phase(dev)
    launches["lowrank_wgrad"], launches["swiglu_bwd"] = train["lowrank_wgrad"], train["swiglu_bwd"]
    train_parity_phase(dev)
    trainer_phase(dev)
    statexfer_phase(dev)
    launches["paged_decode_q8"] = replicas_phase(dev)
    # phases 12-17 each count their own launches, gated there; they are
    # reported beside the main paths' counts, not added to them
    later = {"moe serve": moe_serve_phase(dev), "dense serve": dense_serve_phase(dev),
             "moe and config train steps": moe_train_phase(dev)}
    later["mamba2 train"], ssm_params = ssm_train_phase(dev)
    later["mamba2 decode"] = ssm_decode_phase(dev, ssm_params)
    del ssm_params
    later["hybrid"] = hybrid_phase(dev)
    later["accumulation"] = accum_phase(dev)
    later.update(multirank_phase(dev))
    later.update(model_axis_phase(dev, timer))
    later.update(mesh_serve_phase(dev, timer))
    later.update(pod_phase(dev))
    # #3's split form runs only where the model axis cuts the SSM mixer:
    # its main path is phase 19 (e), counted on both ranks
    for n in SPLIT_NORM:
        launches[n] = sum(c[n] for p, c in later.items() if p.startswith("model-axis (1, 2) e "))

    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/csrc/{KERNEL_SOURCES.get(n, n)}.cu",
         "replaces": REPLACES[n], "launches": launches[n],
         **{k: rows[(n, torch.bfloat16)][k] for k in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "launches_by_later_path": {p: c.get(n, 0) for p, c in later.items()}}
        for n in WRAPPERS
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
