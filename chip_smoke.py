"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure
    python3 chip_smoke.py --kernels  # phases 1-3, 6, 6c (a), (a') only: every
                                     # kernel check and time, no drive and
                                     # no result line

Phases:
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
  3. hold the paged-decode and flash-prefill kernels against their plain
     PyTorch versions in bf16 (``attn_check``: BF16_TOL, its absolute part
     capped at a tenth of the output's RMS) at the serving path's shapes (llama3.2-1b's
     GQA decode and 512-token prefill chunks; zamba2-1.2b's MHA decode and
     whole-prompt prefill), and time the kernel at each and the plain
     version and the library yardstick (SDPA) at llama's; hold the
     dense-cache decode kernel against its plain version at
     seamless-m4t-medium's decode shape, llama3.2-1b's long-context ring
     (some rows wrapped) and an MQA shape (48 heads of 128 over one kv
     head; the tensor-core instance, one block a kv head), and time it
     with SDPA at each; hold the flash op at seamless's three non-causal
     shapes (encoder self-attention over 4096 frames, a prompt's and one
     decode step's cross-attention over them: the last through the key
     split, the split-KV decode template with key positions) and time
     each, SDPA and the byte bound at the decode step's and the
     encoder's;
     each new shape with a flat draw (a wide softmax) and a peaked one
     (q scaled by 3: O(1) outputs that a wrong tile or rescale moves);
     hold the SSD scan kernel against its two plain versions (chunked and
     sequential) at the mamba2-2.7b and zamba2-1.2b prefill shapes, with
     short- and long-memory decays, check that end padding leaves its
     result bit-unchanged, and time it at both shapes beside the kernel it
     replaced (``tools/ssd_variants/scalar.cu``, built beside the
     package), its plain version and its byte and operation bounds; hold
     the partial (out, lse) paged
     kernel (fixed 64-row sub-splits) against its plain version stripe by
     stripe at qwen2-1.5b's tp = 4 shape (H12/KV2, dh 128) and
     llama3.2-1b's (H32/KV8, dh 64),
     2048-token tables split in 4 with rows short enough that later
     stripes are fully masked (out 0, lse <= -1e29, no NaN), the stripes
     merged by combine_lse_partials against the unsplit paged kernel and
     the plain version, and time it at every stripe (device time and the
     eager op's, host included) and at qwen2's first beside its byte
     bound, its plain version and the library call that returns the same
     (out, lse); time SDPA at seamless's decode-step cross-attention (B 8,
     Sq 1); then, after every earlier draw, hold the paged decode at
     nemotron-4-340b's (H96/KV8, dh 192) and granite-34b's (H48/KV1, dh
     128) serving shapes, the dense decode at H96/KV8, dh 192 (a ring),
     the flash kernel at nemotron's second 512-token chunk and the partial
     kernel at one granite stripe and one dh-192 stripe, flat and peaked,
     each timed beside its library call and bound (``--kernels`` over an
     older package without head dim 192 skips these); last the paged
     decode and flash kernels at olmoe-1b-7b's (H16/KV16, dh 128) and
     internvl2-76b's (H64/KV8, dh 128) serving shapes and the dense decode
     at olmoe's, flat and peaked, each timed beside its plain version,
     its library call and its bound; then the sampling kernel (the fused
     step's threefry categorical, ``csrc/categorical.cu``) against its
     plain version at 1, 16 and 64 lanes over 50304, 128256 and 151936
     columns (every fourth lane greedy), a qwen2 tp-4 vocab shard at its
     offset, the main path's 8 sampled lanes and 256 sampled lanes over
     128256, each at a std-3 draw and a flat one: tokens equal on every
     lane but a near tie of the plain scores (counted, printed), each
     timed in turns beside the kernel it replaced
     (``tools/categorical_variants/two_launch.cu``), with its plain
     version and its bound (instructions, integer operations or bytes,
     counted in its SASS); then f32 logits, the hand-made rows of
     ``repro_torch.testing.sampling``, and the kernel's division and noise
     against the library's over every input.
     Kernels and library
     calls are timed on the device (``device_ms``: calls captured in a
     CUDA graph and replayed), plain versions eagerly (``cuda_ms``);
  4. serve at full width, from random weights of a seed, llama3.2-1b,
     mamba2-2.7b (SSM) and zamba2-1.2b (hybrid): SageSched with the
     CUDA Gittins backend, 8 slots x 2048 tokens, 16 greedy requests in
     two waves so that the scheduler preempts and swaps; each once
     fused, once orchestrated, both decode steps as CUDA graphs (every
     drive of phases 4 and 4b prints its fused keys against
     ``max_fused_compiles()``, fails above it, and prints the graphs
     captured and a steady decode call's host ms).  Every request must
     finish, the scheduler must preempt and swap, the streams must agree
     under the tolerance contract, and every kernel of the model's path
     must have launched, each as often as the path calls it (the
     prefill's flash and SSD launches included); the prefill chunks and
     the recurrent families' whole prefills run as CUDA graphs too
     (``prefill_compile_count``: keys, graphs and first-call and capture
     seconds printed), each drive ends with a third wave (wave 0's
     prompts again, 8 tokens each) that must capture no new prefill
     graph, and TTFT p50 is printed wave by wave; every model is served
     once more in both step modes without graphs (graphs=False), and
     llama3.2-1b with every request at the paper's temperature 0.6 with
     and without graphs (the fused step's draws through the sampling
     kernel, one launch a decode iteration, held; its tok/s printed
     beside the greedy graphed drive's), each eager
     drive held token-identical (its third wave too), launch for launch,
     to its graphed twin (these drives' launches are not summed into
     phase 7's, but for the graphed sampled drive's sampling launches);
     then nemotron-4-340b and granite-34b at full width cut to 2 layers
     (head dim 192 and three head groups; MQA and six head groups), fused
     only, the same mix: every request must finish, the scheduler must
     preempt and swap, and the paged decode and flash kernels must launch
     exactly as often as the path calls them (as they must in every drive
     of an attention family);
  4b. serve qwen2-1.5b at full width tensor-parallel, every shard on the
     one card (make_local_mesh(devices=["cuda:0"] * tp)), the same mix
     (fused): (a) without a mesh; (b) parallel="exact", tp 2, held
     token-identical to (a); (c) parallel="efficient", tp 2 (heads,
     MLP and vocab sharded), fused and orchestrated; (d)
     parallel="efficient", tp 4 (kv heads 2 do not divide: the LSE
     split, one stripe per shard), fused and orchestrated; the fused and
     orchestrated streams of (c) held token-identical, and (c) in both
     step modes run again without graphs and held token-identical,
     launch for launch, to the graphed drives; (d)'s printed with
     a check of what parts them (the split's stripes follow the table's
     width; each stripe's partial kernel does not).  Each drive must finish every request, preempt and
     swap, report its plan's branch and launch each kernel of its path
     exactly as often as the path calls it; (c) and (d) hold one decode
     step of the plan to the same step without a mesh on the same pool
     and inputs (logits within TP_STEP_ULPS bf16 steps, argmax identical
     but where the unsharded maximum is within 2 steps), and print their
     streams' match rate against (a); and, right after each one's phase 4
     drives on the same weights, mamba2-2.7b and zamba2-1.2b at full width
     and depth (RECURRENT_TP_DRIVES, (a) being phase 4's fused and
     orchestrated drives): (b) exact tp 2 (Mamba2 layers replicated on the
     first shard, zamba2's pool over kv heads), held token-identical to (a)
     in each step mode; (c) efficient tp 2 (Mamba2 heads, MLP and vocab
     sharded), fused and orchestrated held token-identical, each again
     without graphs held to its graphed twin, one decode step against the
     no-mesh step on the same state and pool printed at full depth and
     held within TP_STEP_ULPS cut to STEP_CUT_LAYERS (full width), its
     match rate against (a) printed; every SSD, flash and paged launch
     exact;
  4c. the front door: llama3.2-1b at full width (seed 0) behind the
     Gateway with prefix sharing (SageSched with the CUDA Gittins
     backend, FRONT_ENGINE: 8 slots x 2048 tokens, a 6144-token budget,
     prefill chunks of 256 on pages of 16, decode steps as CUDA graphs):
     (i) session traffic, 4 tenants with a 512-token system prompt, 4
     sessions a tenant, 3 greedy turns (turn t + 1 extends turn t's
     prompt and output), each turn wave offered with ``offer_batch`` and
     drained, with sharing ON and OFF, fused and orchestrated: ON held
     token-identical to OFF in each step mode, fused to orchestrated,
     prefill work skipped ON, a preemption and a swap out of a request
     holding adopted blocks in each ON drive, the Gateway's invariants
     and ``assert_engine_quiesced`` after every wave, the fused keys
     within their bound and every kernel launched exactly as the path
     calls it; prefill tokens computed and reused, tok/s, TTFT and TTLT
     p50 printed for ON against OFF (host clock); (ii) overload, 48
     requests from 4 tenants offered at once (max_inflight 8, 4 queued a
     tenant, 16 in all, cost shedding, 2 retries) with a TTLT deadline on
     a virtual clock that advances 0.05 s a Gateway step: every request
     terminal with a reason, at least one SHED and one deadline abort of
     a streaming request, the invariants held, and dispositions and
     streams identical graphed and with graphs=False;
  4d. after phase 5's other drives (nemotron's weights freed), the MoE
     and VLM families: olmoe-1b-7b at full width and depth (13.6 GB of
     bf16 weights, seed 0) through phase 4's mix, fused and orchestrated,
     graphed, and fused again eagerly (held to its graphed twin), every
     launch count exact, each drive's decode-step byte bound printed (the
     weights a step reads: every expert's, as the dense dispatch runs
     them all); on the same weights, phase 4b's exact and efficient tp 2
     (experts sharded; (b) token-identical to 4d's fused drive, (c) one
     step within TP_STEP_ULPS), phase 4c's session traffic at
     MOE_SESSIONS (sharing ON == OFF, fused) and phase 5's generate drive
     with capacity_factor = n_experts (nothing drops); then
     deepseek-moe-16b (shared experts, a leading dense layer) and
     internvl2-76b at full width cut to 2 layers, fused, each with its
     eager twin held token-identical, launch for launch;
  5. generate at full width through Model.prefill -> Model.decode_step
     over the dense cache, from random weights of a seed:
     seamless-m4t-medium (all 12 + 12 layers; 8 x 4096 frames, 128-token
     prompts, a dense cache of 512, 256 greedy steps), llama3.2-1b (all
     16 layers; 8 x 512-token prompts, a cache of 1024, 128 steps),
     mamba2-2.7b and zamba2-1.2b (8 x 512-token prompts, a cache of 1024,
     64 steps; all layers, and cut to 2 layers), nemotron-4-340b cut to 2
     layers (8 x 512-token prompts, a cache of 1024, 64 steps, on phase
     4's weights).  Every logit must be
     finite, the logits and greedy streams must agree under the
     tolerance contract with a teacher-forced Model.forward over prompt +
     generated tokens (the decode step's cross-attention through the key
     split; see
     ``repro_torch.testing.generate.teacher_forced_check``, at each
     drive's bar in GENERATE_DRIVES; printed but not held for the
     recurrent families at full depth), and the dense-decode, flash and
     SSD kernels must have launched exactly as often as the path calls
     them;
  6. hold the Gittins kernel (and the kernel it replaced,
     ``tools/gittins_variants/warp_row.cu``, built beside the package)
     against its plain version at the largest refresh shape the serve
     drives gave it (padded to the pow2 ladder), at GITTINS_SHAPES and at
     (1000, 256) and (100, 12); hold a row alone bit-identical to the same
     row in its batch, and the staged refresh (``CudaPriorityBackend``)
     bit-identical to the kernel on the same padded inputs; time the
     kernel and the replaced one on the device in turns at each shape
     (the largest also cycling over input copies beyond the L2) beside
     the byte bound; time the op, numpy in to numpy out, on the host
     clock at (8, 8) and (1024, 32), staged refresh against the parent's
     op path (``ParentOpBackend``), count the staged refresh's copies
     under torch.profiler, and time ``Scheduler.refresh()`` over a
     1024-deep backlog under the numpy, staged and parent backends;
  6b. the simulator's central scheduler on the card:
     ``measure_scheduler_overhead`` at 8, 32 and 128 nodes (queue depth
     up to 1000, a 10,000-entry history) under the numpy and the cuda
     backends, predict and schedule ms side by side (host clock), and
     ``simulate_cluster`` over ``generate_workload`` of the sharegpt,
     alpaca and write profiles (4 nodes, 2000 requests at 40 rps,
     SageSched) under both: every request must finish under both and the
     Gittins kernel must launch; mean and p99 TTFT and TTLT of each and
     the requests whose metrics differ printed (the f32 kernel is not
     held bit-identical to numpy's float64);
  6c. training, after every serving drive has freed its weights: (a) the
     flash backward kernel (``csrc/flash_attention_bwd.cu``) against its
     plain version (``attention_backward_reference``) on the training
     forward's own O and LSE at BWD_CASES (llama3.2-1b's, qwen2-1.5b's and
     nemotron-4-340b's head shapes, a window of 64, masked prefix rows
     with a query offset, a bidirectional Sq 8 call), flat and peaked,
     ``attn_check`` on each of dq, dk and dv; two calls bit-identical;
     the LSE instance's O bit-identical to the serving instance's and its
     LSE within LSE_TOL of the plain version's; each timed (device ms)
     in turns with the kernel it replaced (``tools/flash_variants/
     bwd_mma_sync.cu``, built beside the package), beside its bound and
     SDPA's backward (causal at the three model shapes, an explicit
     boolean mask of the same positions at the other three);
     (b) llama3.2-1b's gradients at full width and depth on the card
     against the CPU's (``grad_check``, GRAD_REL_BAR), then trained
     TRAIN's 20 steps at B
     8 x S 512 through ``make_train_step`` (seed 0, bf16 weights, f32
     moments, lr 3e-3 on launch/train.py's schedule): every loss finite,
     the last at least 0.2 below the first, the flash launches exact (two
     LSE forwards a layer under remat, one backward, no serving launch),
     s/step, tokens/s, peak GiB and the model-FLOP share printed, then
     the params and state round-tripped through ``save_checkpoint`` /
     ``load_checkpoint`` bit for bit; (c) qwen2-1.5b at full width cut to
     2 layers, 5 steps, then grad accumulation 2 against 1 on one batch at
     tests/test_training.py's bars; (d) olmoe-1b-7b at full width cut to
     2 layers, 5 steps, its router aux loss finite and > 0; the losses of
     (c) and (d) finite and falling; (a') the SSD scan backward kernel
     (``csrc/ssd_scan_bwd.cu``) against its plain version
     (``ssd_backward_reference``) at SSD_BWD_CASES (mamba2-2.7b's and
     zamba2-1.2b's shapes, with and without an initial state and a
     final-state gradient, S 777), on the forward's saved tensors through
     ``SSDScanFunction``, each gradient within BF16_TOL, two calls
     bit-identical, each timed in turns with the kernel it replaced
     (``tools/ssd_variants/bwd_scalar.cu``) beside its bound (and at the
     training shape B 8 x S 1024); (e) TRAIN_RECURRENT: zamba2-1.2b (20
     steps) and mamba2-2.7b (5 steps) at full width and depth, B 8 x S
     1024, each first with its gradients at full depth with the SSD
     backward kernel
     held to those with its plain version on the card
     (``ssd_plain_check``, SSD_PLAIN_GRAD_BAR) and, cut to
     GRAD_CUT_LAYERS, to the CPU's (``grad_check``, GRAD_REL_BAR_SSM),
     the SSD and flash launches exact (forwards twice a layer under
     remat, one backward a layer), the loss falling, s/step, tokens/s,
     peak GiB and the model-FLOP share printed; every training drive's
     model-FLOP share by ``roofline.model_flops`` over HW["peak_flops"];
     the CPU's side of every ``grad_check`` (llama3.2-1b at full depth,
     olmoe-1b-7b, zamba2-1.2b and mamba2-2.7b cut) is computed on a
     low-priority host thread (``HostGradients``) from the kernels' build
     on, on the weights the card's side draws (held bit-identical), so
     that it overlaps phases 2-6b;
  6d. the dry-run on the meta device (no card): ``roofline.HW`` beside
     the card's own total_memory, ``dryrun.min_tp_report`` at the card's
     budget for MIN_TP_ARCHS, and ``dryrun.run_case`` of llama3.2-1b at
     the four shapes on the single-pod production mesh, its roofline
     terms on HW's peaks;
  7. print one JSON line of per-kernel results (launches summed over
     every serve and generate drive, the front door's, the simulator's
     and the training drives'; the flash row counts the flash op's entry
     points -- the serving instance, the key split and the training
     forward's LSE instance -- and names them), then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.core import (CudaPriorityBackend, Scheduler,  # noqa: E402
                              make_policy)
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
    decode_attention_op, decode_attention_paged_lse_op,
    decode_attention_paged_op)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_dense_reference, decode_attention_paged_lse_reference,
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_BACKWARD_KERNEL, FLASH_PREFILL_KERNEL, FLASH_PREFILL_LSE_KERNEL,
    HEAD_DIMS, flash_attention, flash_attention_backward,
    flash_attention_lse, flash_key_ranges)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_backward_reference, attention_reference)
from repro_torch.kernels.bucketing import pow2_bucket  # noqa: E402
from repro_torch.kernels.categorical import (  # noqa: E402
    CATEGORICAL_KERNEL, categorical, prng_key)
from repro_torch.kernels.categorical import ref as categorical_ref  # noqa: E402,E501
from repro_torch.kernels.gittins.ops import (  # noqa: E402
    GITTINS_KERNEL, gittins_attained, gittins_attained_op, padded_rows)
from repro_torch.kernels.gittins.ref import (  # noqa: E402
    gittins_attained_reference)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    SSD_BACKWARD_KERNEL, SSD_SCAN_KERNEL, ssd_scan, ssd_scan_backward)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_backward_reference, ssd_chunked_reference, ssd_sequential_reference)
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.roofline import HW, model_flops  # noqa: E402
from repro_torch.launch.train import schedule_for as train_schedule  # noqa: E402,E501
import repro_torch.models.moe as moe_module  # noqa: E402
import repro_torch.models.transformer as transformer_module  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    decode_attention_paged)
from repro_torch.models.encdec import encode  # noqa: E402
from repro_torch.models.layers import iter_specs  # noqa: E402
from repro_torch.serving import (Gateway, GatewayConfig,  # noqa: E402
                                 RequestState, ServeRequest, ServingEngine)
from repro_torch.serving.sharded import ShardingPlan  # noqa: E402
from repro_torch.simulator import (generate_workload,  # noqa: E402
                                   make_profile, measure_scheduler_overhead,
                                   simulate_cluster)
from repro_torch.testing import (  # noqa: E402
    GRAD_REL_BAR, GRAD_REL_BAR_MOE, GRAD_REL_BAR_SSM, SSD_PLAIN_GRAD_BAR,
    VirtualClock, assert_engine_quiesced, assert_tokens_close,
    grad_rel_errors)
from repro_torch.testing.generate import (  # noqa: E402
    bf16_ulp, greedy_generate, teacher_forced_check)
from repro_torch.training import (AdamW, load_checkpoint,  # noqa: E402
                                  make_train_step, save_checkpoint)
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_items, tree_leaves, tree_unflatten)

# the flash op's key split for a few bidirectional queries (None over an
# older package, timed with --kernels)
FLASH_SPLIT_KERNEL = getattr(flash_kernel, "FLASH_SPLIT_KERNEL", None)
# H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet, dense);
# the HBM rate and the bf16 tensor peak are roofline.HW's
F32_FLOPS = 67e12
# H100 SXM INT32 operations a second: 64 int32 lanes an SM a clock, half
# its 128 f32 lanes, an integer op counting one where an f32 FMA counts
# two in F32_FLOPS
INT32_OPS = F32_FLOPS / 4
# H100 SXM instructions issued a second: 4 schedulers an SM, each one warp
# instruction (32 lanes) a clock, at the clock of INT32_OPS
ISSUE_RATE = 2 * INT32_OPS
# the sampling kernel's work a sampled column, counted in its built SASS
# (tools/categorical_variants.py: cuobjdump of the main path's instance, a
# pair of columns' straight-line draw over two: threefry, the two logs,
# the add and the compare; the column's load and its division's three
# FFMA are left out, so the bound stays below the work; CUDA 12 nvcc for
# sm_90a): integer ALU-pipe operations (IADD3, LOP3, SHF, LEA, ISETP, SEL,
# ...; IMAD and VIADD issue on the FMA pipe and count only as
# instructions), and all instructions.  The draw's bound is the largest of
# the ALU ops over INT32_OPS, the instructions over ISSUE_RATE and the
# logits' bytes over the HBM rate; phase 3 prints a recount beside these.
# And a lane's key (two fold_ins, counted in the source)
CATEGORICAL_COLUMN_OPS = 51.625
CATEGORICAL_COLUMN_INSTRS = 120.375
CATEGORICAL_KEY_OPS = 2 * 72
# a lane's token may differ from the plain version's only where the plain
# version's two best scores lie within this fraction of max(1, |best|)
# (tests/test_torch_sampling.py's NEAR_TIE); where the tokens agree, the
# values are held within the same bound
CATEGORICAL_NEAR_TIE = 4e-6
# phase 3's sampling shapes: lanes x vocab (gpt-neox's 50304, llama3's
# 128256, qwen2's 151936), a vocab shard of qwen2-1.5b at tp 4 (the third
# of four parts), the main path's shape (8 lanes, the fused step's lane
# floor, over llama3.2-1b's vocab, every lane sampled; timed into the row)
# and a large sampled batch (256 lanes, 65.7 MB of bf16)
CATEGORICAL_LANES = (1, 16, 64)
CATEGORICAL_VOCABS = (50304, 128256, 151936)
CATEGORICAL_SHARD = (16, 151936 // 4, 2)
CATEGORICAL_MAIN = (8, 128256)
CATEGORICAL_LARGE = (256, 128256)
# the draws phase 3 times at every shape: (name, logit std, temperatures
# cycled over the lanes): std 3 at T 0.6 / 1.0 / 0.3, and a flat draw
# (std 0.9: llama3.2-1b's logit spread at the repo's random init, 0.02 x
# sqrt(2048), at the paper's T 0.6) as the smoke drives give it
CATEGORICAL_DRAWS = (("std 3", 3.0, (0.6, 1.0, 0.3)),
                     ("flat std 0.9", 0.9, (0.6,)))
BF16_TOL = 2e-2          # bf16 kernel vs plain version (tests/test_kernels.py)
# attention kernels: BF16_TOL, but the absolute part never above this
# fraction of the compared output's RMS (a wide softmax over thousands of
# keys gives outputs of about sqrt(e / n), the size of BF16_TOL itself)
ATTN_RMS_FRACTION = 0.1
# q scale of the peaked draws: scores of std 3, so a few keys carry the
# softmax and the outputs are O(1)
PEAKED_Q = 3.0
GITTINS_RTOL = 1e-4      # f32 kernel vs plain version
# the partial kernel's lse (f32, max and sum of another order) vs plain
LSE_TOL = 1e-4
# SSD final state (f32, sums of up to a chunk's terms in another order)
SSD_STATE_TOL = 1e-3
SERVED = ("llama3.2-1b", "mamba2-2.7b", "zamba2-1.2b")
# phase 4 (fused only, exact launch counts) and, for nemotron, phase 5:
# full width cut to 2 layers -- nemotron-4-340b's head dim 192 with 12
# query heads a kv head (33 GB of bf16 weights, shared by both drives) and
# granite-34b's MQA (48 query heads of 128 over one kv head)
WIDE = (("nemotron-4-340b", dict(n_layers=2)),
        ("granite-34b", dict(n_layers=2)))
# phase 4: the served models whose fused drive is run again eagerly
# (graphs=False) and held token-identical, launch for launch, to the
# graphed one; and those with a sampled pair (temperature SAMPLED_T,
# graphed and eager) held the same way
EAGER_HELD = ("llama3.2-1b", "mamba2-2.7b", "olmoe-1b-7b")
SAMPLED_HELD = ("llama3.2-1b",)
# the paper's default sampling temperature (repro/serving/request.py:27)
SAMPLED_T = 0.6
# phase 4b: (label, tp, parallel, step modes); tp None = no mesh
TP_ARCH = "qwen2-1.5b"
TP_DRIVES = (("a", None, "exact", ("fused",)),
             ("b", 2, "exact", ("fused",)),
             ("c", 2, "efficient", ("fused", "orchestrated")),
             ("d", 4, "efficient", ("fused", "orchestrated")))
# phase 4b: the drives whose fused and orchestrated streams must be
# token-identical, as phase 4's are without a mesh.  (d)'s are printed:
# its LSE split cuts the logical pages into tp stripes of a width that
# follows the table's (models/attention.py _decode_attention_paged_split:
# a pow2 of the pages in use in the fused step, the whole table in the
# orchestrated one), so one row's keys are merged across other stripes
# in the two steps (ROADMAP Queue C; lse_stripe_check shows it)
TP_SAME_STREAMS = ("c",)
# phase 4b: the drives run again eagerly (graphs=False) in each of their
# step modes, held token-identical, launch for launch, to the graphed run
TP_EAGER_HELD = ("c",)
# phase 4b's drives of the recurrent families (mamba2-2.7b, zamba2-1.2b at
# full width and depth, on phase 4's weights; (a) is phase 4's graphed
# fused and orchestrated drives, not run again): exact tp 2 (the Mamba2
# layers replicated, zamba2's pool over kv heads) and efficient tp 2 (the
# Mamba2 heads sharded), each fused and orchestrated
RECURRENT_TP_DRIVES = (("b", 2, "exact", ("fused", "orchestrated")),
                       ("c", 2, "efficient", ("fused", "orchestrated")))
# the depth at which (c)'s decode step is held to the no-mesh step for
# the recurrent families (full width; at full depth the step drifts as a
# one-ulp nudge of the weights does, and is printed)
STEP_CUT_LAYERS = 2
# phase 4b: one decode step of an efficient plan vs the same step without
# a mesh, max |logit| difference in bf16 steps at the largest |logit|: its
# drift on an H100 (2.00 for tp 2, 1.81 for tp 4; the step is
# deterministic), rounded up to a whole step, plus one so that the bar
# does not sit on the measured value
TP_STEP_ULPS = 3
# phase 4c: the front door -- llama3.2-1b at full width behind the
# Gateway with prefix sharing; the engine's shape (a 6144-token budget,
# prefill chunks of 256 on pages of 16: a sharing grid of 256); (tenants,
# sessions a tenant, turns) of the session traffic and each tenant's
# system prompt in tokens; (requests, TTLT deadline in virtual seconds)
# of the overload drive
FRONT_ARCH = "llama3.2-1b"
FRONT_ENGINE = dict(n_slots=8, max_seq_len=2048, capacity_tokens=6144,
                    block_size=16, prefill_chunk=256)
SESSIONS = (4, 4, 3)
FRONT_SYSTEM = 512
# the traffic's seed: turns whose admissions, counted against the blocks
# they would adopt, overrun the budget later, so SageSched preempts (and
# swaps out) requests that hold adopted blocks
SESSION_SEED = 23
OVERLOAD = (48, 3.0)
# phase 4d: olmoe-1b-7b at full width and depth (13.8 GB of bf16 weights,
# shared by its phase 4d, 4b, 4c and 5 drives, which run after phase 5's
# other drives have freed nemotron's weights); then, fused, deepseek-moe-16b
# (shared experts, a leading dense layer) and internvl2-76b (the VLM's
# Llama-3-70B-wide backbone) at full width cut to 2 layers
MOE_ARCH = "olmoe-1b-7b"
MOE_WIDE = (("deepseek-moe-16b", dict(n_layers=2)),
            ("internvl2-76b", dict(n_layers=2)))
# phase 4b's olmoe drives: (a) is phase 4d's fused drive, not run again
MOE_TP_DRIVES = (("b", 2, "exact", ("fused",)),
                 ("c", 2, "efficient", ("fused",)))
# phase 4c's shorter session drive for olmoe: (tenants, sessions a tenant,
# turns), fused only
MOE_SESSIONS = (2, 2, 2)
# phase 5's olmoe drive, with capacity_factor = n_experts so that nothing
# drops in the forward or the decode; its teacher-forced bar is its drift
# on an H100 (8.50 bf16 steps: the forward's other GEMM shapes round the
# router's input otherwise, and an expert picked on a near tie moves a
# position's logits), rounded up to a whole step
MOE_GENERATE = dict(b=2, prompt=256, max_len=512, steps=32, logit_ulps=9)
# phase 6b: the cluster sizes of measure_scheduler_overhead, and
# simulate_cluster's (nodes, requests, rps)
OVERHEAD_NODES = (8, 32, 128)
SIM_CLUSTER = (4, 2000, 40.0)
# phase 5: (arch, depth cut, drive) through Model.prefill ->
# Model.decode_step.  ``logit_ulps`` is the drive's teacher-forced logit
# bar in bf16 steps (``teacher_forced_check``): its drift on an H100,
# rounded up to a whole step (seamless 2.06, llama 2.25, the cut mamba2
# 3.25, the cut zamba2 1.75; the drives are deterministic).  None prints
# the comparison without holding it: at random weights bf16 rounding
# differences grow with Mamba2 depth (3.25 steps at 2 layers, 226.5 at
# 64 on an H100), so at full depth the decode and a forward agree no
# better than unrelated logits; the recurrent families are held cut to
# 2 layers (zamba2 with its shared attention after each, two group
# layers)
GENERATE_DRIVES = (
    ("seamless-m4t-medium", {}, dict(b=8, prompt=128, max_len=512,
                                     steps=256, n_frames=4096,
                                     logit_ulps=3)),
    ("llama3.2-1b", {}, dict(b=8, prompt=512, max_len=1024, steps=128,
                             logit_ulps=3)),
    ("mamba2-2.7b", {}, dict(b=8, prompt=512, max_len=1024, steps=64,
                             logit_ulps=None)),
    ("zamba2-1.2b", {}, dict(b=8, prompt=512, max_len=1024, steps=64,
                             logit_ulps=None)),
    ("mamba2-2.7b", dict(n_layers=2), dict(b=8, prompt=512, max_len=1024,
                                           steps=64, logit_ulps=4)),
    ("zamba2-1.2b", dict(n_layers=2, hybrid_attn_every=1),
     dict(b=8, prompt=512, max_len=1024, steps=64, logit_ulps=2)),
    # teacher_forced_check's default bar: no drift measured before
    ("nemotron-4-340b", dict(n_layers=2), dict(b=8, prompt=512,
                                               max_len=1024, steps=64,
                                               logit_ulps=3)))


class BuildThread(threading.Thread):
    """A build beside the package's: ``join()`` re-raises what the build
    raised (a failed nvcc's SystemExit too), so it is not lost with the
    thread."""

    error: BaseException | None = None

    def run(self) -> None:
        try:
            super().run()
        except BaseException as e:  # noqa: BLE001 - re-raised in join()
            self.error = e

    def join(self, timeout=None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


# the SSD kernel this one replaced (tools/ssd_variants/scalar.cu), built
# beside the package and timed in phase 3; empty where the checkout has
# no tools/ssd_variants.py
PARENT_SSD: dict = {}


def build_parent_ssd() -> None:
    try:
        from tools import ssd_variants
    except ImportError:
        return
    built = ssd_variants.build(["scalar", "bwd_scalar"])
    PARENT_SSD.update(scan=built["scalar"][0], log=built["scalar"][1],
                      backward=built["bwd_scalar"][0],
                      backward_log=built["bwd_scalar"][1])


# the flash backward kernel this one replaced (tools/flash_variants/
# bwd_mma_sync.cu), built beside the package and timed in phase 6c (a);
# empty where the checkout has no tools/flash_bwd_variants.py
PARENT_FLASH_BWD: dict = {}


def build_parent_flash_bwd() -> None:
    try:
        from tools import flash_bwd_variants
    except ImportError:
        return
    backward, log = flash_bwd_variants.build(["bwd_mma_sync"])["bwd_mma_sync"]
    PARENT_FLASH_BWD.update(backward=backward, log=log)


def in_turns(fns: dict, **kw) -> dict:
    """Device ms of each of ``fns`` (name: a call), timed in turns (each
    in order, then in reverse) and averaged, so that a clock or power
    drift during the timing falls on all alike."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(device_ms(fns[name], **kw))
    return {name: sum(t) / len(t) for name, t in times.items()}


def versus_parent(times: dict) -> str:
    """The parent's time from ``in_turns``' times, and whether the kernel
    beat it."""
    parent = times.get("parent")
    if parent is None:
        return "parent's kernel not built"
    faster = " (faster)" if times["kernel"] < parent else ""
    return f"parent's kernel {parent:.4f} ms{faster}"


# the Gittins kernel this one replaced (tools/gittins_variants/warp_row.cu),
# built beside the package and timed in phase 6; empty where the checkout
# has no tools/gittins_variants.py
PARENT_GITTINS: dict = {}
# phase 6: the refresh shapes timed beside the main path's: the paper's
# 1000-deep queue with the predictor's 20 buckets, (4096, 64), and a
# cluster-wide live set at max_k (33.7 MB: also timed cycling over
# GITTINS_COLD copies of its inputs, beyond the 50 MB L2)
GITTINS_SHAPES = ((1024, 32), (4096, 64), (16384, 256))
GITTINS_COLD = 4


def build_parent_gittins() -> None:
    try:
        from tools import gittins_variants
    except ImportError:
        return
    run, log = gittins_variants.build(["warp_row"])["warp_row"]
    PARENT_GITTINS.update(run=run, log=log)


# the sampling kernel this one replaced (tools/categorical_variants/
# two_launch.cu), built beside the package and timed in phase 3, and the
# checks of the kernel's division and noise against the library's over
# every input (exact_check.cu); empty where the checkout has no
# tools/categorical_variants.py
PARENT_CATEGORICAL: dict = {}
# the package kernels' nvcc output (phase 2's build), for phases that
# print a kernel's registers again
BUILD_LOGS: dict = {}


def build_parent_categorical() -> None:
    try:
        from tools import categorical_variants
    except ImportError:
        return
    built = categorical_variants.build(["two_launch", "exact_check"])
    run, log = built["two_launch"]
    PARENT_CATEGORICAL.update(
        run=run, log=log, exact_check=built["exact_check"][0],
        temperatures=len(categorical_variants.DIVIDE_TEMPS))


def print_ptxas(log: str) -> None:
    """Each kernel's name (and template arguments), registers and spills
    from an nvcc build's ptxas -v report, and any line where ptxas
    serialized a kernel's wgmma ("Potential Performance Loss")."""
    for line in log.splitlines():
        entry = "Compiling entry" in line and re.search(
            r"\d+([a-z_]+kernel)(I(\w*?)EEv)?", line)
        if entry:   # a kernel's template arguments, e.g. <192, 1, 4>
            args = re.findall(r"L[ib](\d+)E", (entry.group(3) or "") + "E")
            name = entry.group(1)
            if args:
                name += f"<{', '.join(args)}>"
            print(f"  ptxas: {name}")
        elif "Used" in line or "spill" in line or "Potential" in line:
            print(f"  ptxas: {line.strip()}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager call of ``fn``, the host's dispatch included
    where it outlasts the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so that the host's share
    of a call (the Python wrapper, ctypes, each launch's dispatch) is not
    in it.  Kernels and library calls are timed this way; ``cuda_ms``
    times eager calls, host included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HW["hbm_bw"] * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          rel: bool = False, atol: float | None = None) -> float:
    """Elementwise |got - want| <= tol * |want| + atol (atol = tol unless
    given; 0 with ``rel``)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    atol = 0.0 if rel else (tol if atol is None else atol)
    limit = tol * want.abs() + atol
    bad = int((err > limit).sum())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=rel {tol:g} + abs {atol:.3e} "
          f"{'OK' if bad == 0 else f'{bad} elements out of tolerance'}")
    if bad:
        raise SystemExit(f"FAIL {name}: kernel disagrees with plain version")
    return max_abs


def attn_check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An attention kernel against its plain version: BF16_TOL, with the
    absolute part capped at ATTN_RMS_FRACTION of want's RMS."""
    rms = float(want.float().pow(2).mean().sqrt())
    return check(f"{name} [output RMS {rms:.3e}]", got, want, BF16_TOL,
                 atol=min(BF16_TOL, ATTN_RMS_FRACTION * rms))


# --------------------------------------------------------------- phase 3

def decode_case(cfg, dev, gen):
    """Paged decode at the serving shapes: 8 lanes, the full 2048-token
    table (128 pages of 16), the pool of 8 slots x 2048 tokens."""
    b, h, kvh, dh, page = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    p_max, n_pages = 2048 // page, 8 * 2048 // page + 1
    q = torch.randn(b, h, dh, generator=gen, device=dev).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * p_max].reshape(b, p_max).to(torch.int32).contiguous()
    cache_len = torch.randint(32, 1281, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
    return q, kp, vp, tables, cache_len


def paged_sdpa_ms(q, kp, vp, tables, cl) -> float:
    """SDPA over the gathered dense cache, the paged decode's yardstick."""
    b, h, dh = q.shape
    page, kvh = kp.shape[1], kp.shape[2]
    s = tables.shape[1] * page
    tok = ((tables.long() * page)[:, :, None]
           + torch.arange(page, device=q.device)).reshape(b, s)
    kd = kp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    vd = vp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < cl[:, None].long()
            )[:, None, None, :]
    qd = q[:, :, None, :]
    return device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))


def paged_bytes_flops(q, kvh, tables, cl):
    """Bytes the paged decode must move (q and the output, each row's
    cache_len K and V rows, its table and length, once) and its flops."""
    b, h, dh = q.shape
    valid = float(cl.long().sum())
    n_bytes = (2 * q.numel() * 2 + 2 * valid * kvh * dh * 2
               + tables.numel() * 4 + cl.numel() * 4)
    return n_bytes, 4.0 * valid * h * dh


def phase_decode(cfgs, dev, gen) -> dict:
    """Checks at the shapes of every served model with attention (llama:
    32 heads over 8 kv heads, dh 64; zamba2: 32 over 32, dh 64); times at
    the first's."""
    err = 0.0
    for cfg in reversed(cfgs):      # the first model's inputs stay for timing
        q, kp, vp, tables, cl = decode_case(cfg, dev, gen)
        got = decode_attention_paged_op(q, kp, vp, tables, cl)
        want = decode_attention_paged_reference(q, kp, vp, tables, cl)
        torch.cuda.synchronize()
        shape = f"H{cfg.n_heads}/KV{cfg.n_kv_heads}, dh {cfg.head_dim}"
        err = max(err, attn_check(f"paged decode {cfg.name} (bf16, {shape}, "
                                  f"8 lanes, cache_len 32..1280)", got, want))
        # windowed variant: same kernel, logical sliding window of 256
        got_w = decode_attention_paged_op(q, kp, vp, tables, cl, window=256)
        want_w = decode_attention_paged_reference(q, kp, vp, tables, cl,
                                                  window=256)
        err = max(err, attn_check(f"paged decode {cfg.name}, window 256",
                                  got_w, want_w))
        if cfg is not cfgs[0]:
            ms = device_ms(lambda: decode_attention_paged_op(q, kp, vp, tables,
                                                           cl))
            print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms")
    ms = device_ms(lambda: decode_attention_paged_op(q, kp, vp, tables, cl))
    plain_ms = cuda_ms(lambda: decode_attention_paged_reference(
        q, kp, vp, tables, cl), iters=5)
    lib_ms = paged_sdpa_ms(q, kp, vp, tables, cl)
    bnd, by = bound_ms(*paged_bytes_flops(q, kp.shape[2], tables, cl),
                       HW["peak_flops"])
    print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA on gathered cache {lib_ms:.4f} ms, bound "
          f"{bnd:.5f} ms ({by})")
    return {"name": "decode_attention_paged", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:232",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def flash_case(cfg, dev, gen, s_past: int, start: int, c: int):
    """A chunk of c queries at positions start.. over s_past gathered
    prefix rows (rows >= start masked at -1e9) plus the chunk itself."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sk = s_past + c
    q = torch.randn(1, c, h, dh, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    pos = (start + torch.arange(c, device=dev)).to(torch.int32)
    past = torch.arange(s_past, device=dev)
    kv_pos = torch.cat([torch.where(past < start, past,
                                    torch.full_like(past, -10 ** 9)),
                        pos.long()]).to(torch.int32)
    return q, k, v, pos, kv_pos


def phase_flash(cfgs, dev, gen) -> dict:
    """Checks at the prefill shapes of every served model with attention;
    times at the first's (llama's second 512-token chunk)."""
    err = 0.0
    # (cfg, S_past, start, C): llama's chunked prefill -- a first chunk
    # (no past), the second 512-token chunk of a 1024-token prompt, and a
    # chunk whose gathered prefix carries masked rows past its start;
    # zamba2's atomic prefill -- one whole pow2-bucketed prompt
    cases = [(cfgs[0], 0, 0, 512), (cfgs[0], 512, 512, 512),
             (cfgs[0], 512, 448, 256)] + [(c, 0, 0, 1024) for c in cfgs[1:]]
    for cfg, s_past, start, c in cases:
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, s_past, start, c)
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        err = max(err, attn_check(f"flash prefill {cfg.name} (bf16, H"
                                  f"{cfg.n_heads}/KV{cfg.n_kv_heads}, C={c}, "
                                  f"S_past={s_past}, start={start})", got,
                                  want))
        ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
        print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}, start="
              f"{start}): kernel {ms:.4f} ms")
    cfg = cfgs[0]
    q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, 512, 512, 512)
    ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v, pos, kv_pos),
                       iters=5)

    mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    h, dh = q.shape[2], q.shape[3]
    pairs = float(mask.sum())
    n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + (pos.numel() + kv_pos.numel()) * 4
    flops = 4.0 * pairs * h * dh
    bnd, by = bound_ms(n_bytes, flops, HW["peak_flops"])
    print(f"  flash prefill {cfg.name} (C=512, S_past=512): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
          f"{bnd:.5f} ms ({by})")
    return {"name": "flash_attention_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def dense_decode_case(dev, gen, b, h, kvh, dh, s_max, hi, q_scale=1.0):
    """q and dense (B, S_max, KV, dh) caches; cache_len in [1, hi], with
    row 0 at hi and row 1 at exactly S_max, so that a ring (hi > S_max)
    has a wrapped row and one at the wrap point."""
    q = (torch.randn(b, h, dh, generator=gen, device=dev)
         * q_scale).bfloat16()
    k = torch.randn(b, s_max, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s_max, kvh, dh, generator=gen, device=dev).bfloat16()
    cl = torch.randint(1, hi + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    cl[0], cl[1] = hi, s_max
    return q, k, v, cl


def dense_decode_bytes_flops(q, k, cl):
    """Bytes the call must move (q and the output once, each row's
    min(cache_len, S_max) K and V rows once, cache_len) and its flops."""
    b, h, dh = q.shape
    s_max, kvh = k.shape[1], k.shape[2]
    rows = float(torch.clamp(cl.long(), max=s_max).sum())
    n_bytes = 2 * q.numel() * 2 + rows * kvh * dh * 2 * 2 + cl.numel() * 4
    return n_bytes, 4.0 * rows * h * dh


def dense_decode_sdpa_ms(q, k, v, cl) -> float:
    """The yardstick of the dense decode: one SDPA call over the same
    caches, the valid slots (the first min(cache_len, S_max)) as a
    boolean mask, the kv heads shared through enable_gqa."""
    s_max = k.shape[1]
    kd, vd = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < cl[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    return device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))


def phase_dense_decode(dev, gen) -> dict:
    """The dense-cache decode kernel at seamless-m4t-medium's decode shape
    (8 rows, H16/KV16, dh 64, 512 slots), llama3.2-1b's long-context ring
    (its window of 8192 slots, cache_len up to 8392 so some rows wrapped)
    and an MQA shape (H48/KV1, dh 128); timed at seamless's."""
    seam = get_config("seamless-m4t-medium")
    llama = get_config("llama3.2-1b", long_context=True)
    cases = [("seamless-m4t-medium", seam.n_heads, seam.n_kv_heads,
              seam.head_dim, 512, 512, 0),
             ("llama3.2-1b long-context ring", llama.n_heads,
              llama.n_kv_heads, llama.head_dim, llama.window,
              llama.window + 200, llama.window),
             ("MQA", 48, 1, 128, 1024, 1024, 0)]
    err, inputs = 0.0, {}
    for name, h, kvh, dh, s_max, hi, window in cases:
        # a flat draw (scores ~ N(0, 1), a wide softmax) and a peaked one
        # (O(1) outputs: a wrong tile or rescale moves them by O(1))
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, k, v, cl = dense_decode_case(dev, gen, 8, h, kvh, dh, s_max,
                                            hi, q_scale)
            got = decode_attention_op(q, k, v, cl, window=window)
            want = decode_attention_dense_reference(q, k, v, cl,
                                                    window=window)
            torch.cuda.synchronize()
            ring = (f", window {window}, {int((cl > s_max).sum())} rows "
                    f"wrapped" if window else "")
            err = max(err, attn_check(
                f"dense decode {name} {draw} (bf16, H{h}/KV{kvh}, dh {dh}, "
                f"S_max {s_max}, cache_len 1..{hi}{ring})", got, want))
            if draw == "flat":
                inputs[name] = (q, k, v, cl, window)
    for name in list(inputs)[1:]:
        q, k, v, cl, window = inputs[name]
        ms = device_ms(lambda: decode_attention_op(q, k, v, cl, window=window))
        lib_ms = dense_decode_sdpa_ms(q, k, v, cl)
        bnd, by = bound_ms(*dense_decode_bytes_flops(q, k, cl),
                           HW["peak_flops"])
        print(f"  dense decode {name}: kernel {ms:.4f} ms, SDPA with a "
              f"boolean mask {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    q, k, v, cl, _ = inputs["seamless-m4t-medium"]
    ms = device_ms(lambda: decode_attention_op(q, k, v, cl))
    plain_ms = cuda_ms(lambda: decode_attention_dense_reference(q, k, v, cl),
                       iters=5)
    lib_ms = dense_decode_sdpa_ms(q, k, v, cl)
    n_bytes, flops = dense_decode_bytes_flops(q, k, cl)
    bnd, by = bound_ms(n_bytes, flops, HW["peak_flops"])
    print(f"  dense decode seamless-m4t-medium: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA with a boolean mask {lib_ms:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}; {n_bytes / 1e6:.2f} MB)")
    return {"name": "decode_attention_dense", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:79",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def phase_flash_noncausal(dev, gen) -> float:
    """The flash kernel at seamless-m4t-medium's bidirectional shapes: the
    encoder's self-attention over 4096 frames, a 128-token prompt's
    cross-attention over them, and one decode step's (Sq = 1); times the
    encoder's beside SDPA.  Returns the largest max abs error."""
    cfg = get_config("seamless-m4t-medium")
    h, kvh, dh, s_enc = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4096
    err = 0.0
    for what, b, sq in (("encoder self-attention", 1, s_enc),
                        ("prompt cross-attention", 8, 128),
                        ("decode cross-attention", 8, 1)):
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q = (torch.randn(b, sq, h, dh, generator=gen, device=dev)
                 * q_scale).bfloat16()
            k = torch.randn(b, s_enc, kvh, dh, generator=gen,
                            device=dev).bfloat16()
            v = torch.randn(b, s_enc, kvh, dh, generator=gen,
                            device=dev).bfloat16()
            pos = torch.arange(sq, device=dev, dtype=torch.int32)
            kv_pos = torch.arange(s_enc, device=dev, dtype=torch.int32)
            got = flash_attention(q, k, v, pos, kv_pos, causal=False)
            want = attention_reference(q, k, v, pos, kv_pos, causal=False)
            torch.cuda.synchronize()
            err = max(err, attn_check(
                f"flash {cfg.name} {what} {draw} (bf16, non-causal, B {b}, "
                f"Sq {sq}, Sk {s_enc}, H{h}/KV{kvh})", got, want))
            if draw == "flat":
                ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos,
                                                     causal=False), iters=5)
                lib = ""
                if sq == 1:
                    # the yardstick of one decode step's cross-attention
                    # (the key split), and its bound: K and V read once
                    qt, kt, vt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    bnd, by = bound_ms(
                        (2 * q.numel() + k.numel() + v.numel()) * 2,
                        4.0 * b * s_enc * h * dh, HW["peak_flops"])
                    lib = (f", SDPA "
                           f"{device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5):.4f} ms, "
                           f"bound {bnd:.5f} ms ({by})")
                    del qt, kt, vt
                print(f"  flash {cfg.name} {what} (B {b}, Sq {sq}): kernel "
                      f"{ms:.4f} ms{lib}")
            if sq == s_enc and draw == "flat":
                enc = (q, k, v, pos, kv_pos)

            del want
            torch.cuda.empty_cache()
    q, k, v, pos, kv_pos = enc
    ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos, causal=False),
                 iters=5)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v, pos, kv_pos,
                                                   causal=False), iters=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4.0 * s_enc * s_enc * h * dh
    bnd, by = bound_ms(n_bytes, flops, HW["peak_flops"])
    print(f"  flash {cfg.name} encoder self-attention (B 1, S {s_enc}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {bnd:.5f} ms ({by})")
    return err


def ssd_case(cfg, dev, gen, s: int, init: bool = False,
             a_range=(0.5, 0.999)):
    """Inputs of one prefill scan of ``cfg`` (B = 1) in the model path's
    types: x, B, C bf16; dt, a and the state f32.  Decays near 1 (long
    memory, as trained Mamba2 dt gives) carry the initial state and the
    chunk-to-chunk carry into the final state and most rows of y."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = torch.randn(1, s, h, p, generator=gen, device=dev).bfloat16()
    dt = torch.rand(1, s, h, generator=gen, device=dev) * 0.99 + 0.01
    lo, hi = a_range
    a = torch.rand(1, s, h, generator=gen, device=dev) * (hi - lo) + lo
    bm = (torch.randn(1, s, n, generator=gen, device=dev) * 0.5).bfloat16()
    cm = (torch.randn(1, s, n, generator=gen, device=dev) * 0.5).bfloat16()
    st = torch.randn(1, h, p, n, generator=gen, device=dev) if init else None
    return x, dt, a, bm, cm, st


def phase_ssd(dev, gen) -> dict:
    err = 0.0
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        chunk = cfg.ssm_chunk
        for s, init, a_range in ((1024, False, (0.5, 0.999)),
                                 (777, False, (0.5, 0.999)),
                                 (777, True, (0.5, 0.999)),
                                 (1024, True, (0.99, 1.0))):
            x, dt, a, bm, cm, st = ssd_case(cfg, dev, gen, s, init, a_range)
            y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=chunk)
            torch.cuda.synchronize()
            for name, (ry, rst) in (
                    ("chunked", ssd_chunked_reference(x, dt, a, bm, cm, st,
                                                      chunk=chunk)),
                    ("sequential", ssd_sequential_reference(x, dt, a, bm,
                                                            cm, st))):
                what = (f"ssd scan {arch} (S={s}, a in [{a_range[0]}, "
                        f"{a_range[1]}]{', init state' if init else ''}) vs "
                        f"{name}")
                err = max(err, check(f"{what}: y (bf16)", y, ry, BF16_TOL))
                check(f"{what}: final state (f32)", fin, rst, SSD_STATE_TOL)
        # end padding as the model makes it (dt = 0, a = 1, real x, B, C)
        # leaves the valid rows and the state bit-unchanged
        x, dt, a, bm, cm, _ = ssd_case(cfg, dev, gen, 1024)
        dt[:, 777:], a[:, 777:] = 0.0, 1.0
        y0, s0 = ssd_scan(x[:, :777], dt[:, :777], a[:, :777], bm[:, :777],
                          cm[:, :777], chunk=chunk)
        y1, s1 = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        same = torch.equal(y0, y1[:, :777]) and torch.equal(s0, s1)
        print(f"  ssd scan {arch}: S=777 vs padded to 1024 with dt=0, a=1: "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise SystemExit("FAIL ssd scan: end padding changed the result")
    # times at both prefill shapes: the kernel, the parent's kernel (the
    # scalar one it replaced, tools/ssd_variants/scalar.cu) in the same
    # call, the plain chunked version, and the bound
    parent = PARENT_SSD.get("scan")
    instances = {}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        x, dt, a, bm, cm, _ = ssd_case(cfg, dev, gen, 1024)
        ms = device_ms(lambda: ssd_scan(x, dt, a, bm, cm))
        parent_ms = (device_ms(lambda: parent(x, dt, a, bm, cm))
                     if parent else None)
        plain_ms = cuda_ms(lambda: ssd_chunked_reference(x, dt, a, bm, cm),
                           iters=5)
        b, s, h, p = x.shape
        n, q = bm.shape[-1], cfg.ssm_chunk
        n_bytes = (2 * x.numel() * 2 + (dt.numel() + a.numel()) * 4
                   + (bm.numel() + cm.numel()) * 2 + b * h * p * n * 4)
        # causal pairs per chunk; C.B^T once per chunk (one group), then
        # per head the weighted sum over pairs, the state read-out and
        # update (the kernel's extra products for the f32 factors' bf16 parts
        # are not the function's work)
        pairs = (s // q) * q * (q + 1) / 2
        flops = b * (pairs * 2 * n + h * (pairs * 2 * p + 2 * s * 2 * p * n))
        bnd, by = bound_ms(n_bytes, flops, HW["peak_flops"])
        t_bytes = n_bytes / HW["hbm_bw"] * 1e3
        t_ops = flops / HW["peak_flops"] * 1e3
        print(f"  ssd scan ({arch}, S={s}, H {h}, P {p}, N {n}): kernel "
              f"{ms:.4f} ms, parent's kernel "
              f"{'not built' if parent_ms is None else f'{parent_ms:.4f} ms'}"
              f", plain chunked {plain_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
              f"bytes {t_bytes:.5f} ms for {n_bytes / 1e6:.1f} MB, "
              f"operations {t_ops:.5f} ms for {flops / 1e9:.2f} GFLOP)")
        instances[f"{arch} S={s}"] = {
            "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by}
    main_shape = instances["mamba2-2.7b S=1024"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:64",
            "max_abs_err": err, "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "instances": instances}


def phase_flash_dh128(dev, gen) -> float:
    """The flash kernel at qwen2-1.5b's chunked-prefill shapes (H12/KV2,
    dh 128; phase 4b's path): a first 512-token chunk and a chunk whose
    gathered prefix carries masked rows past its start.  Returns the
    largest max abs error."""
    cfg = get_config(TP_ARCH)
    err = 0.0
    for s_past, start, c in ((0, 0, 512), (512, 448, 256)):
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, s_past, start, c)
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        err = max(err, attn_check(f"flash prefill {cfg.name} (bf16, H"
                                  f"{cfg.n_heads}/KV{cfg.n_kv_heads}, dh "
                                  f"{cfg.head_dim}, C={c}, S_past={s_past}, "
                                  f"start={start})", got, want))
        ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
        print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}, start="
              f"{start}): kernel {ms:.4f} ms")
    mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    h, dh = q.shape[2], q.shape[3]
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 \
        + (pos.numel() + kv_pos.numel()) * 4
    bnd, by = bound_ms(n_bytes, 4.0 * float(mask.sum()) * h * dh,
                       HW["peak_flops"])
    print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}): kernel "
          f"{ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return err


def lse_case(dev, gen, h, kvh, dh, q_scale=1.0):
    """Partial paged decode at the tp = 4 serving shape: 8 lanes, 2048-token
    tables (128 pages of 16) split in 4 stripes of 32 pages, rows of 1 to
    2048 tokens (the short ones leave the later stripes fully masked)."""
    b, page, p_max = 8, 16, 128
    n_pages = b * p_max + 1
    q = (torch.randn(b, h, dh, generator=gen, device=dev)
         * q_scale).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * p_max].reshape(b, p_max).to(torch.int32).contiguous()
    cl = torch.tensor([1, 100, 511, 512, 513, 1000, 1600, 2048],
                      dtype=torch.int32, device=dev)
    return q, kp, vp, tables, cl


def stripe(tables, cl, s: int, n: int = 4, page: int = 16):
    """Stripe s of n: its column slice of the tables and its lengths."""
    per = tables.shape[1] // n
    return (tables[:, s * per:(s + 1) * per].contiguous(),
            torch.clamp(cl - s * per * page, min=0).contiguous())


def lse_bytes_flops(q, kvh, bt, cl, page: int = 16):
    """Bytes the call must move (q, the stripe's valid K and V rows -- a
    row's positions up to the stripe's end --, its table and lengths once;
    out and lse written once) and its flops."""
    b, h, dh = q.shape
    valid = float(torch.clamp(cl.long(), max=bt.shape[1] * page).sum())
    n_bytes = (2 * q.numel() * 2 + 2 * valid * kvh * dh * 2 + bt.numel() * 4
               + b * 4 + b * h * 4)
    return n_bytes, 4.0 * valid * h * dh


def phase_lse(dev, gen) -> dict:
    """The partial (out, lse) paged kernel against its plain version, per
    stripe, at qwen2-1.5b's tp = 4 shape and llama3.2-1b's; the merged
    stripes against the unsplit kernel and the plain version; times at
    qwen2's first stripe (every row has positions there)."""
    err = 0.0
    for arch in (TP_ARCH, "llama3.2-1b"):
        cfg = get_config(arch)
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, kp, vp, tables, cl = lse_case(dev, gen, h, kvh, dh, q_scale)
            what = f"paged lse {arch} {draw} (bf16, H{h}/KV{kvh}, dh {dh})"
            for s in range(4):
                bt, cls = stripe(tables, cl, s)
                out, lse = decode_attention_paged_lse_op(q, kp, vp, bt, cls)
                want_o, want_l = decode_attention_paged_lse_reference(
                    q, kp, vp, bt, cls)
                torch.cuda.synchronize()
                live = cls > 0
                if not (torch.isfinite(out).all()
                        and torch.isfinite(lse).all()):
                    raise SystemExit(f"FAIL {what}: non-finite output")
                dead_out, dead_lse = 0.0, -math.inf
                if bool((~live).any()):
                    dead_out = float(out[~live].float().abs().max())
                    dead_lse = max(float(lse[~live].max()),
                                   float(want_l[~live].max()))
                print(f"  {what} stripe {s}: {int((~live).sum())} rows "
                      f"fully masked, their |out| max {dead_out:g}, lse max "
                      f"{dead_lse:.4g}")
                if dead_out != 0.0 or dead_lse > -1e29:
                    raise SystemExit(f"FAIL {what}: a fully masked stripe "
                                     "must give out 0 and lse <= -1e29")
                err = max(err, attn_check(f"{what} stripe {s}: out",
                                          out[live], want_o[live]))
                check(f"{what} stripe {s}: lse (f32)", lse[live],
                      want_l[live], LSE_TOL)
            merged = decode_attention_paged(q[:, None], kp, vp, tables, cl,
                                            n_splits=4)[:, 0]
            whole = decode_attention_paged_op(q, kp, vp, tables, cl)
            plain = decode_attention_paged_reference(q, kp, vp, tables, cl)
            torch.cuda.synchronize()
            err = max(err, attn_check(f"{what}: 4 stripes merged vs the "
                                      "unsplit kernel", merged, whole))
            err = max(err, attn_check(f"{what}: 4 stripes merged vs plain",
                                      merged, plain))
            if draw == "flat":
                for s in range(4):
                    bt, cls = stripe(tables, cl, s)
                    ms = device_ms(lambda: decode_attention_paged_lse_op(
                        q, kp, vp, bt, cls))
                    # eager, the host's share included: the op's Python
                    # and ctypes call outlast its two kernels
                    op_ms = cuda_ms(lambda: decode_attention_paged_lse_op(
                        q, kp, vp, bt, cls), iters=100, warmup=20)
                    print(f"  paged lse {arch} stripe {s} of 4: kernel "
                          f"{ms:.4f} ms, eager op {op_ms:.4f} ms")
            if arch == TP_ARCH and draw == "flat":
                timed = (q, kp, vp) + stripe(tables, cl, 0)
    q, kp, vp, bt, cls = timed
    ms = device_ms(lambda: decode_attention_paged_lse_op(q, kp, vp, bt, cls))
    plain_ms = cuda_ms(lambda: decode_attention_paged_lse_reference(
        q, kp, vp, bt, cls), iters=5)
    lib_name, lib_ms = lse_library_ms(q, kp, vp, bt, cls)
    n_bytes, flops = lse_bytes_flops(q, kp.shape[2], bt, cls)
    bnd, by = bound_ms(n_bytes, flops, HW["peak_flops"])
    print(f"  paged lse {TP_ARCH} stripe 0 of 4 (B 8, 32 pages): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}; {n_bytes / 1e6:.2f} MB)")
    return {"name": "decode_attention_paged_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:275",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def lse_library_ms(q, kp, vp, bt, cls) -> tuple[str, float]:
    """The library call that returns the same (out, lse) as the partial
    kernel: memory-efficient SDPA with compute_log_sumexp over the
    gathered stripe (heads expanded: it takes no GQA), a boolean mask as
    an additive bias; SDPA without the lse where this PyTorch refuses
    it.  Returns its name and device time."""
    dev = q.device
    b, h, dh = q.shape
    page, kvh = kp.shape[1], kp.shape[2]
    s_len = bt.shape[1] * page
    tok = ((bt.long() * page)[:, :, None]
           + torch.arange(page, device=dev)).reshape(b, s_len)
    rep = h // kvh
    kd = kp.reshape(-1, kvh, dh)[tok].repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    vd = vp.reshape(-1, kvh, dh)[tok].repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    qd = q[:, :, None, :].contiguous()
    masked = torch.arange(s_len, device=dev)[None, :] >= cls[:, None].long()
    bias = torch.zeros(b, h, 1, s_len, dtype=q.dtype, device=dev)
    bias.masked_fill_(masked[:, None, None, :], float("-inf"))
    lib_name = "aten._scaled_dot_product_efficient_attention " \
               "(compute_log_sumexp=True)"
    lib = getattr(torch.ops.aten, "_scaled_dot_product_efficient_attention",
                  None)
    try:
        if lib is None:
            raise RuntimeError("the op is missing from this PyTorch")
        lib(qd, kd, vd, bias, True)
    except RuntimeError as e:
        # the yardstick only (no kernel of the port runs here): say so
        lib_name = (f"SDPA without lse ({lib_name} refused: "
                    f"{str(e).splitlines()[0][:120]})")
        lib = None
    if lib is not None:
        return lib_name, device_ms(lambda: lib(qd, kd, vd, bias, True))
    return lib_name, device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=bias))


def hold_paged_shape(cfg, dev, gen, rows: dict, *, plain: bool = False):
    """The paged decode at ``cfg``'s serving shape (decode_case), a flat
    and a peaked draw, windows 0 and 256, against its plain version; the
    flat draw timed beside SDPA on the gathered cache and the byte bound
    (and the plain version with ``plain``).  Raises the row's
    max_abs_err."""
    shape = f"H{cfg.n_heads}/KV{cfg.n_kv_heads}, dh {cfg.head_dim}"
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, kp, vp, tables, cl = decode_case(cfg, dev, gen)
        q = (q.float() * q_scale).bfloat16()
        for window in (0, 256):
            got = decode_attention_paged_op(q, kp, vp, tables, cl,
                                            window=window)
            want = decode_attention_paged_reference(q, kp, vp, tables,
                                                    cl, window=window)
            torch.cuda.synchronize()
            rows["decode_attention_paged"]["max_abs_err"] = max(
                rows["decode_attention_paged"]["max_abs_err"],
                attn_check(f"paged decode {cfg.name} {draw} (bf16, "
                           f"{shape}, 8 lanes, cache_len 32..1280"
                           f"{f', window {window}' if window else ''})",
                           got, want))
        if draw == "flat":
            ms = device_ms(lambda: decode_attention_paged_op(
                q, kp, vp, tables, cl))
            lib = paged_sdpa_ms(q, kp, vp, tables, cl)
            bnd, by = bound_ms(*paged_bytes_flops(q, cfg.n_kv_heads,
                                                  tables, cl),
                               HW["peak_flops"])
            pl = ""
            if plain:
                pms = cuda_ms(lambda: decode_attention_paged_reference(
                    q, kp, vp, tables, cl), iters=5)
                pl = f", plain {pms:.4f} ms"
            print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms{pl}, "
                  f"SDPA on gathered cache {lib:.4f} ms, bound {bnd:.5f} ms "
                  f"({by})")
        del q, kp, vp, tables, cl


def hold_flash_shape(cfg, dev, gen, rows: dict, *, plain: bool = False):
    """The flash kernel at ``cfg``'s second 512-token chunk over 512 rows,
    a flat and a peaked draw, against its plain version; the flat draw
    timed beside SDPA and the bound (and the plain version with
    ``plain``).  Raises the row's max_abs_err."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, 512, 512, 512)
        q = (q.float() * q_scale).bfloat16()
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        rows["flash_attention_prefill"]["max_abs_err"] = max(
            rows["flash_attention_prefill"]["max_abs_err"],
            attn_check(f"flash prefill {cfg.name} {draw} (bf16, H{h}/"
                       f"KV{kvh}, dh {dh}, C=512, S_past=512, start=512)",
                       got, want))
        if draw == "flat":
            ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
            mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 \
                + (pos.numel() + kv_pos.numel()) * 4
            bnd, by = bound_ms(n_bytes, 4.0 * float(mask.sum()) * h * dh,
                               HW["peak_flops"])
            pl = ""
            if plain:
                pms = cuda_ms(lambda: attention_reference(q, k, v, pos,
                                                          kv_pos), iters=5)
                pl = f", plain {pms:.4f} ms"
            print(f"  flash prefill {cfg.name} (C=512, S_past=512): "
                  f"kernel {ms:.4f} ms{pl}, SDPA {lib:.4f} ms, bound "
                  f"{bnd:.5f} ms ({by})")
            del qt, kt, vt
        del q, k, v, want, got


def phase_moe_heads(dev, gen, rows: dict) -> None:
    """The attention kernels at the MoE and VLM serving shapes (after every
    earlier draw): the paged decode and flash kernels at olmoe-1b-7b's
    (H16/KV16, dh 128) and internvl2-76b's (H64/KV8, dh 128) shapes, and
    the dense decode at olmoe's (phase 5's generate drive: 8 rows, 1024
    slots), flat and peaked, each timed beside its plain version, its
    library call and its bound.  Raises the rows' max_abs_err."""
    for arch in (MOE_ARCH, "internvl2-76b"):
        cfg = get_config(arch)
        hold_paged_shape(cfg, dev, gen, rows, plain=True)
        hold_flash_shape(cfg, dev, gen, rows, plain=True)
    cfg = get_config(MOE_ARCH)
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, k, v, cl = dense_decode_case(dev, gen, 8, h, kvh, dh, 1024, 1024,
                                        q_scale)
        got = decode_attention_op(q, k, v, cl)
        want = decode_attention_dense_reference(q, k, v, cl)
        torch.cuda.synchronize()
        rows["decode_attention_dense"]["max_abs_err"] = max(
            rows["decode_attention_dense"]["max_abs_err"],
            attn_check(f"dense decode {cfg.name} {draw} (bf16, H{h}/KV{kvh},"
                       f" dh {dh}, S_max 1024, cache_len 1..1024)", got,
                       want))
        if draw == "flat":
            ms = device_ms(lambda: decode_attention_op(q, k, v, cl))
            plain_ms = cuda_ms(lambda: decode_attention_dense_reference(
                q, k, v, cl), iters=5)
            lib = dense_decode_sdpa_ms(q, k, v, cl)
            bnd, by = bound_ms(*dense_decode_bytes_flops(q, k, cl),
                               HW["peak_flops"])
            print(f"  dense decode {cfg.name}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA with a boolean mask {lib:.4f} "
                  f"ms, bound {bnd:.5f} ms ({by})")
        del q, k, v, cl
    torch.cuda.empty_cache()


def phase_wide_heads(dev, gen, rows: dict, kernels_only: bool) -> None:
    """The attention kernels at the head shapes the earlier checks do not
    reach, each with a flat and a peaked draw (after every earlier draw,
    whose inputs stay as they were): the paged decode at nemotron-4-340b's
    (H96/KV8, dh 192: three head groups a kv head) and granite-34b's
    (H48/KV1, dh 128: six) serving shapes, the dense decode at H96/KV8, dh
    192 (a ring of 1024 slots, some rows wrapped), the flash kernel at
    nemotron's second 512-token chunk over 512 rows, the partial kernel at
    one granite stripe and one dh-192 stripe.  Each new shape is timed
    beside its library yardstick and bound.  Raises the kernels' rows'
    max_abs_err."""
    if not (hasattr(decode_ops, "head_groups") and 192 in HEAD_DIMS):
        # an older package (a parent commit timed with --kernels) has no
        # head dim 192 and no head groups in the paged kernels
        if kernels_only:
            print("  wide heads: skipped, the package under test predates "
                  "head dim 192")
            return
        raise SystemExit("FAIL: the package's kernels take no head dim 192")
    nem, gra = get_config("nemotron-4-340b"), get_config("granite-34b")
    for cfg in (nem, gra):
        hold_paged_shape(cfg, dev, gen, rows)
    h, kvh, dh = nem.n_heads, nem.n_kv_heads, nem.head_dim
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, k, v, cl = dense_decode_case(dev, gen, 8, h, kvh, dh, 1024, 1224,
                                        q_scale)
        got = decode_attention_op(q, k, v, cl, window=1024)
        want = decode_attention_dense_reference(q, k, v, cl, window=1024)
        torch.cuda.synchronize()
        rows["decode_attention_dense"]["max_abs_err"] = max(
            rows["decode_attention_dense"]["max_abs_err"],
            attn_check(f"dense decode nemotron-4-340b {draw} (bf16, H{h}/"
                       f"KV{kvh}, dh {dh}, S_max 1024, cache_len 1..1224, "
                       f"window 1024, {int((cl > 1024).sum())} rows "
                       f"wrapped)", got, want))
        if draw == "flat":
            ms = device_ms(lambda: decode_attention_op(q, k, v, cl))
            lib = dense_decode_sdpa_ms(q, k, v, cl)
            bnd, by = bound_ms(*dense_decode_bytes_flops(q, k, cl),
                               HW["peak_flops"])
            print(f"  dense decode nemotron-4-340b: kernel {ms:.4f} ms, SDPA "
                  f"with a boolean mask {lib:.4f} ms, bound {bnd:.5f} ms "
                  f"({by})")
        del q, k, v, cl
    hold_flash_shape(nem, dev, gen, rows)
    for cfg in (gra, nem):
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, kp, vp, tables, cl = lse_case(dev, gen, h, kvh, dh, q_scale)
            bt, cls = stripe(tables, cl, 0)
            out, lse = decode_attention_paged_lse_op(q, kp, vp, bt, cls)
            want_o, want_l = decode_attention_paged_lse_reference(
                q, kp, vp, bt, cls)
            torch.cuda.synchronize()
            what = (f"paged lse {cfg.name} {draw} (bf16, H{h}/KV{kvh}, dh "
                    f"{dh}) stripe 0")
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise SystemExit(f"FAIL {what}: non-finite output")
            rows["decode_attention_paged_lse"]["max_abs_err"] = max(
                rows["decode_attention_paged_lse"]["max_abs_err"],
                attn_check(f"{what}: out", out, want_o))
            check(f"{what}: lse (f32)", lse, want_l, LSE_TOL)
            if draw == "flat":
                ms = device_ms(lambda: decode_attention_paged_lse_op(
                    q, kp, vp, bt, cls))
                lib_name, lib = lse_library_ms(q, kp, vp, bt, cls)
                bnd, by = bound_ms(*lse_bytes_flops(q, kvh, bt, cls),
                                   HW["peak_flops"])
                print(f"  paged lse {cfg.name} stripe 0 of 4: kernel "
                      f"{ms:.4f} ms, {lib_name} {lib:.4f} ms, bound "
                      f"{bnd:.5f} ms ({by})")
            del q, kp, vp, tables, cl
    torch.cuda.empty_cache()


def categorical_case(dev, gen, lanes: int, n: int, *, offset: int = 0,
                     mixed: bool = True, std: float = 3.0,
                     temps=(0.6, 1.0, 0.3), dtype=torch.bfloat16):
    """Logits (``dtype``, ``std``) of ``lanes`` rows over the columns
    offset .. offset + n - 1, the temperatures ``temps`` cycled over the
    lanes (with ``mixed`` every fourth lane greedy), request seeds over
    all of uint32 and positions up to 4096: the op's arguments."""
    logits = (torch.randn(lanes, n, generator=gen, device=dev) * std).to(
        dtype)
    temps = torch.tensor(temps, device=dev).repeat(lanes)[:lanes]
    greedy = (torch.arange(lanes, device=dev) % 4 == 1) if mixed \
        else torch.zeros(lanes, dtype=torch.bool, device=dev)
    safe_t = torch.where(greedy, torch.ones_like(temps), temps)
    seeds = torch.randint(0, 2**32, (lanes,), generator=gen, device=dev)
    counters = torch.randint(0, 4097, (lanes,), generator=gen, device=dev)
    return logits, safe_t, greedy, prng_key(0), seeds, counters


def categorical_shapes() -> list:
    """Phase 3's sampling cases (lanes, n, offset, every fourth lane
    greedy): CATEGORICAL_LANES x CATEGORICAL_VOCABS, the tp 4 shard at its
    offset, the main path's shape and the large batch (all sampled)."""
    cases = [(lanes, n, 0, True) for lanes in CATEGORICAL_LANES
             for n in CATEGORICAL_VOCABS]
    lanes, part, k = CATEGORICAL_SHARD
    cases.append((lanes, part, k * part, True))
    cases.append(CATEGORICAL_MAIN + (0, False))
    cases.append(CATEGORICAL_LARGE + (0, False))
    return cases


def categorical_scores(logits, safe_t, greedy, base, seeds, counters,
                       offset: int = 0):
    """The plain version's scores of every column (lanes, n)."""
    keys = categorical_ref.lane_keys(base, seeds, counters)
    noise = categorical_ref.gumbel(keys, logits.shape[-1], offset)
    x = logits.float()
    return torch.where(greedy[:, None], x, x / safe_t[:, None] + noise)


def categorical_agrees(label: str, got, args, offset: int = 0) -> tuple:
    """A draw (value, index) against the plain version's on the same
    inputs: tokens equal on every lane but a near tie of the plain
    version's scores (within CATEGORICAL_NEAR_TIE), values within the same
    bar where the tokens agree (NaN where the plain value is NaN).
    Returns (worst value error, near-tie lanes); fails the run
    otherwise."""
    value, index = got
    torch.cuda.synchronize()
    want_v, want_i = categorical_ref.categorical(*args, offset=offset)
    top2 = categorical_scores(*args, offset=offset).topk(2).values
    bar = CATEGORICAL_NEAR_TIE * top2[:, 0].abs().clamp(min=1.0)
    same = index == want_i
    near = (top2[:, 0] - top2[:, 1]) <= bar
    bad = int((~same & ~near).sum())
    ties = int((~same).sum())
    nan = want_v.isnan()
    bad += int((same & (nan != value.isnan())).sum())
    finite = same & ~nan & torch.isfinite(want_v)
    err = (value - want_v).abs()
    worst = float(err[finite].max()) if bool(finite.any()) else 0.0
    bad += int((err[finite] > bar[finite]).sum())
    bad += int((same & ~nan & ~torch.isfinite(want_v)
                & (value != want_v)).sum())
    lanes = index.numel()
    print(f"  {label}: tokens {int(same.sum())}/{lanes} equal, {ties} "
          f"near-tie lanes, value max_abs_err {worst:.3e} "
          f"{'OK' if bad == 0 else f'{bad} lanes out of tolerance'}")
    if bad:
        raise SystemExit(f"FAIL {label}: the kernel disagrees with its plain "
                         f"version")
    return worst, ties


def categorical_bound(logits, greedy):
    """(bytes, integer ALU operations, instructions) the draw needs: the
    logits read once, the small inputs and the (value, index) out; each
    sampled column's draw as the built SASS counts it, each
    sampled lane's key."""
    lanes, n = logits.shape
    sampled = int((~greedy).sum())
    n_bytes = logits.numel() * logits.element_size() + lanes * (
        4 + 1 + 8 + 8) + lanes * (4 + 8)
    ops = sampled * (n * CATEGORICAL_COLUMN_OPS + CATEGORICAL_KEY_OPS)
    instrs = sampled * (n * CATEGORICAL_COLUMN_INSTRS + CATEGORICAL_KEY_OPS)
    return n_bytes, ops, instrs


def categorical_bound_ms(logits, greedy):
    """The draw's bound (ms, by): the largest of its bytes over the HBM
    rate, its integer ALU operations over INT32_OPS and its instructions
    over ISSUE_RATE."""
    n_bytes, ops, instrs = categorical_bound(logits, greedy)
    terms = {"bytes": n_bytes / HW["hbm_bw"] * 1e3,
             "operations": ops / INT32_OPS * 1e3,
             "instructions": instrs / ISSUE_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def phase_categorical(dev) -> dict:
    """The sampling kernel against its plain version on the card (after
    every earlier draw, from a generator of its own): at each of
    CATEGORICAL_DRAWS, mixed greedy and sampled lanes at
    CATEGORICAL_LANES x CATEGORICAL_VOCABS, a tp 4 vocab shard at its
    offset, the main path's shape and a large batch; then f32 logits and
    the hand-made rows (``repro_torch.testing.sampling``) in f32 and bf16;
    first the kernel's division and noise against the library's over
    every input (tools/categorical_variants/exact_check.cu).
    Tokens equal on every lane but a near tie of the plain
    version's scores (counted and printed; 0 expected), values within
    CATEGORICAL_NEAR_TIE where the tokens agree; one counted launch a call
    (tests/test_torch_gpu.py holds it to one device kernel under
    torch.profiler).  At every shape
    and draw the kernel is timed on the device in turns with the parent's
    (tools/categorical_variants/two_launch.cu) beside its bound; the plain
    version eagerly at the std-3 draw (no library call: torch has no
    threefry)."""
    from repro_torch.testing.sampling import edge_rows
    gen = torch.Generator(device=dev).manual_seed(27)
    row = {"name": "categorical", "route": "cuda",
           "source": "src/repro_torch/csrc/categorical.cu",
           "replaces": "src/repro/serving/engine.py:314 "
                       "(jax.random.categorical by XLA; no Pallas kernel)",
           "max_abs_err": 0.0, "library_ms": None, "near_tie_lanes": 0}
    if "categorical" in BUILD_LOGS:
        print("  the kernel (ptxas):")
        print_ptxas(BUILD_LOGS["categorical"])
    if "log" in PARENT_CATEGORICAL:
        print("  the parent's kernel "
              "(tools/categorical_variants/two_launch.cu, ptxas):")
        print_ptxas(PARENT_CATEGORICAL["log"])
    try:
        from tools import categorical_variants
        from repro_torch.kernels.build import CSRC_DIR, _library_path
        counts = categorical_variants.sass_counts(
            _library_path(CSRC_DIR / "categorical.cu"))
        print("  SASS recount: " + categorical_variants.format_counts(counts)
              + f" (pinned: {CATEGORICAL_COLUMN_OPS} ALU ops, "
              f"{CATEGORICAL_COLUMN_INSTRS} instructions a column)")
    except (ImportError, RuntimeError, OSError,
            subprocess.SubprocessError) as e:
        print(f"  SASS recount: not counted ({e})")
    if "exact_check" in PARENT_CATEGORICAL:
        fast, bad, bad_noise = PARENT_CATEGORICAL["exact_check"]()
        print(f"  the kernel's division over every f32 x at "
              f"{PARENT_CATEGORICAL['temperatures']} temperatures: {fast} on "
              f"its fast path, {bad} differ from __fdiv_rn; its noise over "
              f"all 2**23 uniforms: {bad_noise} differ from "
              f"-logf(-logf(u))")
        if bad or bad_noise:
            raise SystemExit("FAIL categorical: the kernel's division or "
                             "noise differs from the library's")
    else:
        print("  the kernel's division and noise: not checked against the "
              "library's (no tools/categorical_variants.py)")

    def one_launch(label, args, offset=0):
        before = CATEGORICAL_KERNEL.launches
        got = categorical(*args, offset=offset)
        if CATEGORICAL_KERNEL.launches != before + 1:
            raise SystemExit(f"FAIL {label}: the op did not count one "
                             f"launch")
        worst, ties = categorical_agrees(label, got, args, offset)
        row["max_abs_err"] = max(row["max_abs_err"], worst)
        row["near_tie_lanes"] += ties

    for draw, std, temps in CATEGORICAL_DRAWS:
        for lanes, n, offset, mixed in categorical_shapes():
            args = categorical_case(dev, gen, lanes, n, offset=offset,
                                    mixed=mixed, std=std, temps=temps)
            kind = " (every fourth greedy)" if mixed else " (all sampled)"
            label = (f"categorical {draw}, {lanes} lanes x {n}"
                     f"{f' at offset {offset}' if offset else ''}{kind}")
            one_launch(label, args, offset)
            fns = {"kernel": lambda: categorical(*args, offset=offset)}
            if "run" in PARENT_CATEGORICAL:
                fns["parent"] = lambda: PARENT_CATEGORICAL["run"](
                    *args, offset=offset)
            times = in_turns(fns)
            ms = times["kernel"]
            plain_ms = None
            if std == CATEGORICAL_DRAWS[0][1]:
                plain_ms = cuda_ms(lambda: categorical_ref.categorical(
                    *args, offset=offset), iters=3, warmup=1)
            n_bytes, ops, instrs = categorical_bound(args[0], args[2])
            bnd, by = categorical_bound_ms(args[0], args[2])
            print(f"    kernel {ms:.5f} ms, {versus_parent(times)}"
                  f"{f', plain {plain_ms:.4f} ms' if plain_ms else ''}; "
                  f"bound {bnd:.5f} ms ({by}: {ops / 1e6:.1f} M ALU ops, "
                  f"{instrs / 1e6:.1f} M instructions, {n_bytes / 1e6:.2f} "
                  f"MB)")
            if (lanes, n) == CATEGORICAL_MAIN and not mixed:
                key = "" if std == CATEGORICAL_DRAWS[-1][1] else "_std3"
                row.update({f"ms{key}": ms,
                            f"parent_ms{key}": times.get("parent")})
                if key == "":
                    row.update(bound_ms=bnd, bound_by=by)
                if plain_ms is not None:
                    row["plain_ms"] = plain_ms
            del args
    args = categorical_case(dev, gen, 16, 50304, dtype=torch.float32)
    one_launch("categorical f32, 16 lanes x 50304 (every fourth greedy)",
               args)
    for dtype in (torch.float32, torch.bfloat16):
        rows = edge_rows(dev, dtype)
        one_launch(f"categorical hand-made rows, {dtype}", rows.args)
        _, index = categorical(*rows.args)
        for lane, col in rows.want.items():
            if lane != 5 and int(index[lane]) != col:   # 5: the CPU's tie
                raise SystemExit(f"FAIL categorical hand-made lane {lane}: "
                                 f"column {int(index[lane])}, not {col}")
    print(f"  categorical: {row['near_tie_lanes']} near-tie lanes in all "
          f"(0 expected)")
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------- phase 4

class ShapeRecordingBackend(CudaPriorityBackend):
    """The CUDA Gittins backend, noting the (n, k) of every refresh."""

    def __init__(self, device):
        super().__init__(device=device)
        self.shapes = []

    def gittins(self, support, probs, attained):
        self.shapes.append(np.shape(support))
        return super().gittins(support, probs, attained)


def make_requests(cfg, seed: int, temperature: float = 0.0):
    """Two waves of 8 requests (greedy unless ``temperature`` > 0): long
    prompts (512-1024 tokens, 128-256 new) first, then short ones
    (32-256 tokens, 32-128 new)."""
    rng = np.random.default_rng(seed)
    waves = []
    for w, (lo, hi, nlo, nhi) in enumerate(((512, 1024, 128, 256),
                                           (32, 256, 32, 128))):
        wave = []
        for i in range(8):
            n = int(rng.integers(lo, hi + 1))
            toks = [int(t) for t in rng.integers(3, cfg.vocab_size, n)]
            wave.append(ServeRequest(
                f"w{w}r{i}", f"wave {w} request {i} topic {i % 3}", toks,
                max_new_tokens=int(rng.integers(nlo, nhi + 1)),
                temperature=temperature, eos_token=-1))
        waves.append(wave)
    return waves


def serve(cfg, params, dev, step_mode: str, *, n_slots=8, max_seq_len=2048,
          capacity_tokens=8192, prefill_chunk=512, first_wave_steps=24,
          seed=0, mesh=None, parallel="exact", graphs=True,
          temperature=0.0):
    """Serve the two waves; returns (engine, requests, seconds, backend).
    Fails if the fused step's keys exceed ``max_fused_compiles()``."""
    backend = ShapeRecordingBackend(dev)
    engine = ServingEngine(
        model=build_model(cfg),
        scheduler=Scheduler(policy=make_policy("sagesched"),
                            priority_backend=backend, bucket_size=50),
        n_slots=n_slots, max_seq_len=max_seq_len,
        capacity_tokens=capacity_tokens, prefill_chunk=prefill_chunk,
        params=params, step_mode=step_mode, seed=seed, device=dev,
        mesh=mesh, parallel=parallel, graphs=graphs)
    waves = make_requests(cfg, seed, temperature)
    t0 = time.perf_counter()
    engine.submit_batch(waves[0])
    for _ in range(first_wave_steps):
        engine.step()
    engine.submit_batch(waves[1])
    engine.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    reqs = waves[0] + waves[1]
    unfinished = [r.request_id for r in reqs
                  if r.state != RequestState.FINISHED]
    if unfinished:
        raise SystemExit(f"FAIL serve[{step_mode}]: unfinished {unfinished}")
    if engine.fused_compile_count > engine.max_fused_compiles():
        raise SystemExit(f"FAIL serve[{step_mode}]: fused keys "
                         f"{engine.fused_compile_count} exceed the bound "
                         f"{engine.max_fused_compiles()}")
    return engine, reqs, seconds, backend


def graph_report(engine) -> str:
    """The fused keys against their bound, the graphs captured (and the
    host seconds of the keys' first calls: the eager step and its
    capture), the host ms of a steady-state decode call (staging, replay
    or the eager step, copy back, wait; calls after each key's first),
    and the prefill steps' keys, graphs, first-call seconds and steady
    host ms."""
    runners = list(engine._fused_runners.values())
    if engine._orchestrated_runner is not None:
        runners.append(engine._orchestrated_runner)
    calls = sum(r.calls - 1 for r in runners)
    ms = sum(r.steady_s for r in runners) * 1e3 / max(calls, 1)
    pre = engine.prefill_report()
    pre_steady = pre["calls"] - len(pre["keys"])
    return (f"{'graphs' if engine.graphs else 'eager'}: fused keys "
            f"{engine.fused_compile_count} / max_fused_compiles() "
            f"{engine.max_fused_compiles()}, graphs captured "
            f"{engine.graphs_captured} (first calls and captures "
            f"{engine._step_graphs.first_s:.3f} s), {calls} steady calls "
            f"at {ms:.3f} host ms; prefill keys "
            f"{engine.prefill_compile_count}, prefill graphs {pre['graphs']}"
            f" (first calls and captures {pre['first_s']:.3f} s), "
            f"{pre_steady} steady prefill calls at "
            f"{pre['steady_s'] * 1e3 / max(pre_steady, 1):.3f} host ms")


def replay_wave(engine, reqs, steps: int = 8) -> tuple[list, dict]:
    """A third wave on a drive's engine once its two waves are done: the
    first wave's prompts again (new ids, ``steps`` new tokens each), whose
    prefill keys the first wave made.  Returns (its requests, the prefill
    report's growth: new keys and new graphs)."""
    before = engine.prefill_report()
    wave = [ServeRequest(f"w2r{i}", r.prompt, list(r.prompt_tokens),
                         max_new_tokens=steps, temperature=r.temperature,
                         eos_token=r.eos_token) for i, r in enumerate(reqs[:8])]
    engine.submit_batch(wave)
    engine.run_until_done()
    after = engine.prefill_report()
    if any(r.state != RequestState.FINISHED for r in wave):
        raise SystemExit("FAIL replay wave: unfinished requests")
    return wave, {"keys": len(after["keys"]) - len(before["keys"]),
                  "graphs": after["graphs"] - before["graphs"]}


def wave_ttft(reqs) -> str:
    """TTFT p50 of each wave of 8 requests."""
    return ", ".join(
        f"wave {w} {np.median([r.ttft for r in reqs[8 * w:8 * w + 8]]):.4f} s"
        for w in range(len(reqs) // 8))


def hold_eager(label: str, got, launches, want, want_launches) -> None:
    """An eager drive against its graphed twin: token-identical streams
    and launch for launch the same kernel counts."""
    same = sum(a == b for a, b in zip(got, want))
    print(f"    {label} graphs vs eager: {same}/{len(got)} streams "
          f"identical (held), launches "
          f"{'equal' if launches == want_launches else 'DIFFERENT'} "
          f"(held)")
    if got != want or launches != want_launches:
        raise SystemExit(f"FAIL {label}: the eager drive parts from the "
                         f"graphed one (launches {launches} against "
                         f"{want_launches})")


def path_kernels(cfg) -> tuple:
    """The kernels a served model's main path launches."""
    attn = (PAGED_DECODE_KERNEL, FLASH_PREFILL_KERNEL)
    return (GITTINS_KERNEL,) + {"dense": attn, "moe": attn, "vlm": attn,
                                "ssm": (SSD_SCAN_KERNEL,),
                                "hybrid": (SSD_SCAN_KERNEL,) + attn
                                }[cfg.family]


def swap_bytes(engine) -> int:
    """Bytes of one request's recurrent state in a swap payload."""
    ssm = engine._cache.get("ssm", {})
    return sum(t[:, 0].numel() * t.element_size() for t in ssm.values())


def step_weight_bytes(cfg) -> int:
    """Bytes of weights one decode step must read: every parameter but the
    embedding table, of which it gathers one row a lane (the MoE's dense
    dispatch runs every expert's GEMMs, so every expert is read)."""
    model = build_model(cfg)
    return sum(math.prod(spec.shape) * spec.dtype.itemsize
               for path, spec in iter_specs(model.template())
               if path != ("embed",))


def phase_serve(cfg, dev, params=None) -> tuple[dict, tuple, dict]:
    """The graphed fused and orchestrated drives (their launches are the
    phase's), then, per EAGER_HELD and SAMPLED_HELD, the eager and
    sampled drives held to their graphed twins.  An attention family's
    drives launch the paged decode and flash kernels exactly as often as
    the path calls them.  ``params``: another phase's weights (else made
    here from seed 0).  Returns (launches, the largest Gittins shape, the
    streams by drive)."""
    if params is None:
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
    kernels = path_kernels(cfg)
    step_bytes = step_weight_bytes(cfg)
    drives = [("fused", True, 0.0), ("orchestrated", True, 0.0)]
    if cfg.name in SERVED:
        # the prefill steps graphed too: both modes held to eager twins
        drives += [("fused", False, 0.0), ("orchestrated", False, 0.0)]
    elif cfg.name in EAGER_HELD:
        drives.append(("fused", False, 0.0))
    if cfg.name in SAMPLED_HELD:
        drives += [("fused", True, SAMPLED_T), ("fused", False, SAMPLED_T)]
    streams, launches, rates, max_shape = {}, {}, {}, (0, 0)
    for mode, graphs, temp in drives:
        label = f"{mode}, {'graphs' if graphs else 'eager'}" + (
            f", T {temp}" if temp else "")
        # a sampled drive's path draws through the sampling kernel too
        drive_kernels = kernels + ((CATEGORICAL_KERNEL,) if temp else ())
        for kern in drive_kernels:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        engine, reqs, secs, backend = serve(cfg, params, dev, mode,
                                            graphs=graphs, temperature=temp)
        replay, grew = replay_wave(engine, reqs)
        launches[label] = {k.symbol: k.launches for k in drive_kernels}
        streams[label] = [r.output_tokens for r in reqs]
        streams[label + ", replay"] = [r.output_tokens for r in replay]
        m = engine.metrics.summary(reqs)
        gen_tokens = sum(r.generated for r in reqs)
        ttft = np.array([r.ttft for r in reqs])
        ttlt = np.array([r.ttlt for r in reqs])
        rates[label] = gen_tokens / secs
        print(f"  serve[{label}] {torch.cuda.get_device_name(0)}: "
              f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens in "
              f"{secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT p50 "
              f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} s, "
              f"preemptions {m['preemptions']}, swap outs {m['swap_outs']}, "
              f"swap ins {m['swap_ins']}, prefill chunks "
              f"{m['prefill_chunks']}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches[label]}")
        print(f"    TTFT p50 {wave_ttft(reqs + replay)} (wave 2: wave 0's "
              f"prompts again, {len(replay[0].output_tokens)} tokens each); "
              f"wave 2 made {grew['keys']} new prefill keys, captured "
              f"{grew['graphs']} new prefill graphs (held 0)")
        if grew["graphs"]:
            raise SystemExit(f"FAIL serve[{label}]: the replayed wave "
                             f"captured {grew['graphs']} new prefill graphs")
        if engine._step_graphs.enabled and engine.prefill_report()[
                "graphs"] != engine.prefill_compile_count:
            raise SystemExit(f"FAIL serve[{label}]: prefill keys "
                             f"{engine.prefill_compile_count}, graphs "
                             f"{engine.prefill_report()['graphs']}")
        print(f"    {graph_report(engine)}; a decode step's weights "
              f"{step_bytes / 1e9:.3f} GB, byte bound "
              f"{step_bytes / HW['hbm_bw'] * 1e3:.3f} ms")
        if engine._slot_state:
            per = swap_bytes(engine)
            print(f"    recurrent state per swap payload {per / 1e6:.1f} MB; "
                  f"{(m['swap_outs'] + m['swap_ins']) * per / 1e9:.3f} GB "
                  f"moved by {m['swap_outs']} swap outs + {m['swap_ins']} "
                  f"swap ins")
        if m["preemptions"] == 0 or m["swap_outs"] == 0:
            raise SystemExit(f"FAIL serve[{label}]: the scheduler did not "
                             f"preempt and swap ({m['preemptions']} "
                             f"preemptions, {m['swap_outs']} swap outs)")
        for shape in backend.shapes:
            if shape[0] * shape[1] > max_shape[0] * max_shape[1]:
                max_shape = shape
        missing = [s for s, n in launches[label].items() if n == 0]
        if missing:
            raise SystemExit(f"FAIL serve[{label}]: kernels never launched "
                             f"on the main path: {missing}")
        # every family: the prefill launches (flash, SSD) included
        want = tp_launches(cfg, engine, m)
        if {k: launches[label].get(k, 0) for k in want} != want:
            raise SystemExit(f"FAIL serve[{label}]: launches "
                             f"{launches[label]}, the path calls {want}")
        if temp:
            # every lane sampled: one draw a decode iteration of the
            # fused step, the third wave's included
            want_draws = engine.metrics.decode_iterations
            got_draws = launches[label][CATEGORICAL_KERNEL.symbol]
            print(f"    sampling kernel launches {got_draws}, one a fused "
                  f"decode iteration {want_draws} (held)")
            if got_draws != want_draws:
                raise SystemExit(f"FAIL serve[{label}]: {got_draws} "
                                 f"sampling launches, the path draws "
                                 f"{want_draws} times")
        print(f"    launches as the path calls them (held): {want}")
        if not graphs:
            twin = label.replace("eager", "graphs")
            hold_eager(f"serve[{label}]",
                       streams[label] + streams[label + ", replay"],
                       launches[label],
                       streams[twin] + streams[twin + ", replay"],
                       launches[twin])
        del engine
        torch.cuda.empty_cache()
    fused, orch = streams["fused, graphs"], streams["orchestrated, graphs"]
    assert_tokens_close(fused, orch)
    same = sum(a == b for a, b in zip(fused, orch))
    print(f"  fused vs orchestrated: assert_tokens_close OK, {same}/"
          f"{len(fused)} streams identical")
    sampled = streams.get(f"fused, graphs, T {SAMPLED_T}")
    if sampled is not None:
        differ = sum(a != b for a, b in zip(sampled, fused))
        print(f"  sampled vs greedy (graphs): {differ}/{len(fused)} streams "
              f"differ (the noise is drawn); fused tok/s at T {SAMPLED_T} "
              f"{rates[f'fused, graphs, T {SAMPLED_T}']:.1f} against "
              f"greedy {rates['fused, graphs']:.1f}")
        if differ == 0:
            raise SystemExit("FAIL serve: the sampled streams equal the "
                             "greedy ones")
    del params
    torch.cuda.empty_cache()
    total = {s: launches["fused, graphs"][s]
             + launches["orchestrated, graphs"][s]
             for s in launches["fused, graphs"]}
    # the sampling kernel's launches: the graphed sampled drive's
    draws = launches.get(f"fused, graphs, T {SAMPLED_T}", {})
    if CATEGORICAL_KERNEL.symbol in draws:
        total[CATEGORICAL_KERNEL.symbol] = draws[CATEGORICAL_KERNEL.symbol]
    return total, max_shape, streams


def phase_serve_wide(cfg, params, dev, eager: bool = False) -> dict:
    """One fused drive of the two waves at a WIDE or MOE_WIDE shape: every
    request must finish, the scheduler must preempt and swap, and the
    paged decode and flash kernels must launch exactly as often as the
    path calls them (one a layer per decode call and per prefill chunk).
    With ``eager`` the drive runs again with graphs=False, held
    token-identical to it, launch for launch.  Returns the graphed
    drive's launches."""
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    engine, reqs, secs, _ = serve(cfg, params, dev, "fused")
    launches = {k.symbol: k.launches for k in kernels}
    step_bytes = step_weight_bytes(cfg)
    m = engine.metrics.summary(reqs)
    gen_tokens = sum(r.generated for r in reqs)
    ttft = np.array([r.ttft for r in reqs])
    ttlt = np.array([r.ttlt for r in reqs])
    print(f"  serve[fused] {cfg.name} {torch.cuda.get_device_name(0)}: "
          f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens in "
          f"{secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT p50 "
          f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} s, "
          f"preemptions {m['preemptions']}, swap outs {m['swap_outs']}, "
          f"swap ins {m['swap_ins']}, decode calls "
          f"{m['decode_iterations']}, prefill chunks {m['prefill_chunks']}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {launches}")
    print(f"    {graph_report(engine)}; a decode step's weights "
          f"{step_bytes / 1e9:.3f} GB, byte bound "
          f"{step_bytes / HW['hbm_bw'] * 1e3:.3f} ms")
    if m["preemptions"] == 0 or m["swap_outs"] == 0:
        raise SystemExit(f"FAIL serve {cfg.name}: the scheduler did not "
                         "preempt and swap")
    want = tp_launches(cfg, engine, m)
    if {k: launches[k] for k in want} != want \
            or launches[GITTINS_KERNEL.symbol] == 0:
        raise SystemExit(f"FAIL serve {cfg.name}: launches {launches}, the "
                         f"path calls {want} and Gittins")
    del engine
    torch.cuda.empty_cache()
    if eager:
        for kern in kernels:
            kern.launches = 0
        engine, twin, secs, _ = serve(cfg, params, dev, "fused",
                                      graphs=False)
        print(f"  serve[fused, eager] {cfg.name}: "
              f"{sum(r.generated for r in twin) / secs:.1f} tok/s")
        hold_eager(f"serve {cfg.name}", [r.output_tokens for r in twin],
                   {k.symbol: k.launches for k in kernels},
                   [r.output_tokens for r in reqs], launches)
        del engine
        torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------------- phase 4b

def tp_launches(cfg, engine, m) -> dict:
    """The attention and SSD launches a drive's path makes: per decode
    call one paged kernel per attention layer (the hybrid's shared block
    once a group) and attention shard (kv-head shards where the plan
    shards attention, else one), or, under the LSE split, one partial
    kernel per layer and stripe; per prefill chunk (a recurrent family's
    atomic prefill is one) one flash kernel per attention layer and
    attention shard, and one SSD scan per Mamba2 layer and SSM shard
    (head shards where the plan shards the SSM, else one)."""
    report = engine.sharding_report() or {"attention": "replicated",
                                          "attn_splits": 1}
    shards = engine.tp if report["attention"] == "sharded" else 1
    n_attn = cfg.n_layers if cfg.family in ("dense", "moe", "vlm") else (
        -(-cfg.n_layers // cfg.hybrid_attn_every)
        if cfg.family == "hybrid" else 0)
    per_step = n_attn * m["decode_iterations"]
    lse = report["attn_splits"] > 1
    out = {PAGED_DECODE_KERNEL.symbol: 0 if lse else per_step * shards,
           PAGED_LSE_KERNEL.symbol: per_step * engine.tp if lse else 0,
           FLASH_PREFILL_KERNEL.symbol: n_attn * m["prefill_chunks"] * shards}
    if cfg.family in ("ssm", "hybrid"):
        ssm = engine.tp if report.get("ssm") == "sharded" else 1
        out[SSD_SCAN_KERNEL.symbol] = cfg.n_layers * m["prefill_chunks"] * ssm
    return out


@contextlib.contextmanager
def recorded_routes():
    """The experts ``moe_route`` picks inside the block, call by call: a
    list of (N, K) tensors, each row's picks sorted (empty for a model
    without MoE layers)."""
    calls, orig = [], moe_module.moe_route

    def record(params, xf, cfg, *, decode):
        out = orig(params, xf, cfg, decode=decode)
        experts = out[1] // out[0].shape[1]         # row // C
        calls.append(experts.view(xf.shape[0], -1).sort(dim=-1).values)
        return out

    moe_module.moe_route = transformer_module.moe_route = record
    try:
        yield calls
    finally:
        moe_module.moe_route = transformer_module.moe_route = orig


def tp_step_check(cfg, params, plan, shard_params, dev, *,
                  hold: bool = True) -> dict:
    """One decode step of ``plan`` (``shard_params``: ``params`` placed by
    it) against the same step without
    a mesh, on the same pool and inputs: 8 rows of 37..512 tokens whose
    K/V a forward over random 512-token prompts wrote into a paged pool
    (and whose recurrent state is that forward's final state: the SSM
    reads no cache_len).
    Holds the logits within TP_STEP_ULPS bf16 steps (at the unsharded
    step's largest |logit|) on every row whose MoE layers picked the
    unsharded step's experts (all rows of a model without them; at least
    one row must remain), and the argmax identical on every row except
    where the plan's pick lies within 2 steps of the unsharded maximum.
    A row whose experts differ in some layer, a discrete flip of a near
    tie in the router, is counted and its drift printed.  ``hold=False``
    prints the same numbers without holding them."""
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, page = 8, 512, 16
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)
    with torch.no_grad():
        _, cache, _ = model.forward(params, {"tokens": toks},
                                    collect_cache=True)
    p = s // page + 1
    tables = (1 + torch.arange(b * p, device=dev, dtype=torch.int32)
              ).reshape(b, p)
    pool = model.init_paged_cache(b * p + 1, page, b, device=dev)
    idx = (tables[:, :s // page].long()[:, :, None] * page
           + torch.arange(page, device=dev)).reshape(b * s)
    if "k" in pool:
        L = pool["k"].shape[0]
        for name in ("k", "v"):
            pool[name].view(L, -1, kvh, dh)[:, idx] = \
                cache[name].reshape(L, b * s, kvh, dh)
    if "ssm" in pool:          # each slot's state after its 512 tokens
        for name, t in pool["ssm"].items():
            t.copy_(cache["ssm"][name])
    del cache
    cl = torch.tensor([37, 129, 250, 300, 401, 466, 500, 512],
                      dtype=torch.int32, device=dev)
    last = toks[:, -1:]
    with recorded_routes() as want_routes:
        want, _ = model.decode_step_paged(
            params, last, tree_unflatten(pool, [t.clone() for t in
                                                tree_leaves(pool)]), cl,
            tables, page_size=page)
    with plan.context(), recorded_routes() as got_routes:
        got, _ = model.decode_step_paged(
            shard_params, last, plan.place_cache(pool), cl, tables,
            page_size=page)
    if isinstance(got, list):
        got = plan.all_gather(got, -1)
    torch.cuda.synchronize()
    want, got = want.float(), got.float()
    if not torch.isfinite(got).all():
        raise SystemExit("FAIL tp step: non-finite logits")
    step = float(bf16_ulp(want.abs().max()))
    row_drift = (got - want).abs().max(dim=-1).values / step
    same = torch.ones(b, dtype=torch.bool, device=dev)
    for w, g in zip(want_routes, got_routes):
        same &= (w == g.to(w.device)).all(dim=-1)
    drift = float(row_drift[same].max()) if bool(same.any()) else math.inf
    wmax = want.max(dim=-1).values
    pick = got.argmax(dim=-1)
    flip = pick != want.argmax(dim=-1)
    margin = (wmax - want.gather(-1, pick[:, None])[:, 0]) / bf16_ulp(wmax)
    out = {"drift_ulps": drift, "flips": int(flip.sum()),
           "flip_ulps_max": float(margin[flip].max()) if bool(flip.any())
           else 0.0, "rerouted": int((~same).sum())}
    rerouted = ""
    if want_routes:
        there = float(row_drift[~same].max()) if out["rerouted"] else 0.0
        rerouted = (f"; {out['rerouted']}/{b} rows picked other experts in "
                    f"some layer (max logit diff there {there:.2f} steps, "
                    f"not held)")
    print(f"    one decode step vs no mesh ({cfg.n_layers} layers): max "
          f"logit diff {drift:.2f} bf16 steps ("
          f"{f'bar {TP_STEP_ULPS}' if hold else 'printed, not held'}; step "
          f"{step:.4g} at max |logit| {float(want.abs().max()):.4g})"
          f"{rerouted}, argmax differs at {out['flips']}/{b} rows (largest "
          f"margin {out['flip_ulps_max']:.2f} steps"
          f"{', excused within 2' if hold else ''})")
    if hold and (drift > TP_STEP_ULPS
                 or bool((flip & (margin > 2)).any())):
        raise SystemExit("FAIL tp step: the plan's decode step is not "
                         "within its bars of the unsharded step")
    return out


def lse_stripe_check(dev, n: int) -> None:
    """Whether the LSE split's merged decode of one row is the same at two
    table widths (the fused step's pow2 of the pages in use, 64, and the
    orchestrated step's whole table, 128): each stripe's partial kernel
    is width-invariant, the stripes' boundaries are not."""
    cfg = get_config(TP_ARCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, tables, cl = lse_case(dev, gen, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)
    cl = torch.clamp(cl, max=1024)      # every row within the first 64 pages
    args = (q[:, None], kp, vp)
    narrow = decode_attention_paged(*args, tables[:, :64].contiguous(), cl,
                                    n_splits=n)
    whole = decode_attention_paged(*args, tables, cl, n_splits=n)
    cls = torch.clamp(cl, max=16 * 16)  # live rows within the 16 pages
    part = [decode_attention_paged_lse_op(q, kp, vp, t.contiguous(), cls)
            for t in (tables[:, :16], torch.nn.functional.pad(
                tables[:, :16], (0, 16)))]
    torch.cuda.synchronize()
    same = [int(torch.equal(narrow[r], whole[r])) for r in range(len(cl))]
    print(f"    LSE split of {n} stripes, tables of 64 and 128 pages: "
          f"{sum(same)}/{len(same)} rows bit-identical; one stripe's "
          f"partial at widths 16 and 32: "
          f"{'bit-identical' if all(torch.equal(a, b) for a, b in zip(*part)) else 'DIFFERENT'}")


def phase_serve_tp(dev, arch=TP_ARCH, drives=TP_DRIVES, params=None,
                   known=None, eager_held=TP_EAGER_HELD,
                   same_streams=TP_SAME_STREAMS) -> dict:
    """``arch`` at full width through ``drives`` (TP_DRIVES' labels), every
    shard on the one card; ``params`` another phase's weights (else made
    here from seed 0), ``known`` the streams of drives run elsewhere (the
    no-mesh (a), by step mode: (b) is held to (a) in its own mode).  An
    MoE plan must report its experts sharded, a recurrent one its SSM
    replicated (exact) or sharded (efficient).  Returns the summed
    launches."""
    cfg = get_config(arch)
    if params is None:
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL, SSD_SCAN_KERNEL)
    total = {k.symbol: 0 for k in kernels}
    streams = dict(known or {})
    recurrent = cfg.family in ("ssm", "hybrid")
    for label, tp, parallel, modes in drives:
        graph_launches = {}
        mesh = None if tp is None else make_local_mesh(
            tp=tp, devices=[dev] * tp)
        runs = [(mode, graphs) for mode in modes
                for graphs in ((True, False) if label in eager_held
                               else (True,))]
        for mode, graphs in runs:
            for kern in kernels:
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            engine, reqs, secs, _ = serve(cfg, params, dev, mode, mesh=mesh,
                                          parallel=parallel, graphs=graphs)
            launches = {k.symbol: k.launches for k in kernels}
            m = engine.metrics.summary(reqs)
            gen_tokens = sum(r.generated for r in reqs)
            ttft = np.array([r.ttft for r in reqs])
            ttlt = np.array([r.ttlt for r in reqs])
            report = engine.sharding_report()
            branch = "no mesh" if report is None else (
                f"tp {tp} {parallel}: attention {report['attention']}, "
                f"attn_splits {report['attn_splits']}, vocab "
                f"{report['vocab']}, mlp {report['mlp']}, experts "
                f"{report['experts']}, ssm {report['ssm']}")
            how = "" if graphs else ", eager"
            print(f"  ({label}) serve[{mode}{how}] {cfg.name} {branch} "
                  f"{torch.cuda.get_device_name(0)}: {len(reqs)}/{len(reqs)} "
                  f"finished, {gen_tokens} tokens in {secs:.3f} s = "
                  f"{gen_tokens / secs:.1f} tok/s, TTFT p50 "
                  f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} "
                  f"s, preemptions {m['preemptions']}, swap outs "
                  f"{m['swap_outs']}, swap ins {m['swap_ins']}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                  f"decode calls {m['decode_iterations']}, launches "
                  f"{launches}")
            print(f"    {graph_report(engine)}")
            if m["preemptions"] == 0 or m["swap_outs"] == 0:
                raise SystemExit(f"FAIL tp ({label}): the scheduler did not "
                                 "preempt and swap")
            want = tp_launches(cfg, engine, m)
            if {k: launches[k] for k in want} != want \
                    or launches[GITTINS_KERNEL.symbol] == 0:
                raise SystemExit(f"FAIL tp ({label}): launches {launches}, "
                                 f"the path calls {want} and Gittins")
            expect = {"a": None,
                      "b": ("sharded", 1, "replicated", "replicated"),
                      "c": ("sharded", 1, "sharded", "sharded"),
                      "d": ("lse-split", 4, "sharded", "sharded")}[label]
            if (report and (report["attention"], report["attn_splits"],
                            report["vocab"], report["mlp"])) != expect \
                    or (report and cfg.family == "moe"
                        and report["experts"] != "sharded") \
                    or (report and recurrent and report["ssm"] != (
                        "replicated" if parallel == "exact"
                        else "sharded")):
                raise SystemExit(f"FAIL tp ({label}): plan {report}")
            got = [r.output_tokens for r in reqs]
            if not graphs:
                hold_eager(f"({label}) serve[{mode}]", got, launches,
                           streams[label, mode], graph_launches[mode])
                del engine
                torch.cuda.empty_cache()
                continue
            streams[label, mode] = got
            graph_launches[mode] = launches
            if label == "b" and got != streams["a", mode]:
                raise SystemExit(f"FAIL tp (b): exact tp=2 is not "
                                 f"token-identical to no mesh ({mode})")
            if label in ("b", "c", "d"):
                st = assert_tokens_close(got, streams["a", "fused"],
                                         min_match_rate=0.0)
                print(f"    streams vs (a): match rate {st['rate']:.4f} "
                      f"({st['matched']}/{st['compared']}, "
                      f"{st['divergences']} streams diverged)")
            if mode == "orchestrated":
                same = sum(a == b for a, b in zip(got,
                                                  streams[label, "fused"]))
                held = label in same_streams
                print(f"    fused vs orchestrated: {same}/{len(got)} streams "
                      f"identical ({'held' if held else 'printed'})")
                if held and got != streams[label, "fused"]:
                    raise SystemExit(f"FAIL tp ({label}): the fused and "
                                     "orchestrated streams part")
                if not held and engine.plan.attn_splits > 1:
                    lse_stripe_check(dev, engine.tp)
            if label in ("c", "d") and mode == "fused":
                # a recurrent plan's step drifts with depth as a one-ulp
                # nudge does (PERF.md, Queue C): printed at full depth,
                # held at STEP_CUT_LAYERS
                tp_step_check(cfg, params, engine.plan, engine.params, dev,
                              hold=not recurrent)
                if recurrent:
                    ccfg = cfg.with_overrides(n_layers=STEP_CUT_LAYERS)
                    cmodel = build_model(ccfg)
                    cut = cmodel.init(
                        torch.Generator(device=dev).manual_seed(0))
                    cplan = ShardingPlan.build(cmodel, mesh,
                                               parallel=parallel)
                    tp_step_check(ccfg, cut, cplan, cplan.place_params(cut),
                                  dev)
                    del cut
            for k, n in launches.items():
                total[k] += n
            del engine
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total


# -------------------------------------------------------------- phase 4c

class FrontEngine(ServingEngine):
    """The engine, counting the preemptions and swap outs of requests
    that hold adopted blocks as they happen (``adopted``)."""

    def __post_init__(self):
        super().__post_init__()
        self.adopted = {"preempts": 0, "swaps": 0}

    def _preempt(self, r):
        held = self.kv.holds(r.request_id) \
            and self.kv.adopted_blocks_of(r.request_id) > 0
        before = self.metrics.swap_outs
        super()._preempt(r)
        if held:
            self.adopted["preempts"] += 1
            self.adopted["swaps"] += self.metrics.swap_outs - before


def front_engine(cfg, params, dev, *, sharing, step_mode, graphs=True,
                 clock=None):
    """The front door's engine: SageSched with the CUDA Gittins backend,
    FRONT_ENGINE's shape, decode steps as CUDA graphs unless ``graphs``
    is false."""
    kw = {} if clock is None else {"clock": clock}
    return FrontEngine(
        model=build_model(cfg),
        scheduler=Scheduler(policy=make_policy("sagesched"),
                            priority_backend=CudaPriorityBackend(dev),
                            bucket_size=50),
        params=params, step_mode=step_mode, seed=0, device=dev,
        graphs=graphs, prefix_sharing=sharing, **FRONT_ENGINE, **kw)


def hold_front_launches(label, cfg, engine, launches) -> None:
    """A single-card drive's launches: one paged decode a layer per decode
    call, one flash a layer per prefill chunk, and the Gittins kernel."""
    m = engine.metrics
    want = tp_launches(cfg, engine, {"decode_iterations":
                                     m.decode_iterations,
                                     "prefill_chunks": m.prefill_chunks})
    if {k: launches[k] for k in want} != want \
            or launches[GITTINS_KERNEL.symbol] == 0:
        raise SystemExit(f"FAIL {label}: launches {launches}, the path "
                         f"calls {want} and Gittins")


def session_drive(cfg, params, dev, *, sharing, step_mode,
                  sessions=SESSIONS):
    """``sessions`` (tenants, sessions a tenant, turns) through the Gateway:
    per tenant a system prompt of FRONT_SYSTEM tokens, sessions[1]
    sessions of sessions[2] turns, each
    turn wave offered with ``offer_batch`` and drained; turn 1 is the
    system prompt and 64-192 user tokens, turn t + 1 turn t's prompt,
    its output and 32-128 new user tokens; 48-96 new tokens a turn,
    greedy.  Returns (engine, requests, host seconds)."""
    engine = front_engine(cfg, params, dev, sharing=sharing,
                          step_mode=step_mode)
    gw = Gateway(engine, GatewayConfig())
    tenants, n_sessions, turns = sessions
    rng = np.random.default_rng(SESSION_SEED)
    systems = [[int(t) for t in rng.integers(3, cfg.vocab_size,
                                             FRONT_SYSTEM)]
               for _ in range(tenants)]
    prompts = {(t, s): systems[t] + [int(x) for x in rng.integers(
        3, cfg.vocab_size, int(rng.integers(64, 193)))]
        for t in range(tenants) for s in range(n_sessions)}
    reqs = []
    t0 = time.perf_counter()
    for turn in range(turns):
        wave = {key: ServeRequest(
            f"t{key[0]}s{key[1]}u{turn}",
            f"tenant {key[0]} assistant turn {turn}", list(p),
            max_new_tokens=int(rng.integers(48, 97)), temperature=0.0,
            eos_token=-1, tenant=f"tenant{key[0]}",
            session_id=f"t{key[0]}s{key[1]}") for key, p in prompts.items()}
        verdicts = gw.offer_batch(list(wave.values()))
        if any(v.value != "accept" for v in verdicts):
            raise SystemExit(f"FAIL sessions: verdicts {verdicts}")
        gw.run_until_drained()
        gw.assert_all_terminal()
        gw.check_invariants()
        assert_engine_quiesced(engine)
        for key, r in wave.items():
            if r.state != RequestState.FINISHED:
                raise SystemExit(f"FAIL sessions: {r.request_id} "
                                 f"{r.state.name} ({r.finish_reason})")
            prompts[key] = r.prompt_tokens + r.output_tokens + [
                int(x) for x in rng.integers(3, cfg.vocab_size,
                                             int(rng.integers(32, 129)))]
        reqs += list(wave.values())
    torch.cuda.synchronize()
    return engine, reqs, time.perf_counter() - t0


def phase_front_sessions(cfg, params, dev, sessions=SESSIONS,
                         step_modes=("fused", "orchestrated"),
                         sharers=True) -> dict:
    """(i): session traffic with prefix sharing ON and OFF, in each of
    ``step_modes``.  Holds ON == OFF token for token in each step mode,
    fused == orchestrated, reuse > 0 with fewer prefill tokens computed
    ON, with ``sharers`` a preemption and a swap out of a request holding
    adopted blocks in each ON drive, the Gateway's and the engine's
    invariants after every wave, the fused keys within their bound, and
    every kernel's launches exactly as the path calls them.  Returns the
    launches."""
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL)
    total = {k.symbol: 0 for k in kernels}
    streams, metrics = {}, {}
    for step_mode in step_modes:
        for sharing in (True, False):
            label = f"{step_mode}, sharing {'ON' if sharing else 'OFF'}"
            for kern in kernels:
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            engine, reqs, secs = session_drive(
                cfg, params, dev, sharing=sharing, step_mode=step_mode,
                sessions=sessions)
            counts = engine.adopted
            launches = {k.symbol: k.launches for k in kernels}
            m = engine.metrics
            gen_tokens = sum(r.generated for r in reqs)
            ttft = np.array([r.ttft for r in reqs])
            ttlt = np.array([r.ttlt for r in reqs])
            print(f"  sessions[{label}] {cfg.name} "
                  f"{torch.cuda.get_device_name(0)}: "
                  f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens "
                  f"in {secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT "
                  f"p50 {np.median(ttft):.4f} s, TTLT p50 "
                  f"{np.median(ttlt):.4f} s, prefill tokens computed "
                  f"{m.prefill_tokens} reused {m.prefill_tokens_reused}, "
                  f"prefill chunks {m.prefill_chunks}, preemptions "
                  f"{m.preemptions} ({counts['preempts']} holding "
                  f"adopted blocks), swap outs {m.swap_outs} "
                  f"({counts['swaps']} holding adopted blocks), "
                  f"swap ins {m.swap_ins}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                  f"launches {launches}")
            print(f"    {graph_report(engine)}")
            if engine.fused_compile_count > engine.max_fused_compiles():
                raise SystemExit(f"FAIL sessions[{label}]: fused keys "
                                 f"{engine.fused_compile_count} exceed "
                                 f"{engine.max_fused_compiles()}")
            hold_front_launches(f"sessions[{label}]", cfg, engine, launches)
            if sharers and sharing and (m.preemptions == 0
                                        or counts["swaps"] == 0):
                raise SystemExit(f"FAIL sessions[{label}]: no preemption or "
                                 "no swap out of a request holding adopted "
                                 f"blocks ({m.preemptions}, {counts})")
            streams[label] = [r.output_tokens for r in reqs]
            metrics[label] = m
            for k, n in launches.items():
                total[k] += n
            del engine
            torch.cuda.empty_cache()
        on, off = (f"{step_mode}, sharing ON", f"{step_mode}, sharing OFF")
        same = sum(a == b for a, b in zip(streams[on], streams[off]))
        print(f"    {step_mode}: sharing ON vs OFF {same}/{len(streams[on])} "
              f"streams identical (held); prefill tokens computed "
              f"{metrics[on].prefill_tokens} against "
              f"{metrics[off].prefill_tokens}, reused "
              f"{metrics[on].prefill_tokens_reused}")
        if streams[on] != streams[off]:
            raise SystemExit(f"FAIL sessions[{step_mode}]: sharing ON parts "
                             "from OFF")
        if not (metrics[on].prefill_tokens_reused > 0
                and metrics[on].prefill_tokens < metrics[off].prefill_tokens):
            raise SystemExit(f"FAIL sessions[{step_mode}]: sharing skipped "
                             "no prefill work")
    if len(step_modes) > 1:
        fused, orch = streams["fused, sharing ON"], \
            streams["orchestrated, sharing ON"]
        same = sum(a == b for a, b in zip(fused, orch))
        print(f"    fused vs orchestrated: {same}/{len(fused)} streams "
              "identical (held)")
        if fused != orch:
            raise SystemExit("FAIL sessions: fused and orchestrated part")
    return total


def overload_drive(cfg, params, dev, *, graphs):
    """OVERLOAD[0] requests from 4 tenants offered at once to a Gateway
    of max_inflight 8, max_queue_per_tenant 4, max_total_queue 16,
    cost shedding, 2 retries, and a TTLT deadline of OVERLOAD[1] s on a
    virtual clock that advances 0.05 s a Gateway step; the prompts share
    a 256-token system prompt per tenant.  Returns (engine, gateway,
    requests)."""
    clock = VirtualClock()
    engine = front_engine(cfg, params, dev, sharing=True,
                          step_mode="fused", graphs=graphs, clock=clock)
    gw = Gateway(engine, GatewayConfig(
        max_inflight=8, max_queue_per_tenant=4, max_total_queue=16,
        shed_policy="cost", max_retries=2, ttlt_deadline_s=OVERLOAD[1]))
    rng = np.random.default_rng(33)
    systems = [[int(t) for t in rng.integers(3, cfg.vocab_size, 256)]
               for _ in range(4)]
    reqs = []
    for i in range(OVERLOAD[0]):
        t = i % 4
        reqs.append(ServeRequest(
            f"o{i}", f"tenant {t} request {i % 7}",
            systems[t] + [int(x) for x in rng.integers(
                3, cfg.vocab_size, int(rng.integers(32, 257)))],
            max_new_tokens=int(rng.integers(32, 97)), temperature=0.0,
            eos_token=-1, tenant=f"tenant{t}"))
    gw.offer_batch(reqs)
    gw.run_until_drained(step_dt=0.05)
    torch.cuda.synchronize()
    return engine, gw, reqs


def phase_front_overload(cfg, params, dev) -> dict:
    """(ii): the overload drive graphed and with graphs=False.  Holds
    every request terminal with a reason, at least one SHED and one TTLT
    abort of a request that was streaming, the Gateway's and the engine's
    invariants, the graphed drive's launches as its path calls them, and
    dispositions and streams identical between the two drives.  Returns
    the graphed drive's launches."""
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL)
    out = {}
    for graphs in (True, False):
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        engine, gw, reqs = overload_drive(cfg, params, dev, graphs=graphs)
        secs = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        label = f"overload[{'graphs' if graphs else 'eager'}]"
        gw.assert_all_terminal()
        gw.check_invariants()
        assert_engine_quiesced(engine)
        reasons = {}
        for kind, reason in gw.dispositions.values():
            if not reason:
                raise SystemExit(f"FAIL {label}: a disposition without a "
                                 "reason")
            reasons[f"{kind}:{reason}"] = reasons.get(f"{kind}:{reason}",
                                                      0) + 1
        aborted_running = [r for r in reqs
                           if r.state == RequestState.ABORTED
                           and r.finish_reason == "ttlt_deadline"
                           and r.generated > 0]
        print(f"  {label} {torch.cuda.get_device_name(0)}: {len(reqs)} "
              f"offered, dispositions {dict(sorted(reasons.items()))}, "
              f"{len(aborted_running)} aborted while streaming, retries "
              f"{engine.metrics.retries}, virtual clock "
              f"{engine.clock():.2f} s, {secs:.3f} host s, launches "
              f"{launches}")
        print(f"    {graph_report(engine)}")
        if not any(k.startswith("SHED") for k in reasons) \
                or not aborted_running:
            raise SystemExit(f"FAIL {label}: no SHED or no deadline abort "
                             "of a running request")
        if graphs:
            hold_front_launches(label, cfg, engine, launches)
            total = launches
        out[graphs] = (dict(gw.dispositions),
                       [r.output_tokens for r in reqs])
        del engine, gw
        torch.cuda.empty_cache()
    same = out[True] == out[False]
    print(f"    graphs vs eager: dispositions and streams "
          f"{'identical' if same else 'DIFFERENT'} (held)")
    if not same:
        raise SystemExit("FAIL overload: the graphed drive parts from the "
                         "eager one")
    return total


def phase_front_door(dev) -> dict:
    """Phase 4c: llama3.2-1b at full width (seed 0) behind the Gateway
    with prefix sharing.  Returns the summed launches of (i) and of
    (ii)'s graphed drive."""
    cfg = get_config(FRONT_ARCH)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    total = phase_front_sessions(cfg, params, dev)
    for k, n in phase_front_overload(cfg, params, dev).items():
        total[k] += n
    del params
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------- phase 5

def generate_launches(cfg, steps: int) -> dict:
    """The kernel launches the dense-cache path makes: per step, one dense
    decode per attention layer (the hybrid's G group layers) and, for the
    encoder-decoder, one flash cross-attention per decoder layer through
    the key split; in the prefill, flash for each attention layer's
    self-attention (plus the encoder's layers and the cross-attention of
    the encoder-decoder), and one SSD scan per Mamba2 layer."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "encdec": cfg.n_layers, "ssm": 0,
            "hybrid": -(-cfg.n_layers // cfg.hybrid_attn_every)}[cfg.family]
    flash, split = attn, 0
    if cfg.family == "encdec":
        # the prefill's encoder and cross-attention layers; each step's
        # cross-attention (one query over the frames) takes the key split
        flash += cfg.n_encoder_layers + cfg.n_layers
        split = steps * cfg.n_layers
    return {DENSE_DECODE_KERNEL.symbol: steps * attn,
            FLASH_PREFILL_KERNEL.symbol: flash,
            FLASH_SPLIT_KERNEL.symbol: split,
            SSD_SCAN_KERNEL.symbol: cfg.n_layers
            if cfg.family in ("ssm", "hybrid") else 0}


def phase_generate(cfg, dev, *, b: int, prompt: int, max_len: int,
                   steps: int, logit_ulps: int | None,
                   n_frames: int = 0, params=None) -> dict:
    """Drive Model.prefill -> Model.decode_step at full width from random
    weights of a seeded generator on the card (or the given ``params``,
    another drive's); returns the launches of the drive's kernels.  The
    teacher-forced comparison is held at ``logit_ulps`` bf16 steps, or
    printed but not held where it is None."""
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg)
    if params is None:
        params = model.init(gen)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, prompt),
                                     generator=gen, device=dev)}
    encdec = cfg.family == "encdec"
    if encdec:
        batch["frames"] = (torch.randn(b, n_frames, cfg.d_model,
                                       generator=gen, device=dev)
                           * 0.02).bfloat16()
        enc_ms = cuda_ms(lambda: encode(params, cfg, batch["frames"]),
                         iters=1, warmup=1)
    kernels = (DENSE_DECODE_KERNEL, FLASH_PREFILL_KERNEL, FLASH_SPLIT_KERNEL,
               SSD_SCAN_KERNEL)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    run = greedy_generate(model, params, batch, max_len, steps)
    launches = {k.symbol: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not run["finite"]:
        raise SystemExit(f"FAIL generate {cfg.name}: non-finite logits")
    want = generate_launches(cfg, steps)
    if launches != want:
        raise SystemExit(f"FAIL generate {cfg.name}: launches {launches}, "
                         f"the path calls {want}")
    held = logit_ulps is not None
    bars = dict(logit_ulps=logit_ulps) if held else \
        dict(logit_ulps=math.inf, flip_ulps=math.inf)
    stats = teacher_forced_check(model, params, batch, run,
                                 f"generate {cfg.name}", **bars)
    toks = b * steps
    print(f"  generate {cfg.name} {torch.cuda.get_device_name(0)}: B {b}, "
          + (f"{n_frames} frames, encode {enc_ms:.3f} ms, " if encdec else "")
          + f"prompt {prompt}, cache {max_len}, {steps} steps: prefill "
          f"{run['prefill_s'] * 1e3:.3f} ms, decode "
          f"{run['decode_s'] * 1e3 / steps:.3f} ms per step = "
          f"{toks / run['decode_s']:.1f} tok/s, peak memory {peak:.3f} GiB, "
          f"launches {launches}; all logits finite; vs teacher-forced "
          f"forward ({'held' if held else 'printed, not held'}): max logit "
          f"diff {stats['max_logit_diff']:.4e} = "
          f"{stats['drift_ulps']:.2f} bf16 steps (bar "
          f"{stats['logit_bar']:.4e}), {stats['matched']}/"
          f"{stats['compared']} positions matched, {stats['divergences']} "
          f"divergences; argmax identical at {stats['exact']}/"
          f"{stats['positions']}, exact top-1 ties at {stats['ties']}, "
          f"{stats['coin_tosses']} flips excused, largest flip margin "
          f"{stats['flip_ulps_max']:.2f} bf16 steps")
    del params, model, run
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------------- phase 4d

def phase_moe(dev) -> tuple[dict, tuple]:
    """olmoe-1b-7b at full width and depth on one set of weights (seed 0):
    phase 4d's serve drives (phase_serve: fused and orchestrated, graphed,
    and the fused drive again eagerly), phase 4b's exact and efficient tp
    2 drives held to 4d's fused streams, phase 4c's shorter session drive
    with sharing ON and OFF, and phase 5's generate drive with a capacity
    that drops nothing; then MOE_WIDE's fused drives, each with its eager
    twin.  Returns (the summed launches, the largest Gittins shape)."""
    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for sym, n in launches.items():
            total[sym] = total.get(sym, 0) + n

    cfg = get_config(MOE_ARCH)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    print(f"phase 4d: serving {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_experts} experts "
          f"of {cfg.moe_d_ff}, top {cfg.experts_per_token}, H{cfg.n_heads}/"
          f"KV{cfg.n_kv_heads}, vocab {cfg.vocab_size}; "
          f"{param_bytes(params) / 1e9:.3f} GB of weights)")
    got, shape, streams = phase_serve(cfg, dev, params=params)
    add(got)
    print(f"phase 4b: serving {cfg.name} tensor-parallel with its experts "
          f"sharded, every shard on {torch.cuda.get_device_name(0)}; (a) is "
          f"phase 4d's fused drive")
    add(phase_serve_tp(dev, MOE_ARCH, MOE_TP_DRIVES, params=params,
                       known={("a", "fused"): streams["fused, graphs"]},
                       eager_held=(), same_streams=()))
    print(f"phase 4c: {cfg.name} behind the Gateway with prefix sharing, "
          f"session traffic of {MOE_SESSIONS} (tenants, sessions, turns), "
          f"fused")
    add(phase_front_sessions(cfg, params, dev, sessions=MOE_SESSIONS,
                             step_modes=("fused",), sharers=False))
    gcfg = cfg.with_overrides(capacity_factor=float(cfg.n_experts))
    print(f"phase 5: generating with {cfg.name} at full width and depth "
          f"through Model.prefill -> Model.decode_step (capacity_factor "
          f"{gcfg.capacity_factor:g}: nothing drops)")
    add(phase_generate(gcfg, dev, params=params, **MOE_GENERATE))
    del params
    torch.cuda.empty_cache()
    for arch, cut in MOE_WIDE:
        wcfg = get_config(arch).with_overrides(**cut)
        print(f"phase 4d: serving {wcfg.name} at full width cut to "
              f"{wcfg.n_layers} layers (d {wcfg.d_model}, H{wcfg.n_heads}/"
              f"KV{wcfg.n_kv_heads}, dh {wcfg.head_dim}, vocab "
              f"{wcfg.vocab_size}), fused, graphed and eager")
        params = build_model(wcfg).init(
            torch.Generator(device=dev).manual_seed(0))
        add(phase_serve_wide(wcfg, params, dev, eager=True))
        del params
        torch.cuda.empty_cache()
    print(f"  phase 4d with olmoe's 4b, 4c and 5 took "
          f"{time.perf_counter() - t0:.1f} s")
    return total, shape


def param_bytes(node) -> int:
    """Bytes of a nested parameter dict."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(node))


# --------------------------------------------------------------- phase 6

class ParentOpBackend(CudaPriorityBackend):
    """The Gittins backend path the staged refresh replaced:
    ``gittins_attained_op`` (the rows padded into new numpy arrays, three
    pageable copies) and a blocking ``.cpu()`` on the current stream."""

    def gittins(self, support, probs, attained):
        out = gittins_attained_op(support, probs, attained,
                                  device=self.device)
        return out.cpu().numpy().astype(np.float64)


def gittins_case(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    sup = np.sort(rng.uniform(1, 1e5, (n, k)), axis=1)
    probs = rng.dirichlet(np.ones(k), n)
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)
    return sup, probs, att


def gittins_bound(n: int, k: int):
    """(bound ms, by) of one (n, k) refresh: support, probs and attained
    read once, the index written once; ~15 f32 operations a column."""
    return bound_ms((2 * n * k + 2 * n) * 4, 15.0 * n * k, F32_FLOPS)


def host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host-clock ms of one call of ``fn`` (which returns to the host)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def refresh_backlog_ms(backend, depth: int = 1024, reps: int = 20,
                       seed: int = 0) -> tuple[float, tuple]:
    """Host-clock ms of ``Scheduler.refresh()`` (sagesched) over a
    ``depth``-deep backlog made from ``seed``, every row dirty: 200
    completed requests give the predictor a history, then ``depth``
    arrivals; before each refresh every live request crosses its next
    bucket boundary.  Returns (ms, (rows, k))."""
    rng = np.random.default_rng(seed)
    topics = ("summarize the quarterly report", "write a short story about",
              "explain this python code", "translate the phrase into french",
              "list the steps to bake bread")
    sched = Scheduler(policy="sagesched", priority_backend=backend,
                      bucket_size=50)
    for i in range(200):
        sched.admit(f"h{i}", f"{topics[i % 5]} {i % 7}",
                    int(rng.integers(16, 2048)), arrival=0.0)
        sched.on_complete(f"h{i}", int(rng.integers(16, 1024)))
    ids = [f"r{i}" for i in range(depth)]
    sched.admit_batch(ids, [f"{topics[i % 5]} {i % 7}" for i in range(depth)],
                      [int(x) for x in rng.integers(16, 2048, depth)],
                      arrivals=[0.0] * depth)
    shape = (sched._state.n, sched._state.k)
    generated = np.zeros(depth, np.int64)
    total = 0.0
    for _ in range(reps):
        generated += 50
        sched.on_progress_many(ids, generated.tolist())
        t0 = time.perf_counter()
        rows = sched.refresh()
        total += time.perf_counter() - t0
        if rows != depth:
            raise SystemExit(f"FAIL refresh: {rows} of {depth} rows dirty")
    return total / reps * 1e3, shape


def phase_gittins(dev, shape) -> dict:
    """The kernel against its plain version at every refresh shape (a row
    alone bit-identical to the same row in its batch), the staged refresh
    against the kernel on the same padded inputs, device times of the
    kernel and of the parent's (tools/gittins_variants/warp_row.cu) in
    turns, host times of the staged refresh and of the parent's op path,
    its copies under torch.profiler, and Scheduler.refresh() over a
    1024-deep backlog under the numpy, staged and parent backends."""
    err = 0.0
    n_main, k_main = pow2_bucket(shape[0], 8), pow2_bucket(shape[1], 8)
    parent = PARENT_GITTINS.get("run")
    shapes = ((n_main, k_main),) + tuple(
        s for s in GITTINS_SHAPES if s != (n_main, k_main))
    for n, k in shapes + ((1000, 256), (100, 12)):
        sup, probs, att = gittins_case(n, k, seed=n + k)
        s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                   for x in (sup, probs, att))
        got = gittins_attained(s, p, a)
        want = gittins_attained_reference(s, p, a)
        torch.cuda.synchronize()
        c = check(f"gittins (n={n}, k={k})", got, want, GITTINS_RTOL,
                  rel=True)
        err = max(err, c)
        if parent:
            check(f"gittins (n={n}, k={k}), the parent's kernel",
                  parent(s, p, a), want, GITTINS_RTOL, rel=True)
        rows = sorted({0, 1, n // 2, n - 1})
        alone = torch.cat([gittins_attained(s[r:r + 1], p[r:r + 1],
                                            a[r:r + 1]) for r in rows])
        if not torch.equal(alone, got[rows]):
            raise SystemExit(f"FAIL gittins (n={n}, k={k}): a row alone "
                             f"differs from the same row in its batch")
        staged = CudaPriorityBackend(dev).gittins(sup, probs, att)
        direct = gittins_attained(*(torch.from_numpy(x).to(dev) for x in
                                    padded_rows(sup, probs, att)))[:n]
        if not np.array_equal(staged, direct.cpu().numpy().astype(np.float64)):
            raise SystemExit(f"FAIL gittins (n={n}, k={k}): the staged "
                             f"refresh differs from the kernel on the same "
                             f"padded inputs")
    print("  gittins: a row alone == the row in its batch, staged refresh "
          "== kernel on the same padded inputs, bit for bit, at every shape")

    instances = {}
    for n, k in shapes:
        copies = GITTINS_COLD if (n, k) == GITTINS_SHAPES[-1] else 1
        sets = [[torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                 for x in gittins_case(n, k, seed=i)] for i in range(copies)]
        bnd, by = gittins_bound(n, k)
        fns = {"kernel": gittins_attained}
        if parent:
            fns["parent"] = parent
        for label, used in (("warm", sets[:1]), ("cold", sets)):
            if label == "cold" and copies == 1:
                continue
            times = {name: [] for name in fns}
            for name in list(fns) + list(reversed(fns)):
                cyc, fn = itertools.cycle(used), fns[name]
                times[name].append(device_ms(lambda: fn(*next(cyc)),
                                             iters=40))
            ms = min(times["kernel"])
            parent_ms = min(times["parent"]) if parent else None
            print(f"  gittins kernel (n={n}, k={k}, {label} L2"
                  f"{'' if len(used) == 1 else f', {len(used)} input copies'}"
                  f"): "
                  f"{' / '.join(f'{t:.5f}' for t in times['kernel'])} ms, "
                  f"parent's kernel "
                  + (' / '.join(f'{t:.5f}' for t in times['parent'])
                     + ' ms' if parent else 'not built')
                  + f", bound {bnd:.4e} ms ({by}), {bnd / ms:.1%} of it")
            instances[f"n={n} k={k} {label}"] = {
                "ms": ms, "parent_ms": parent_ms, "bound_ms": bnd,
                "bound_by": by}
    cold = instances.get(f"n={GITTINS_SHAPES[-1][0]} "
                         f"k={GITTINS_SHAPES[-1][1]} cold")
    if cold and cold["ms"] > 2 * cold["bound_ms"]:
        print(f"  gittins: NOT MET: under half the byte bound at "
              f"{GITTINS_SHAPES[-1]} ({cold['ms']:.5f} > "
              f"{2 * cold['bound_ms']:.5f} ms)")
    s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
               for x in gittins_case(n_main, k_main, seed=1))
    plain_ms = cuda_ms(lambda: gittins_attained_reference(s, p, a), iters=20)

    # the op, numpy in to numpy out, on the host clock: the staged
    # refresh and the parent's path, in turns
    staged, parent_op = CudaPriorityBackend(dev), ParentOpBackend(dev)
    op_ms = {}
    for n, k in ((8, 8), (1024, 32)):
        case = gittins_case(n, k, seed=3)
        t = {"staged": [], "parent": []}
        for name in ("staged", "parent", "parent", "staged"):
            b = staged if name == "staged" else parent_op
            t[name].append(host_ms(lambda: b.gittins(*case)))
        op_ms[f"n={n} k={k}"] = {name: min(v) for name, v in t.items()}
        staged_s, parent_s = (" / ".join(f"{x:.4f}" for x in t[name])
                              for name in ("staged", "parent"))
        print(f"  gittins op (n={n}, k={k}), numpy in to numpy out, host "
              f"clock: staged refresh {staged_s} ms, parent's op path "
              f"{parent_s} ms")
    # the staged refresh's copies as the profiler sees them: 10 calls
    # traced after 10 in a warm-up cycle (the trace's first activity can
    # go unrecorded when tracing starts cold); a trace that records no
    # copy at all is taken once more, then fails
    from torch.profiler import ProfilerActivity, profile, schedule
    case = gittins_case(1024, 32, seed=4)
    for attempt in range(2):
        copies = {"HtoD": 0, "DtoH": 0}

        def count_copies(prof):
            for ev in prof.key_averages():
                for d in copies:
                    if d in ev.key:
                        copies[d] += ev.count
                        print(f"    traced: {ev.count} x {ev.key}")

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=count_copies) as prof:
            for _ in range(2):
                n0 = GITTINS_KERNEL.launches
                for _ in range(10):
                    staged.gittins(*case)
                torch.cuda.synchronize()
                prof.step()
        print(f"  gittins staged refresh x10 under torch.profiler: {copies} "
              f"memcpy events, {GITTINS_KERNEL.launches - n0} counted "
              f"launches")
        if GITTINS_KERNEL.launches - n0 != 10:
            raise SystemExit("FAIL gittins: the staged refresh did not "
                             "count one launch a call")
        if any(copies.values()):
            break
    if copies != {"HtoD": 10, "DtoH": 10}:
        raise SystemExit(f"FAIL gittins: 10 staged refreshes traced {copies} "
                         f"memcpy events, not one copy each way a call")
    refresh = {}
    for name, b in (("numpy", "numpy"), ("staged", staged),
                    ("parent", parent_op)):
        refresh[name], bshape = refresh_backlog_ms(b)
    print(f"  Scheduler(sagesched).refresh() over a 1024-deep backlog "
          f"(BatchState {bshape}), every row dirty, host clock: "
          + ", ".join(f"{k} backend {v:.4f} ms" for k, v in refresh.items()))
    main = instances[f"n={n_main} k={k_main} warm"]
    return {"name": "gittins_attained", "route": "cuda",
            "source": "src/repro_torch/csrc/gittins.cu",
            "replaces": "src/repro/kernels/gittins/kernel.py:39",
            "max_abs_err": err, "ms": main["ms"], "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "instances": instances, "op_ms": op_ms,
            "refresh_ms": refresh, "staged_copies": copies}


# -------------------------------------------------------------- phase 6b

def phase_simulator(dev) -> dict:
    """The simulator's central scheduler with the Gittins kernel:
    ``measure_scheduler_overhead`` at OVERHEAD_NODES under the numpy and
    the cuda backends (predict and schedule ms side by side, host clock),
    then ``simulate_cluster`` over SIM_CLUSTER's workload under both.
    Holds every request finished under both backends and the kernel
    launched; prints each backend's mean and p99 TTFT and TTLT and how
    many requests' metrics differ (the f32 kernel is not bit-identical
    to numpy's float64).  Returns the Gittins launches."""
    GITTINS_KERNEL.launches = 0
    for n in OVERHEAD_NODES:
        o = {b: measure_scheduler_overhead(n, queue_depth=1000,
                                           history_size=10_000, backend=b)
             for b in ("numpy", "cuda")}
        print(f"  overhead {n} nodes (queue depth "
              f"{o['numpy']['queue_depth']}, {o['numpy']['aggregate_rps']} "
              f"rps, {o['numpy']['refresh_rows_per_arrival']} refresh rows "
              f"an arrival): predict ms numpy {o['numpy']['predict_ms']:.4f}"
              f" / cuda {o['cuda']['predict_ms']:.4f}, schedule ms numpy "
              f"{o['numpy']['schedule_ms']:.4f} / cuda "
              f"{o['cuda']['schedule_ms']:.4f}")
    n_nodes, n_reqs, rps = SIM_CLUSTER
    profiles = [make_profile(p) for p in ("sharegpt", "alpaca", "write")]
    reqs = generate_workload(profiles, n_reqs, rps=rps, seed=0)
    runs = {}
    for b in ("numpy", "cuda"):
        t0 = time.perf_counter()
        res = simulate_cluster(
            reqs, lambda: Scheduler(policy=make_policy("sagesched"),
                                    priority_backend=b), n_nodes)
        secs = time.perf_counter() - t0
        done = {m.request_id for m in res.metrics}
        if len(res.metrics) != n_reqs or len(done) != n_reqs:
            raise SystemExit(f"FAIL simulate_cluster[{b}]: "
                             f"{len(done)}/{n_reqs} requests finished")
        ttft = np.array([m.ttft for m in res.metrics])
        ttlt = np.array([m.ttlt for m in res.metrics])
        print(f"  simulate_cluster[{b}] {n_nodes} nodes, {n_reqs} requests "
              f"at {rps} rps: {len(done)}/{n_reqs} finished in {secs:.3f} "
              f"host s; simulated TTFT mean {ttft.mean():.4f} s p99 "
              f"{np.percentile(ttft, 99):.4f} s, TTLT mean "
              f"{ttlt.mean():.4f} s p99 {np.percentile(ttlt, 99):.4f} s, "
              f"requests a node {res.requests_per_node}")
        runs[b] = {m.request_id: (m.node_id, m.ttft, m.ttlt,
                                  m.n_preemptions) for m in res.metrics}
    differ = sum(runs["numpy"][r] != runs["cuda"][r] for r in runs["numpy"])
    print(f"    cuda vs numpy: {differ}/{n_reqs} requests' metrics differ "
          f"(printed); Gittins launches {GITTINS_KERNEL.launches}")
    if GITTINS_KERNEL.launches == 0:
        raise SystemExit("FAIL simulator: the Gittins kernel never launched")
    return {GITTINS_KERNEL.symbol: GITTINS_KERNEL.launches}


def phase_dryrun() -> None:
    """Phase 6d: the roofline figures, the serving min-tp ladders at the
    card's budget and llama3.2-1b's dry-run on meta (see the docstring)."""
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  roofline.HW {HW}; this card's total_memory {total} "
          f"({'equal to' if total == HW['hbm_bytes'] else 'NOT'} "
          f"HW['hbm_bytes'])")
    t0 = time.perf_counter()
    dryrun.print_min_tp(dryrun.min_tp_report())
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = dryrun.run_case("llama3.2-1b", shape, False)
        r, mem = rec["roofline"], rec["memory"]
        print(f"  dry-run llama3.2-1b {shape} ({rec['mode']}, "
              f"{rec['n_chips']} devices on meta): FLOPs/device "
              f"{rec['flops_per_chip']:.4e} (counted "
              f"{rec['hlo_flops_per_chip']:.4e}, model "
              f"{rec['model_flops_per_chip']:.4e}), bytes/device "
              f"{rec['bytes_per_chip']:.4e}, collective floor "
              f"{rec['collective_bytes_per_chip']:.4e}; compute "
              f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
              f"collective {r['collective_s']:.4e} s, dominant "
              f"{r['dominant']}; arguments {mem['argument_bytes'] / 2**30:.3f}"
              f" GiB, temp (upper bound) {mem['temp_bytes'] / 2**30:.3f} GiB,"
              f" pass {rec['compile_s']} s")
        if rec["flops_per_chip"] < rec["model_flops_per_chip"]:
            raise SystemExit(f"FAIL dry-run {shape}: FLOPs/device under the "
                             "model's")
    print(f"  phase 6d took {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------- phase 6c

# the backward kernel's shapes: (label, B, Sq, H, KV, dh, causal, window,
# S_past, start); S_past > 0 gathers a prefix of S_past rows before the
# Sq queries at positions start.., the prefix rows at or past start masked
# (kv position -10^9), as a chunked prefill does
BWD_CASES = (
    ("llama3.2-1b", 8, 512, 32, 8, 64, True, 0, 0, 0),
    ("qwen2-1.5b", 8, 512, 12, 2, 128, True, 0, 0, 0),
    ("nemotron-4-340b", 1, 1024, 96, 8, 192, True, 0, 0, 0),
    ("window 64", 2, 512, 32, 8, 64, True, 64, 0, 0),
    ("masked kv rows, query offset", 2, 256, 32, 8, 64, True, 0, 512, 448),
    ("bidirectional Sq 8", 8, 8, 16, 16, 64, False, 0, 512, 512),
)
# the shapes timed beside SDPA's backward (causal, no window, no prefix)
BWD_TIMED = ("llama3.2-1b", "qwen2-1.5b", "nemotron-4-340b")
TRAIN_ARCH = "llama3.2-1b"
TRAIN = dict(batch=8, seq=512, steps=20, lr=3e-3, min_drop=0.2)
# (arch, cut, steps, lr): full width, cut depth.  qwen2 at the learning
# rate of tests/test_training.py's loss and accumulation tests; its first
# also holds grad accumulation 2 against 1 on one batch at that file's
# bars.  olmoe cut to 2 of its 16 layers jumps by 3-7 nats at step 2 or 3
# at every rate tried, and the CPU's plain versions take the same path
# (tools/train_witness.py); its rate was picked after its loss rose at 3e-3
# and 1e-3, so its fall is no check of the MoE backward: grad_check is.
TRAIN_WIDE = (("qwen2-1.5b", dict(n_layers=2), 5, 1e-3),
              ("olmoe-1b-7b", dict(n_layers=2), 5, 3e-4))
ACCUM_LR = 1e-3
# grad_check's batch (B, S) for each config: small, as the CPU computes
# the same gradients
GRAD_BATCH = {"llama3.2-1b": (2, 512), "olmoe-1b-7b": (2, 256),
              "zamba2-1.2b": (2, 512), "mamba2-2.7b": (2, 512)}
# the recurrent families' card-vs-CPU gradients: depth cut to this (from 12
# layers on, the card's and the CPU's bf16 forwards part at random weights:
# testing/tolerance.py); at full depth ssd_plain_check holds the kernel
GRAD_CUT_LAYERS = 2
# phase 6c (e): the recurrent families at full width and depth: (arch,
# steps, B, S, lr, least fall of the loss from the first step to the last)
TRAIN_RECURRENT = (("zamba2-1.2b", 20, 8, 1024, 3e-3, 0.2),
                   ("mamba2-2.7b", 5, 8, 1024, 3e-3, 0.0))
CKPT_PATH = Path(__file__).resolve().parent / "build" / "train_ckpt.npz"


def bwd_case(spec, dev, gen, q_scale=1.0):
    """q, k, v, dout, positions, kv positions of one BWD_CASES entry."""
    _, b, sq, h, kvh, dh, causal, window, s_past, start = spec
    sk = s_past + sq if s_past else sq
    q = (torch.randn(b, sq, h, dh, generator=gen, device=dev)
         * q_scale).bfloat16()
    k = torch.randn(b, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    dout = torch.randn(b, sq, h, dh, generator=gen, device=dev).bfloat16()
    pos = (start + torch.arange(sq, device=dev)).to(torch.int32)
    kv_pos = pos
    if s_past:
        past = torch.arange(s_past, device=dev)
        kv_pos = torch.cat([torch.where(past < start, past,
                                        torch.full_like(past, -10 ** 9)),
                            pos.long()]).to(torch.int32)
        if not causal:     # a bidirectional call sees every valid key
            kv_pos = torch.where(kv_pos >= 0, kv_pos,
                                 torch.full_like(kv_pos, -1))
    return q, k, v, dout, pos, kv_pos


def visible_mask(pos, kv_pos, causal, window):
    """(Sq, Sk) bool: key j visible to query i, the kernels' rule."""
    qp, kp = pos.long()[:, None], kv_pos.long()[None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def bwd_bytes_flops(q, k, pos, kv_pos, causal, window):
    """Bytes the backward must move (q, k, v, out, dout, lse, positions
    read; dq, dk, dv written) and the operations this data needs: five
    products of 2 dh a visible (query, key) pair a head."""
    mask = visible_mask(pos, kv_pos, causal, window)
    b, sq, h, dh = q.shape
    n_bytes = (4 * q.numel() + 4 * k.numel()) * 2 + b * h * sq * 4 \
        + (pos.numel() + kv_pos.numel()) * 4
    return n_bytes, 10.0 * float(mask.sum()) * b * h * dh


def sdpa_backward_ms(q, k, v, dout, causal, mask=None
                     ) -> tuple[float, float]:
    """SDPA's backward (enable_gqa; is_causal, or with ``mask`` an explicit
    boolean (Sq, Sk) attn_mask) on the same inputs: device ms of its
    forward and backward minus its forward (an autograd backward runs on
    its forward's stream, so the two are captured together)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()

    def fwd():
        if mask is not None:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        f_ms = device_ms(fwd)
    fb_ms = device_ms(both)
    return fb_ms - f_ms, fb_ms


def phase_train_kernels(dev, gen) -> dict:
    """Phase 6c (a): the flash backward kernel against its plain version
    at BWD_CASES, flat and peaked, on the training forward's own O and LSE;
    the LSE instance's O bit-identical to the serving instance's (where the
    serving op takes the prefill kernel) and its LSE within LSE_TOL of the
    plain version's; two backward calls bit-identical; the flat draw timed
    in turns with the parent's kernel, beside SDPA's backward and the
    bound.  Returns the kernel's row (each shape's times under
    "instances")."""
    row = {"name": "flash_attention_backward", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:73 "
                       "(the backward of its function, which the reference "
                       "takes by XLA autodiff of "
                       "src/repro/models/attention.py:59 gqa_attention: no "
                       "Pallas backward)",
           "max_abs_err": 0.0, "instances": {}}
    for spec in BWD_CASES:
        label, b, sq, h, kvh, dh, causal, window, s_past, start = spec
        shape = (f"B {b}, Sq {sq}, H{h}/KV{kvh}, dh {dh}"
                 f"{', causal' if causal else ', bidirectional'}"
                 f"{f', window {window}' if window else ''}"
                 f"{f', S_past {s_past}, start {start}' if s_past else ''}")
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, k, v, dout, pos, kv_pos = bwd_case(spec, dev, gen, q_scale)
            kw = dict(causal=causal, window=window)
            out, lse = flash_attention_lse(q, k, v, pos, kv_pos, **kw)
            _, want_lse = attention_reference(q, k, v, pos, kv_pos,
                                              return_lse=True, **kw)
            if not flash_key_ranges(sq, kv_pos.numel(), **kw):
                serving = flash_attention(q, k, v, pos, kv_pos, **kw)
                if not torch.equal(out, serving):
                    raise SystemExit(f"FAIL flash LSE instance {label}: O "
                                     f"differs from the serving instance's")
            check(f"flash LSE instance {label} {draw} lse ({shape})", lse,
                  want_lse, LSE_TOL)
            got = flash_attention_backward(q, k, v, pos, kv_pos, out, lse,
                                           dout, **kw)
            again = flash_attention_backward(q, k, v, pos, kv_pos, out, lse,
                                             dout, **kw)
            want = attention_backward_reference(q, k, v, pos, kv_pos, out,
                                                lse, dout, **kw)
            torch.cuda.synchronize()
            for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(g, a):
                    raise SystemExit(f"FAIL flash backward {label} {draw}: "
                                     f"{name} differs between two calls")
                row["max_abs_err"] = max(row["max_abs_err"], attn_check(
                    f"flash backward {label} {draw} {name} ({shape})", g, w))
            if draw == "flat":
                fns = {"kernel": lambda: flash_attention_backward(
                    q, k, v, pos, kv_pos, out, lse, dout, **kw)}
                parent = PARENT_FLASH_BWD.get("backward")
                if parent:
                    fns["parent"] = lambda: parent(q, k, v, pos, kv_pos, out,
                                                   lse, dout, **kw)
                times = in_turns(fns)
                ms = times["kernel"]
                bnd, by = bound_ms(*bwd_bytes_flops(q, k, pos, kv_pos,
                                                    causal, window),
                                   HW["peak_flops"])
                text = (f"  flash backward {label}: kernel {ms:.4f} ms "
                        f"(deterministic), {versus_parent(times)}, bound "
                        f"{bnd:.5f} ms ({by})")
                # the timed shapes' masks are causal alone; the others as
                # an explicit boolean mask of the same positions
                mask = None if label in BWD_TIMED else visible_mask(
                    pos, kv_pos, causal, window)
                lib, lib_fb = sdpa_backward_ms(q, k, v, dout, causal, mask)
                text += (f", SDPA backward {lib:.4f} ms (forward + "
                         f"backward {lib_fb:.4f}"
                         f"{', boolean mask' if mask is not None else ''})")
                if label in BWD_TIMED:
                    fwd_ms = device_ms(lambda: flash_attention_lse(
                        q, k, v, pos, kv_pos, **kw))
                    text += f"; the LSE forward {fwd_ms:.4f} ms"
                row["instances"][label] = {
                    "ms": ms, "parent_ms": times.get("parent"),
                    "bound_ms": bnd, "bound_by": by, "library_ms": lib}
                if label == BWD_TIMED[0]:
                    row["plain_ms"] = cuda_ms(
                        lambda: attention_backward_reference(
                            q, k, v, pos, kv_pos, out, lse, dout, **kw),
                        iters=3)
                    text += f", plain {row['plain_ms']:.4f} ms"
                    row.update(ms=ms, bound_ms=bnd, bound_by=by,
                               library_ms=lib)
                print(text)
            del q, k, v, dout, out, lse, got, again, want
    torch.cuda.empty_cache()
    return row


# the SSD backward kernel's shapes: (label, arch, B, S, initial state,
# final-state gradient); (P, N, H, chunk) are the arch's.  S 777 is not a
# multiple of the chunk (the op pads it)
SSD_BWD_CASES = (
    ("mamba2-2.7b", "mamba2-2.7b", 2, 1024, True, True),
    ("mamba2-2.7b, no state", "mamba2-2.7b", 2, 1024, False, False),
    ("zamba2-1.2b", "zamba2-1.2b", 2, 1024, True, True),
    ("zamba2-1.2b, S 777", "zamba2-1.2b", 1, 777, False, True),
)
# the training shapes the backward is timed at too (B 8 x S 1024)
SSD_BWD_TIMED = ("mamba2-2.7b", "zamba2-1.2b")


def ssd_bwd_bytes_flops(x, bm, init: bool, dstate: bool, q: int):
    """Bytes the SSD backward must move (x, dt, a, B, C, dy and the states
    read; dx, ddt, da, dB, dC and d init written) and the operations of
    its chunked form on this data: per chunk C B^T over the causal pairs
    and dG's products with B and C (dG summed over the heads first); per
    head dW and W dy over the pairs, and six products of 2 P N a row (the
    chunk's own state and state gradient, S C_i, S^T dy_i, dS_out B_j,
    dS_out^T xdt_j)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    s_pad = -(-s // q) * q
    n_bytes = 3 * x.numel() * 2 + 4 * b * s * h * 4 + 4 * bm.numel() * 2 \
        + (2 * int(init) + int(dstate)) * b * h * p * n * 4
    pairs = (s_pad // q) * q * (q + 1) / 2
    flops = b * (pairs * (6 * n + h) + h * (pairs * 4 * p
                                              + 6 * s_pad * 2 * p * n))
    return n_bytes, flops


def ssd_backward_calls(x, dt, a, bm, cm, st, dy, ds, chunk) -> dict:
    """The SSD backward kernel's call and, where it was built, the
    parent's (tools/ssd_variants/bwd_scalar.cu) on the same inputs."""
    fns = {"kernel": lambda: ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds,
                                               chunk=chunk)}
    parent = PARENT_SSD.get("backward")
    if parent:
        fns["parent"] = lambda: parent(x, dt, a, bm, cm, st, dy, ds,
                                       chunk=chunk)
    return fns


def phase_train_ssd_kernels(dev, gen) -> dict:
    """Phase 6c (a'): the SSD backward kernel (``csrc/ssd_scan_bwd.cu``)
    against its plain version (``ssd_backward_reference``, f32) at
    SSD_BWD_CASES, on the forward's own saved tensors: the scan runs under
    autograd (``SSDScanFunction``, long memory) and its backward through
    ``torch.autograd.grad``; each gradient within BF16_TOL (``check``),
    two backward calls bit-identical; each case timed (device ms) in turns
    with the parent's kernel, beside its bound, no library call computing
    it.  Returns the kernel's row."""
    row = {"name": "ssd_scan_backward", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:64 (the "
                       "backward of its function, which the reference "
                       "takes by XLA autodiff of src/repro/models/ssm.py:82 "
                       "ssd_chunked: no Pallas backward)",
           "max_abs_err": 0.0, "library_ms": None, "instances": {}}
    names = ("dx", "ddt", "da", "dB", "dC", "dinit")
    for label, arch, b, s, init, with_ds in SSD_BWD_CASES:
        cfg = get_config(arch)
        q = cfg.ssm_chunk
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x, dt, a, bm, cm, st = ssd_case(cfg, dev, gen, s, init, (0.99, 1.0))
        if b > 1:
            more = ssd_case(cfg, dev, gen, s, init, (0.99, 1.0))
            x, dt, a, bm, cm, st = (None if u is None else torch.cat([u, v])
                                    for u, v in zip((x, dt, a, bm, cm, st),
                                                    more))
        dy = torch.randn(b, s, h, p, generator=gen, device=dev).bfloat16()
        ds = torch.randn(b, h, p, n, generator=gen, device=dev) \
            if with_ds else None
        ins = [t.requires_grad_() for t in (x, dt, a, bm, cm, st)
               if t is not None]
        n0 = SSD_BACKWARD_KERNEL.launches
        got = []
        for _ in range(2):
            y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=q)
            # without dstate the final state's gradient reaches the
            # Function as None (the kernel's null pointer)
            got.append(torch.autograd.grad((y, fin) if with_ds else y, ins,
                                           (dy, ds) if with_ds else dy))
        torch.cuda.synchronize()
        if SSD_BACKWARD_KERNEL.launches != n0 + 2:
            raise SystemExit(f"FAIL ssd backward {label}: "
                             f"{SSD_BACKWARD_KERNEL.launches - n0} launches "
                             f"for 2 backward calls")
        with torch.no_grad():
            want = [w for w in ssd_backward_reference(
                x, dt, a, bm, cm, st, dy, ds, chunk=q) if w is not None]
        shape = (f"B {b}, S {s}, H {h}, P {p}, N {n}, chunk {q}"
                 f"{', init state' if init else ''}"
                 f"{', dstate' if with_ds else ''}")
        for name, g, g2, w in zip(names, got[0], got[1], want):
            if not torch.equal(g, g2):
                raise SystemExit(f"FAIL ssd backward {label}: {name} "
                                 f"differs between two calls")
            row["max_abs_err"] = max(row["max_abs_err"], check(
                f"ssd backward {label} {name} ({shape})", g, w, BF16_TOL))
        xd, dtd, ad, bd, cd = (t.detach() for t in (x, dt, a, bm, cm))
        std = None if st is None else st.detach()
        times = in_turns(ssd_backward_calls(xd, dtd, ad, bd, cd, std, dy, ds,
                                            q))
        ms = times["kernel"]
        bnd, by = bound_ms(*ssd_bwd_bytes_flops(xd, bd, init, with_ds, q),
                           HW["peak_flops"])
        text = (f"  ssd backward {label} ({shape}): kernel {ms:.4f} ms "
                f"(deterministic), {versus_parent(times)}, bound "
                f"{bnd:.5f} ms ({by}), no library call")
        inst = {"ms": ms, "parent_ms": times.get("parent"), "bound_ms": bnd,
                "bound_by": by}
        if label == SSD_BWD_CASES[0][0]:
            row["plain_ms"] = cuda_ms(lambda: ssd_backward_reference(
                xd, dtd, ad, bd, cd, std, dy, ds, chunk=q), iters=3)
            text += f", plain {row['plain_ms']:.4f} ms"
            row.update(ms=ms, bound_ms=bnd, bound_by=by)
        row["instances"][label] = inst
        print(text)
        del x, dt, a, bm, cm, st, ins, got, want, dy, ds
    for arch in SSD_BWD_TIMED:           # the training shape, B 8 x S 1024
        cfg = get_config(arch)
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        case = [ssd_case(cfg, dev, gen, 1024, False, (0.99, 1.0))
                for _ in range(8)]
        x, dt, a, bm, cm = (torch.cat([c[i] for c in case])
                            for i in range(5))
        dy = torch.randn(8, 1024, h, p, generator=gen, device=dev).bfloat16()
        times = in_turns(ssd_backward_calls(x, dt, a, bm, cm, None, dy, None,
                                            cfg.ssm_chunk), iters=5)
        ms = times["kernel"]
        fwd = device_ms(lambda: ssd_scan(x, dt, a, bm, cm), iters=5)
        bnd, by = bound_ms(*ssd_bwd_bytes_flops(x, bm, False, False,
                                                cfg.ssm_chunk),
                           HW["peak_flops"])
        print(f"  ssd backward {arch} training shape (B 8, S 1024): kernel "
              f"{ms:.4f} ms, {versus_parent(times)}, bound {bnd:.5f} ms "
              f"({by}); the forward {fwd:.4f} ms")
        row["instances"][f"{arch} B 8 x S 1024"] = {
            "ms": ms, "parent_ms": times.get("parent"), "bound_ms": bnd,
            "bound_by": by, "forward_ms": fwd}
        del x, dt, a, bm, cm, dy, case
    torch.cuda.empty_cache()
    return row


TRAIN_KERNELS = (FLASH_PREFILL_KERNEL, FLASH_PREFILL_LSE_KERNEL,
                 FLASH_BACKWARD_KERNEL, FLASH_SPLIT_KERNEL, SSD_SCAN_KERNEL,
                 SSD_BACKWARD_KERNEL)


def reset_train_counts() -> None:
    for kern in TRAIN_KERNELS:
        kern.launches = 0


def hold_train_counts(label, cfg, microbatches: int) -> dict:
    """The kernel launches of a training drive, exact: per microbatch one
    flash LSE forward an attention application (every layer of an
    attention family, the hybrid's shared block once a group) and one SSD
    forward a Mamba2 layer, each twice under remat (the recompute), and
    one flash and one SSD backward each; no serving-instance or key-split
    launch."""
    n_attn = cfg.n_layers if cfg.family in ("dense", "vlm", "moe") else (
        -(-cfg.n_layers // cfg.hybrid_attn_every)
        if cfg.family == "hybrid" else 0)
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    again = 2 if cfg.remat else 1
    got = {"forward (LSE)": FLASH_PREFILL_LSE_KERNEL.launches,
           "backward": FLASH_BACKWARD_KERNEL.launches,
           "serving prefill": FLASH_PREFILL_KERNEL.launches,
           "key split": FLASH_SPLIT_KERNEL.launches,
           "SSD forward": SSD_SCAN_KERNEL.launches,
           "SSD backward": SSD_BACKWARD_KERNEL.launches}
    want = {"forward (LSE)": n_attn * microbatches * again,
            "backward": n_attn * microbatches, "serving prefill": 0,
            "key split": 0, "SSD forward": n_ssd * microbatches * again,
            "SSD backward": n_ssd * microbatches}
    print(f"  {label}: launches {got} (want {want})")
    if got != want:
        raise SystemExit(f"FAIL {label}: launches {got} != {want}")
    return {FLASH_PREFILL_LSE_KERNEL.symbol: want["forward (LSE)"],
            FLASH_BACKWARD_KERNEL.symbol: want["backward"],
            SSD_SCAN_KERNEL.symbol: want["SSD forward"],
            SSD_BACKWARD_KERNEL.symbol: want["SSD backward"]}


def train_batches(cfg, dev, batch, seq, seed=0):
    for b in lm_batches(cfg.vocab_size, batch, seq, seed=seed):
        yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def flop_share(cfg, batch: int, seq: int, step_s: float) -> str:
    """A training drive's model-FLOP share: ``roofline.model_flops`` (6 N
    T, N the active parameters) per second over HW["peak_flops"]."""
    mf = model_flops(cfg, InputShape("drive", seq, batch, "train"), 1)
    return (f"model-FLOP share {mf / step_s / HW['peak_flops'] * 100:.2f}% "
            f"(roofline.model_flops {mf / 1e12:.3f} T a step over "
            f"{step_s:.4f} s, of HW peak_flops "
            f"{HW['peak_flops'] / 1e12:g} TFLOP/s)")


def train_drive(label, cfg, params, dev, *, steps, batch, seq, lr):
    """``steps`` steps of ``make_train_step`` (AdamW at ``lr``,
    launch/train.py's schedule) over ``lm_batches`` of seed 0.  Returns
    (params, opt state, losses, aux losses, host s per step, launches)."""
    model = build_model(cfg)
    opt = AdamW(learning_rate=lr, moment_dtype=cfg.moment_dtype)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, train_schedule(steps))
    data = train_batches(cfg, dev, batch, seq)
    losses, auxes, times = [], [], []
    reset_train_counts()
    for _ in range(steps):
        mb = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, mt = step_fn(params, state, mb)
        losses.append(float(mt["loss"]))
        auxes.append(float(mt["aux_loss"]))
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses + auxes):
        raise SystemExit(f"FAIL {label}: non-finite loss {losses} / aux "
                         f"{auxes}")
    launches = hold_train_counts(label, cfg, steps * max(1, cfg.grad_accum))
    print(f"  {label}: losses {[round(x, 4) for x in losses]}")
    return params, state, losses, auxes, times, launches


def grad_configs() -> list:
    """The configs ``phase_train`` holds by ``grad_check``: llama3.2-1b at
    full width and depth, TRAIN_WIDE's MoE and TRAIN_RECURRENT's families
    cut to GRAD_CUT_LAYERS, in the order it checks them."""
    cfgs = [get_config(TRAIN_ARCH)]
    cfgs += [c for c in (get_config(arch).with_overrides(**cut)
                         for arch, cut, _, _ in TRAIN_WIDE)
             if c.family == "moe"]
    cfgs += [get_config(arch).with_overrides(n_layers=GRAD_CUT_LAYERS)
             for arch, *_ in TRAIN_RECURRENT]
    return cfgs


class HostGradients:
    """The CPU's side of every ``grad_check`` (the plain versions' loss and
    gradients at GRAD_BATCH), computed in turn on one daemon host thread
    from the kernels' build on, while the card runs the phases before 6c.
    The thread first draws each config's weights on the card as
    ``phase_train`` draws them (seed 0) and copies them to the CPU; the
    main thread waits for that (``wait_drawn``) before it drives the card.
    ``take`` holds the card's weights bit-identical to that copy before it
    hands the CPU's result over.  The thread runs at the lowest priority
    (nice 19) on half of torch's CPU threads, so that nvcc and the main
    thread's host-bound drives keep their cores."""

    def __init__(self, dev, cfgs):
        self.threads = max(1, torch.get_num_threads() // 2)
        jobs = [(c, {}, threading.Event()) for c in cfgs]
        self._jobs = {(job[0].name, job[0].n_layers): job for job in jobs}
        self._drawn = threading.Event()
        self._error = None
        threading.Thread(target=self._run, args=(dev, jobs),
                         name="host-gradients", daemon=True).start()

    def _run(self, dev, jobs) -> None:
        with contextlib.suppress(OSError):
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        torch.set_num_threads(self.threads)
        try:
            for cfg, out, _ in jobs:
                params = build_model(cfg).init(
                    torch.Generator(device=dev).manual_seed(0))
                out["params"] = tree_unflatten(
                    params, [t.cpu() for t in tree_leaves(params)])
                del params
                b, s = GRAD_BATCH[cfg.name]
                out["batch"] = next(train_batches(cfg, torch.device("cpu"),
                                                  b, s))
            torch.cuda.empty_cache()
        except BaseException as e:  # noqa: BLE001 - raised in wait_drawn()
            self._error = e
        self._drawn.set()
        for cfg, out, done in jobs:
            if "params" in out:
                try:
                    t0 = time.perf_counter()
                    loss, _, grads = loss_and_grads(
                        build_model(cfg), out["params"], out["batch"])
                    out["result"] = (loss, grads, time.perf_counter() - t0)
                except BaseException as e:  # noqa: BLE001 - raised in take()
                    out["error"] = e
            done.set()

    def wait_drawn(self) -> None:
        """Wait until the thread has drawn every config's weights on the
        card (it touches the card no more after that)."""
        self._drawn.wait()
        if self._error is not None:
            raise SystemExit(f"FAIL drawing the gradient checks' weights: "
                             f"{self._error!r}")

    def take(self, cfg, params):
        """(loss, grads, CPU seconds, seconds waited) of ``cfg`` at
        ``params`` (on the card)."""
        _, out, done = self._jobs.pop((cfg.name, cfg.n_layers))
        if not all(torch.equal(a.cpu(), b) for a, b in
                   zip(tree_leaves(params), tree_leaves(out["params"]))):
            raise SystemExit(f"FAIL {cfg.name} gradients: the card's "
                             f"weights differ from those of the CPU's side")
        t0 = time.perf_counter()
        done.wait()
        if "error" in out:
            raise SystemExit(f"FAIL {cfg.name} gradients on the CPU: "
                             f"{out['error']!r}")
        loss, grads, secs = out["result"]
        return loss, grads, secs, time.perf_counter() - t0


def grad_check(cfg, params, dev, host: HostGradients) -> dict:
    """The gradients of ``cfg``'s loss on the card (the flash and SSD
    kernels forward and backward) against the CPU's (the plain versions) on the
    same bf16 weights and a GRAD_BATCH batch: the loss within 1e-3
    relative, every leaf within GRAD_REL_BAR (GRAD_REL_BAR_MOE for an MoE,
    GRAD_REL_BAR_SSM for the recurrent families) in relative norm
    (``grad_rel_errors``).  The CPU's side is ``host``'s, taken on a host
    thread beforehand.  A missing or
    sign-flipped attention gradient is off by about 1 or 2 on every leaf
    below attention (tests/test_torch_gpu.py).  Returns the card's
    launches."""
    b, s = GRAD_BATCH[cfg.name]
    bar = {"moe": GRAD_REL_BAR_MOE, "ssm": GRAD_REL_BAR_SSM,
           "hybrid": GRAD_REL_BAR_SSM}.get(cfg.family, GRAD_REL_BAR)
    model = build_model(cfg)
    mb = next(train_batches(cfg, dev, b, s))
    reset_train_counts()
    t0 = time.perf_counter()
    lg, _, g_card = loss_and_grads(model, params, mb)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = hold_train_counts(f"{cfg.name} gradients", cfg, 1)
    lc, g_cpu, cpu_s, waited = host.take(cfg, params)
    errs = grad_rel_errors(g_card, g_cpu)
    names = ["/".join(p) for p, _ in tree_items(params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    parts = []
    for what, leaves in (("the attention projections'",
                          ("wq", "wk", "wv", "wo")),
                         ("the SSD scan's inputs' (bc_proj, dt_proj, a_log, "
                          "in_proj_x)",
                          ("bc_proj", "dt_proj", "a_log", "in_proj_x"))):
        mine = [e for n, e in zip(names, errs) if n.split("/")[-1] in leaves]
        if mine:
            parts.append(f"{what} {max(mine):.3e}")
    print(f"  {cfg.name} gradients, card vs CPU (B {b} x S {s}, "
          f"{len(errs)} leaves): loss {float(lg):.6f} vs {float(lc):.6f}; "
          f"largest relative error {errs[worst]:.3e} ({names[worst]}), "
          f"{', '.join(parts)} (bar {bar:g}); card {t1 - t0:.2f} s, CPU "
          f"{cpu_s:.1f} s on the host thread, {waited:.1f} s waited for")
    if not abs(float(lg) - float(lc)) <= 1e-3 * abs(float(lc)):
        raise SystemExit(f"FAIL {cfg.name} gradients: loss {float(lg)} on "
                         f"the card vs {float(lc)} on the CPU")
    bad = {n: e for n, e in zip(names, errs) if not e <= bar}
    if bad:
        raise SystemExit(f"FAIL {cfg.name} gradients: leaves off the CPU's "
                         f"beyond {bar:g}: {bad}")
    return launches


@contextlib.contextmanager
def plain_ssd_backward():
    """SSDScanFunction's backward by the plain version (f32, on the same
    saved tensors) inside the block, the kernel's outside."""
    kernel = ssd_ops.ssd_scan_backward

    def plain(*args, chunk=256):
        return ssd_backward_reference(*args, chunk=chunk)
    ssd_ops.ssd_scan_backward = plain
    try:
        yield
    finally:
        ssd_ops.ssd_scan_backward = kernel


def ssd_plain_check(cfg, params, dev) -> dict:
    """A recurrent model's gradients at full depth on the card with the SSD
    backward kernel against the same gradients with its plain version
    (``plain_ssd_backward``): the same forward launches, so only the scan's
    backward differs; every leaf within SSD_PLAIN_GRAD_BAR in relative
    norm, the loss bit-equal.  Returns the kernel run's launches (the
    plain run's are a comparison's, not counted)."""
    b, s = GRAD_BATCH[cfg.name]
    model = build_model(cfg)
    mb = next(train_batches(cfg, dev, b, s))
    reset_train_counts()
    t0 = time.perf_counter()
    lk, _, g_kernel = loss_and_grads(model, params, mb)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = hold_train_counts(f"{cfg.name} gradients", cfg, 1)
    with plain_ssd_backward():
        lp, _, g_plain = loss_and_grads(model, params, mb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reset_train_counts()
    errs = grad_rel_errors(g_kernel, g_plain)
    names = ["/".join(p) for p, _ in tree_items(params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    bc = max(e for n, e in zip(names, errs) if n.endswith("bc_proj"))
    print(f"  {cfg.name} gradients at full depth, SSD backward kernel vs "
          f"its plain version on the card (B {b} x S {s}, {len(errs)} "
          f"leaves): loss {float(lk):.6f} vs {float(lp):.6f}; largest "
          f"relative error {errs[worst]:.3e} ({names[worst]}), bc_proj "
          f"{bc:.3e} (bar {SSD_PLAIN_GRAD_BAR:g}); kernel run "
          f"{t1 - t0:.2f} s, plain run {t2 - t1:.2f} s")
    if float(lk) != float(lp):
        raise SystemExit(f"FAIL {cfg.name}: the loss differs between the "
                         f"two backward runs ({float(lk)} vs {float(lp)})")
    bad = {n: e for n, e in zip(names, errs) if not e <= SSD_PLAIN_GRAD_BAR}
    if bad:
        raise SystemExit(f"FAIL {cfg.name} gradients: leaves off the plain "
                         f"backward's beyond {SSD_PLAIN_GRAD_BAR:g}: {bad}")
    del g_kernel, g_plain
    torch.cuda.empty_cache()
    return launches


def tree_equal(a, b) -> bool:
    """The same paths, and at each the same dtype, device and values."""
    ia, ib = list(tree_items(a)), list(tree_items(b))
    return [p for p, _ in ia] == [p for p, _ in ib] and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for (_, x), (_, y) in zip(ia, ib))


def phase_train(dev, host: HostGradients) -> dict:
    """Phase 6c (b)-(e): training on the card.  (b) llama3.2-1b at full
    width and depth (seed 0, bf16 weights, f32 moments): its gradients
    against the CPU's (``grad_check``), then TRAIN's steps at
    B x S, the loss finite and falling by TRAIN["min_drop"], exact flash
    launches, s/step, tokens/s, peak GiB and the model-FLOP share of
    HW["peak_flops"] printed, then the params and state round-tripped through
    save_checkpoint / load_checkpoint bit for bit; (c), (d) TRAIN_WIDE at
    full width cut to 2 layers, each at its learning rate: qwen2-1.5b (qkv
    biases, dh 128) and its grad accumulation 2 against 1, olmoe-1b-7b
    with its gradients against the CPU's (``grad_check``) and its router
    aux loss finite and > 0, each loss falling; (e) TRAIN_RECURRENT at
    full width and depth, zamba2-1.2b and mamba2-2.7b, each with its
    gradients with the SSD backward kernel against those with its plain
    version (``ssd_plain_check``), and cut to GRAD_CUT_LAYERS against the
    CPU's (``grad_check``), then its steps (the SSD kernels forward and
    backward, exact launches), the loss falling by the case's least fall,
    s/step, tokens/s, peak GiB and the model-FLOP share printed.  The
    CPU's gradients are ``host``'s (``grad_configs``).  Returns
    the summed launches."""
    total = {}

    def add(launches):
        for sym, n in launches.items():
            total[sym] = total.get(sym, 0) + n

    cfg = get_config(TRAIN_ARCH)
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"phase 6c (b): training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d {cfg.d_model}, H{cfg.n_heads}/"
          f"KV{cfg.n_kv_heads}, vocab {cfg.vocab_size}, {n_params / 1e9:.4f} "
          f"B parameters, remat {cfg.remat}), B {b} x S {s}, {steps} steps, "
          f"lr {TRAIN['lr']:g}")
    add(grad_check(cfg, params, dev, host))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, _, times, launches = train_drive(
        cfg.name, cfg, params, dev, steps=steps, batch=b, seq=s,
        lr=TRAIN["lr"])
    add(launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not losses[-1] <= losses[0] - TRAIN["min_drop"]:
        raise SystemExit(f"FAIL {cfg.name} training: last loss "
                         f"{losses[-1]:.4f} not {TRAIN['min_drop']} below the "
                         f"first {losses[0]:.4f}")
    step_s = float(np.median(times[1:]))
    attn = 6.0 * cfg.n_layers * b * cfg.n_heads * cfg.head_dim * s * s
    flops = 6.0 * n_params * b * s + attn
    print(f"  {cfg.name}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; first "
          f"step {times[0]:.3f} s, then {step_s:.4f} s/step (median), "
          f"{b * s / step_s:.1f} tokens/s, peak {peak:.3f} GiB; model "
          f"FLOPs a step 6 N T + 6 L B H dh S^2 = {flops / 1e12:.2f} T, "
          f"{flops / step_s / HW['peak_flops'] * 100:.2f}% of "
          f"{HW['peak_flops'] / 1e12:g} TFLOP/s")
    print(f"  {cfg.name}: {flop_share(cfg, b, s, step_s)}")
    CKPT_PATH.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_checkpoint(str(CKPT_PATH), params, state, step=steps)
    t1 = time.perf_counter()
    p2, s2, step2 = load_checkpoint(str(CKPT_PATH), params, state)
    t2 = time.perf_counter()
    size = CKPT_PATH.stat().st_size
    CKPT_PATH.unlink()
    if step2 != steps or not tree_equal(params, p2) \
            or not tree_equal(state._asdict(), s2._asdict()):
        raise SystemExit("FAIL checkpoint round trip: not bit-identical")
    print(f"  checkpoint round trip bit-identical: {size / 1e9:.3f} GB, save "
          f"{t1 - t0:.1f} s, load {t2 - t1:.1f} s")
    del params, state, p2, s2
    torch.cuda.empty_cache()

    for arch, cut, wsteps, wlr in TRAIN_WIDE:
        wcfg = get_config(arch).with_overrides(**cut)
        print(f"phase 6c ({'c' if arch == TRAIN_WIDE[0][0] else 'd'}): "
              f"training {wcfg.name} at full width cut to {wcfg.n_layers} "
              f"layers (d {wcfg.d_model}, H{wcfg.n_heads}/KV{wcfg.n_kv_heads}"
              f", dh {wcfg.head_dim}, vocab {wcfg.vocab_size}), B {b} x S "
              f"{s}, {wsteps} steps, lr {wlr:g}")
        params = build_model(wcfg).init(
            torch.Generator(device=dev).manual_seed(0))
        if wcfg.family == "moe":
            add(grad_check(wcfg, params, dev, host))
        # train_drive returns new tensors: params stays the initial weights
        _, _, losses, auxes, times, launches = train_drive(
            wcfg.name, wcfg, params, dev, steps=wsteps, batch=b, seq=s,
            lr=wlr)
        add(launches)
        step_s = float(np.median(times[1:]))
        print(f"  {wcfg.name}: {step_s:.4f} s/step (median), "
              f"{flop_share(wcfg, b, s, step_s)}")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"FAIL {wcfg.name} training: the loss did not "
                             f"fall ({losses})")
        if wcfg.family == "moe":
            if not all(a > 0 for a in auxes):
                raise SystemExit(f"FAIL {wcfg.name}: router aux loss not > 0 "
                                 f"({auxes})")
            print(f"  {wcfg.name}: router aux loss {auxes[0]:.6f} -> "
                  f"{auxes[-1]:.6f}")
        if arch == TRAIN_WIDE[0][0]:
            add(accum_check(wcfg, params, dev))
        del params
        torch.cuda.empty_cache()

    for arch, steps, rb, rs, lr, drop in TRAIN_RECURRENT:
        rcfg = get_config(arch)
        params = build_model(rcfg).init(
            torch.Generator(device=dev).manual_seed(0))
        n_params = sum(t.numel() for t in tree_leaves(params))
        groups = -(-rcfg.n_layers // rcfg.hybrid_attn_every) \
            if rcfg.family == "hybrid" else 0
        print(f"phase 6c (e): training {rcfg.name} at full width and depth "
              f"({rcfg.n_layers} Mamba2 layers{f' + {groups} applications of the shared attention block' if groups else ''}"
              f", d {rcfg.d_model}, H {rcfg.ssm_heads} x P "
              f"{rcfg.ssm_head_dim}, N {rcfg.ssm_state}, chunk "
              f"{rcfg.ssm_chunk}, vocab {rcfg.vocab_size}, "
              f"{n_params / 1e9:.4f} B parameters, remat {rcfg.remat}), B "
              f"{rb} x S {rs}, {steps} steps, lr {lr:g}")
        add(ssd_plain_check(rcfg, params, dev))
        # the card against the CPU where the two bf16 forwards still agree
        ccfg = rcfg.with_overrides(n_layers=GRAD_CUT_LAYERS)
        cut = build_model(ccfg).init(
            torch.Generator(device=dev).manual_seed(0))
        print(f"  {rcfg.name} cut to {GRAD_CUT_LAYERS} layers for the "
              f"gradients against the CPU's")
        add(grad_check(ccfg, cut, dev, host))
        del cut
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, losses, _, times, launches = train_drive(
            rcfg.name, rcfg, params, dev, steps=steps, batch=rb, seq=rs,
            lr=lr)
        add(launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not losses[-1] < losses[0] - drop:
            raise SystemExit(f"FAIL {rcfg.name} training: last loss "
                             f"{losses[-1]:.4f} not {drop} below the first "
                             f"{losses[0]:.4f}")
        step_s = float(np.median(times[1:]))
        attn = 6.0 * groups * rb * rcfg.n_heads * rcfg.head_dim * rs * rs
        flops = 6.0 * n_params * rb * rs + attn
        print(f"  {rcfg.name}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"first step {times[0]:.3f} s, then {step_s:.4f} s/step "
              f"(median), {rb * rs / step_s:.1f} tokens/s, peak {peak:.3f} "
              f"GiB; model FLOPs a step 6 N T"
              f"{' + 6 G B H dh S^2' if groups else ''} = "
              f"{flops / 1e12:.2f} T, "
              f"{flops / step_s / HW['peak_flops'] * 100:.2f}% of "
              f"{HW['peak_flops'] / 1e12:g} TFLOP/s")
        print(f"  {rcfg.name}: {flop_share(rcfg, rb, rs, step_s)}")
        del params
        torch.cuda.empty_cache()
    return total


def accum_check(cfg, params, dev) -> dict:
    """Grad accumulation 2 against 1 on one B x S batch from the same
    weights: the loss within 1e-2 relative and every parameter after the
    step within rtol 5e-2, atol 5e-3 (tests/test_training.py's bars)."""
    batch = next(train_batches(cfg, dev, TRAIN["batch"], TRAIN["seq"],
                               seed=1))
    opt = AdamW(learning_rate=ACCUM_LR)
    out, total = {}, {}
    for accum in (1, 2):
        acfg = cfg.with_overrides(grad_accum=accum)
        reset_train_counts()
        out[accum] = make_train_step(build_model(acfg), opt)(
            params, opt.init(params), batch)
        for sym, n in hold_train_counts(f"{cfg.name} grad_accum {accum}",
                                        acfg, accum).items():
            total[sym] = total.get(sym, 0) + n
    l1, l2 = float(out[1][2]["loss"]), float(out[2][2]["loss"])
    if not abs(l1 - l2) <= 1e-2 * abs(l1):
        raise SystemExit(f"FAIL grad_accum: loss {l2} vs {l1}")
    worst = 0.0
    for a, c in zip(tree_leaves(out[1][0]), tree_leaves(out[2][0])):
        a32, c32 = a.float(), c.float()
        err = (a32 - c32).abs()
        if bool((err > 5e-2 * c32.abs() + 5e-3).any()):
            raise SystemExit(f"FAIL grad_accum: params differ by "
                             f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    print(f"  {cfg.name} grad_accum 2 vs 1: loss {l2:.6f} vs {l1:.6f}, "
          f"params within {worst:.3e} (bars: loss rel 1e-2; rtol 5e-2, atol "
          f"5e-3)")
    return total


def main() -> int:
    kernels_only = sys.argv[1:] == ["--kernels"]
    if sys.argv[1:] and not kernels_only:
        print(f"usage: {sys.argv[0]} [--kernels]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])

    t0 = start = time.perf_counter()

    def stamp(done: str) -> None:
        print(f"  [{done} done at {time.perf_counter() - start:.1f} s]")
    host = None
    if not kernels_only:
        cfgs = grad_configs()
        host = HostGradients(dev, cfgs)
        which = ", ".join(f"{c.name} at {c.n_layers} layers" for c in cfgs)
        print(f"phase 6c's CPU gradients ({which}) started on a host thread "
              f"(nice 19, {host.threads} CPU threads)")
    parent_builds = [BuildThread(target=f) for f in
                     (build_parent_ssd, build_parent_gittins,
                      build_parent_flash_bwd, build_parent_categorical)]
    for t in parent_builds:
        t.start()          # their nvcc beside the package's
    built = build_all()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.2f} "
          f"s wall (nvcc per source: "
          f"{ {k: round(v[0], 2) for k, v in built.items()} })")
    for _, log in built.values():
        print_ptxas(log)
    BUILD_LOGS.update({k: log for k, (_, log) in built.items()})
    for t in parent_builds:
        t.join()
    if "log" in PARENT_SSD:
        print("  the parent's SSD kernel (tools/ssd_variants/scalar.cu):")
        print_ptxas(PARENT_SSD["log"])
        print("  the parent's SSD backward kernel "
              "(tools/ssd_variants/bwd_scalar.cu):")
        print_ptxas(PARENT_SSD["backward_log"])
    if "log" in PARENT_FLASH_BWD:
        print("  the parent's flash backward kernel "
              "(tools/flash_variants/bwd_mma_sync.cu):")
        print_ptxas(PARENT_FLASH_BWD["log"])
    if "log" in PARENT_GITTINS:
        print("  the parent's Gittins kernel "
              "(tools/gittins_variants/warp_row.cu):")
        print_ptxas(PARENT_GITTINS["log"])

    if host is not None:
        host.wait_drawn()   # the card is the main thread's from here on
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev).manual_seed(1234)
    print("phase 3: attention and SSD scan kernels vs plain versions")
    attn = [cfg, get_config("zamba2-1.2b")]
    rows = [phase_decode(attn, dev, gen), phase_flash(attn, dev, gen),
            phase_dense_decode(dev, gen), phase_ssd(dev, gen)]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 phase_flash_noncausal(dev, gen))
    # this PR's checks draw after the earlier ones, which keep their inputs
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 phase_flash_dh128(dev, gen))
    rows.append(phase_lse(dev, gen))
    phase_wide_heads(dev, gen, {r["name"]: r for r in rows}, kernels_only)
    phase_moe_heads(dev, gen, {r["name"]: r for r in rows})
    print("phase 3 (categorical): the sampling kernel vs its plain version")
    rows.append(phase_categorical(dev))
    stamp("phase 3")
    if kernels_only:
        print("phase 6: gittins kernel (no serve drive: main-path shape "
              "taken as (8, 8))")
        phase_gittins(dev, (8, 8))
        print("phase 6c (a): the flash backward kernel vs its plain version")
        phase_train_kernels(dev, gen)
        print("phase 6c (a'): the SSD scan backward kernel vs its plain "
              "version")
        phase_train_ssd_kernels(dev, gen)
        return 0

    launches, shape = {}, (0, 0)
    for arch in SERVED:
        cfg = get_config(arch)
        print(f"phase 4: serving {cfg.name} at full width "
              f"({cfg.n_layers} layers, d {cfg.d_model}, vocab "
              f"{cfg.vocab_size})")
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        got, shp, streams = phase_serve(cfg, dev, params=params)
        for sym, n in got.items():
            launches[sym] = launches.get(sym, 0) + n
        if shp[0] * shp[1] > shape[0] * shape[1]:
            shape = shp
        if cfg.family in ("ssm", "hybrid"):
            print(f"phase 4b: serving {cfg.name} at full width and depth "
                  f"tensor-parallel ({cfg.ssm_heads} Mamba2 heads"
                  f"{f', H{cfg.n_heads}/KV{cfg.n_kv_heads}' if cfg.family == 'hybrid' else ''}"
                  f"), every shard on {torch.cuda.get_device_name(0)}; (a) "
                  f"is phase 4's drives")
            for sym, n in phase_serve_tp(
                    dev, arch, RECURRENT_TP_DRIVES, params=params,
                    known={("a", mode): streams[f"{mode}, graphs"]
                           for mode in ("fused", "orchestrated")}).items():
                launches[sym] = launches.get(sym, 0) + n
        del params
        torch.cuda.empty_cache()
        stamp(f"phase 4 ({arch})")
    shared = {}   # nemotron's weights, for its phase-5 drive too
    for arch, cut in WIDE:
        cfg = get_config(arch).with_overrides(**cut)
        print(f"phase 4: serving {cfg.name} at full width cut to "
              f"{cfg.n_layers} layers (d {cfg.d_model}, H{cfg.n_heads}/"
              f"KV{cfg.n_kv_heads}, dh {cfg.head_dim}, vocab "
              f"{cfg.vocab_size}), fused")
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        for sym, n in phase_serve_wide(cfg, params, dev).items():
            launches[sym] = launches.get(sym, 0) + n
        if any(arch == a for a, c, _ in GENERATE_DRIVES if c == cut):
            shared[arch] = params
        del params
        torch.cuda.empty_cache()
    cfg = get_config(TP_ARCH)
    print(f"phase 4b: serving {cfg.name} at full width tensor-parallel "
          f"({cfg.n_layers} layers, d {cfg.d_model}, H{cfg.n_heads}/"
          f"KV{cfg.n_kv_heads}, vocab {cfg.vocab_size}), every shard on "
          f"{torch.cuda.get_device_name(0)}")
    for sym, n in phase_serve_tp(dev).items():
        launches[sym] = launches.get(sym, 0) + n
    stamp("phase 4b")
    cfg = get_config(FRONT_ARCH)
    print(f"phase 4c: the front door, {cfg.name} at full width "
          f"({cfg.n_layers} layers) behind the Gateway with prefix sharing")
    t4c = time.perf_counter()
    for sym, n in phase_front_door(dev).items():
        launches[sym] = launches.get(sym, 0) + n
    print(f"  phase 4c took {time.perf_counter() - t4c:.1f} s")
    for arch, cut, kw in GENERATE_DRIVES:
        cfg = get_config(arch).with_overrides(**cut)
        layers = (f"{cfg.n_encoder_layers} + {cfg.n_layers}"
                  if cfg.family == "encdec" else f"{cfg.n_layers}")
        print(f"phase 5: generating with {cfg.name} at full width ({layers} "
              f"layers{f', cut by {cut}' if cut else ''}, d {cfg.d_model}, "
              f"vocab {cfg.vocab_size}) through Model.prefill -> "
              f"Model.decode_step")
        for sym, n in phase_generate(cfg, dev, params=shared.pop(arch, None),
                                     **kw).items():
            launches[sym] = launches.get(sym, 0) + n
        torch.cuda.empty_cache()
    stamp("phase 5")
    got, shp = phase_moe(dev)
    stamp("phase 4d")
    for sym, n in got.items():
        launches[sym] = launches.get(sym, 0) + n
    if shp[0] * shp[1] > shape[0] * shape[1]:
        shape = shp
    print(f"phase 6: gittins kernel (largest main-path refresh {shape})")
    rows.insert(0, phase_gittins(dev, shape))
    print("phase 6b: the simulator's central scheduler on the card")
    t6b = time.perf_counter()
    for sym, n in phase_simulator(dev).items():
        launches[sym] = launches.get(sym, 0) + n
    print(f"  phase 6b took {time.perf_counter() - t6b:.1f} s")
    stamp("phase 6b")
    print("phase 6c (a): the flash backward kernel vs its plain version")
    t6c = time.perf_counter()
    rows.append(phase_train_kernels(dev, gen))
    print("phase 6c (a'): the SSD scan backward kernel vs its plain version")
    rows.append(phase_train_ssd_kernels(dev, gen))
    for sym, n in phase_train(dev, host).items():
        launches[sym] = launches.get(sym, 0) + n
    print(f"  phase 6c took {time.perf_counter() - t6c:.1f} s")
    print("phase 6d: the dry-run and the roofline on H100 peaks (meta "
          "device)")
    phase_dryrun()
    stamp("phase 6d")
    symbols = {"gittins_attained": GITTINS_KERNEL.symbol,
               "decode_attention_paged": PAGED_DECODE_KERNEL.symbol,
               "flash_attention_prefill": FLASH_PREFILL_KERNEL.symbol,
               "decode_attention_dense": DENSE_DECODE_KERNEL.symbol,
               "ssd_scan": SSD_SCAN_KERNEL.symbol,
               "decode_attention_paged_lse": PAGED_LSE_KERNEL.symbol,
               "flash_attention_backward": FLASH_BACKWARD_KERNEL.symbol,
               "ssd_scan_backward": SSD_BACKWARD_KERNEL.symbol,
               "categorical": CATEGORICAL_KERNEL.symbol}
    for row in rows:
        row["launches"] = launches[symbols[row["name"]]]
    # the flash kernel's two entry points: one launch a call each
    flash = next(r for r in rows if r["name"] == "flash_attention_prefill")
    flash["split_launches"] = launches.get(FLASH_SPLIT_KERNEL.symbol, 0)
    flash["lse_launches"] = launches.get(FLASH_PREFILL_LSE_KERNEL.symbol, 0)
    flash["launches"] += flash["split_launches"] + flash["lse_launches"]
    flash["instances"] = {
        "training forward (under autograd)": "flash_attention_prefill_lse "
        "(the same kernel, also writing each row's log-sum-exp)",
        "Sq > 16, causal or windowed": "flash_attention_prefill (1 consumer "
        "warpgroup a 64-row query tile)",
        "Sq <= 16, bidirectional": "attention_short_queries in "
        "src/repro_torch/csrc/decode_attention.cu (split-KV decode template "
        "with key positions, 256-row sub-splits) + merge_kernel"}
    if flash["lse_launches"] == 0:
        raise SystemExit("FAIL: the flash LSE instance never launched on a "
                         "training drive")
    if flash["split_launches"] == 0:
        raise SystemExit("FAIL: the flash key split never launched on a "
                         "main path")
    idle = [r["name"] for r in rows if r["launches"] == 0]
    if idle:
        raise SystemExit(f"FAIL: kernels never launched on a main path: "
                         f"{idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "split_launches", "lse_launches", "instances", "op_ms",
            "refresh_ms",
            "staged_copies", "near_tie_lanes", "parent_ms", "ms_std3",
            "parent_ms_std3")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
