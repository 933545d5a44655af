#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds the kernels from `src/repro_torch/kernels/csrc`;
   for each kernel written with wgmma/TMA (the flash forward, dq and dk/dv
   passes at each (q/k, v) head dim pair, the SSD scan at each state dim,
   the SSD backward's walkers and gradient pass at each head and state dim),
   its registers, spills, shared memory and blocks an SM from the `ptxas -v`
   report (the flash kernels' head dim 80 and <192, 128> instances, the SSD
   scan's N 16 one and the SSD backward's P 64, N 128 and P 64, N 16 ones
   must not spill), and the registers and
   spills of every instance of decode attention and of the RMSNorm backward
   (none of which may spill).
3. kernels — each kernel of the serve and train paths, at the shapes that
   path gives it, against its plain PyTorch version on the same inputs; its
   time, the plain version's, one library call's as a yardstick (never used
   by the port), and the least time the card could take (the bound).  The
   flash forward is also timed at the train shape and, with dq and dk/dv,
   at stablelm-3b's head dim 80 (every pass takes it as it is); the dq pass
   also at rep 1 (MHA) and head dim 128 on an odd number of q tiles; the
   dk/dv pass at every cluster size it takes, the whole flash backward (dq,
   then dk/dv) beside SDPA's backward.  Decode
   attention runs at the serve paths' own lengths (513-576 of a 1024-row
   cache) for chatglm3-6b and stablelm-3b, at every cluster size, the
   output and each row's lse (for the merge over a sequence-split cache;
   at TOL_LSE) against the plain version, the output bitwise the same with
   and without the lse; RMSNorm
   also at the decode steps' [4, d], and at deepseek-v2-lite-16b's shapes
   (d 2048, and kv_norm's 512 columns of each 576-column row, read at that
   pitch), and the RMSNorm backward at its d 2048 and at kv_norm's [4096,
   512] rows of pitch 576; the fused CE and its backward also at its vocab
   102400 ([512, 102400], one of 8 chunks).  The three flash passes at q/k
   head dim 192 and v head dim 128 (deepseek-v2-lite-16b's MLA, MHA, 8 x 16
   heads x 512, and a 200-row tail), each against its plain version,
   bitwise repeatable, timed beside SDPA and bound by causal pairs; the same
   at deepseek-v3-671b's 128 heads (8 x 128 heads x 512).  deepseek-v3-671b's
   shapes: RMSNorm at [2048, 7168], [2048, 1536] (q_norm), [4, 7168] and [4,
   1536], its backward at [4096, 7168] and [4096, 1536], the CE and its
   backward at vocab 129280 ([512, 129280] and the MTP loss's [584,
   129280]).  jamba-1.5-large-398b's shapes: RMSNorm at [2048, 8192],
   [2048, 16384] (the Mamba layers' gated out_norm over d_inner), [4, 8192]
   and [4, 16384]; the flash forward at B 4, 64 heads over 8 kv heads (GQA
   rep 8), S 512, D 128 from the 1024-row cache; decode attention at rep 8
   at the serve lengths, every cluster size; the SSD scan at x [4, 512, 256,
   64], N 16 (and a 513-row tail from a nonzero state), held to the plain
   version and to the fp64 recurrence; the SSD backward at [8, 512, 256,
   64], P 64, N 16, held as at mamba2-130m's shape; the RMSNorm backward at
   [4096, 16384] (the gated out_norm of a full-width train step, four
   vectors a thread), bitwise repeatable, timed beside `F.rms_norm`'s
   backward and its bytes bound, the card's name and power limit beside.
   The last four families' shapes: RMSNorm at pixtral-12b's [2048, 5120] and [4, 5120];
   the flash forward from the 1024-row cache at B 4 for command-r-35b (64
   heads over 8), starcoder2-15b (48 over 4: rep 12), pixtral-12b (32 over
   8: rep 4) and musicgen-large (MHA, D 64), and at musicgen-large's train
   shape (B 8); dq and dk/dv (every cluster size, bitwise repeatable) at
   starcoder2-15b's rep 12 (B8 H48 Hkv4 S512 D128) and musicgen-large's D 64
   MHA; decode attention at the serve lengths, every cluster size, for all
   four (musicgen-large's is decode_kernel<64, 1>); the CE and its backward
   at command-r-35b's vocab 256000 and musicgen-large's 2048 ([512, V]).
   The dq
   pass, decode attention and the RMSNorm backward (at every shape) are
   checked bitwise repeatable; the SSD scan's
   y and final state at the serve shape and at an 8193-token tail from a
   nonzero state, against the plain version and, by relative L2 error,
   against an fp64 recurrence.  The SSD scan's backward (no TPU
   counterpart) at mamba2-130m's train shape (8 x 2048 tokens) and at a
   2049-token tail from a nonzero state with a gradient on the final
   state: every gradient against the plain version, against fp64 autograd
   of the plain scan by relative L2 error, and bitwise repeatable.
4. serve, serve_ssm, serve_stablelm — full-width chatglm3-6b (28 layers, d
   4096), mamba2-130m (24 layers, d 768) and stablelm-3b (32 layers, d
   2560, head dim 80), random weights from a seed, serve 4 prompts of 512
   (mamba2: 8192) tokens and generate 64 through `Server.generate`, every
   kernel's launch count checked; after each, cross_check(_ssm, _stablelm)
   holds a prefill of one token more against the prefill plus one decode.
   serve_moe — full-width deepseek-v2-lite-16b (27 layers, d 2048, MLA, 64
   routed experts top-6 + 2 shared, the first layer dense; 15.7 B params),
   4 x 512 prompt tokens + 64 through the same `serve`: the RMSNorm kernel
   is its one kernel (MLA's absorbed attention and the MoE stay plain torch,
   as JAX's jnp); cross_check_moe with capacity_factor = n_experts / top_k
   and, for the gate, each MoE layer's selection in the decode step pinned
   to the prefill's (the unpinned error and the near-tie flips beside it;
   every flip's top-k gaps must be below NEAR_TIE).  serve_v3 —
   full-width deepseek-v3-671b cut to its first 4 of 61 layers (3 dense, 1
   MoE: 256 routed experts top-8 + 1 shared, the sigmoid router; q-LoRA,
   128 MLA heads at d 7168; 15.7 B params), the same batch, the RMSNorm its
   one kernel; cross_check_v3 as cross_check_moe.  serve_hybrid —
   full-width jamba-1.5-large-398b cut to one of its 9 period blocks (8
   layers: attention at index 4 over 64 heads, rep 8, seven Mamba layers of
   256 SSD heads at N 16, MoE on layers 1, 3, 5 and 7) and 8 of its 16
   experts (top-2; 25.8 B params, 51.6 GB in bf16), the same batch: the
   RMSNorm (d 8192 and 16384), the flash forward and the SSD scan in the
   prefill, decode attention in each decode step, every launch counted
   (`hybrid_serve_launches`); cross_check_hybrid as cross_check_moe.
   serve_command_r, serve_starcoder2, serve_pixtral, serve_musicgen — the
   last four families at full width and full depth (30.3, 16.0, 12.2 and
   2.4 B params), the same batch, each with its bound (`dense_serve_bound`)
   and every launch counted (`dense_serve_launches`: the flash forward and
   decode attention a layer, pixtral-12b's RMSNorm); pixtral-12b and
   musicgen-large through the stub frontend (`Server.batch`: each token's
   row of a seeded table built once); each followed by its cross_check.
5. train_check, train_check_ssm, train_check_moe, train_check_v3,
   train_check_hybrid, train_check_starcoder2 — one loss and every
   gradient of reduced chatglm3-6b (64 tokens), of reduced mamba2-130m (192
   tokens, three of the SSD kernels' chunks) and of reduced
   deepseek-v2-lite-16b with MLA at the full head dims (192 tokens, three
   flash tiles; the CPU's routing pinned to the card's, flips reported and
   failed at a gap >= NEAR_TIE; an unpinned CPU forward's flips beside,
   each wide one with the flips upstream of it) and of reduced
   deepseek-v3-671b (3 dense layers, 1 MoE layer with the sigmoid router
   and a router_bias drawn from the seed, the MTP layer; MLA at the full
   head dims, q-LoRA at 1536; 192 tokens; router_bias's gradient exactly
   zero on every side) and of reduced starcoder2-15b at rep 12, D 128 (192
   tokens) on the card (kernels) against the same weights and
   batch on the CPU (plain versions), all by one function, `train_check`;
   beside the gate, each side against the same weights in fp32 on the CPU
   (the bf16 model's own rounding).  train_check_hybrid — reduced
   jamba-1.5-large-398b (one period block, 8 query heads over 1 kv head at
   D 128 (rep 8), the SSD kernels at P 64, N 16; 192 tokens) the same way
   unit by unit (`hybrid_train_check`): the embedding, each layer and the
   head on the CPU from the card's input to it and the card's gradient at
   its output, the routing pinned, each unit and each leaf held at
   TOL_GRAD; the whole
   model's card-vs-CPU reading, which bf16 rounding leaves several percent
   apart, printed beside.
6. train, train_stablelm — full-width chatglm3-6b trains 8 steps and
   stablelm-3b 4 steps of batch 8 x 512 tokens through `Trainer.run` (remat
   per layer, 8 cross-entropy chunks, AdamW; chatglm3-6b with bf16 moments,
   the one cut, as its fp32-moment state alone is 74.9 GB; stablelm-3b with
   the Trainer's default fp32 moments), on one fixed batch; every loss
   finite, the last below the first, every launch count per step checked.
   train_ssm — full-width mamba2-130m (24 layers, d 768, 24 SSD heads of
   dim 64, d_state 128, tied embeddings; 129 M params), nothing cut: 8
   steps of batch 8 x 2048 tokens (the Mamba-2 paper's training context),
   fp32 moments, the same checks.  train_resume — the same model and
   shape through the Trainer's BuffetFS data path and checkpoints, on the
   Trainer's default storage, the port's BuffetFS (`repro_torch.core`: 4
   in-process BServers backed by a temp dir, removed at the end): the
   Trainer's own corpus of 128 samples of 2049 tokens, one 8,208-byte file
   each, read back through the Trainer's client; run A stops at step 8 of
   12 (async checkpoints at 4 and 8: 34 leaves, 133 part files and a
   MANIFEST, ~1.29 GB each), run B (a new Trainer, so a new cluster that
   restarts the servers from what they persisted) resumes from it and runs
   9-12, run C runs 12 steps uninterrupted under another run name.  B's
   restored state must be A's final state bitwise, leaf by leaf; B's
   batches C's at steps 9-12 bitwise; B's losses within TOL_RESUME_LOSS of C's
   (whether bitwise is printed); every loss finite; each run's launches
   train_ssm's per step; every run sent RPCs and no OPEN_RECORD; every
   run's servers, instrumented by `repro_torch.core.analysis`'s
   LockOrderRecorder once its Trainer is built (its saves, reads and
   restarts, against the pipeline's prefetch thread, the checkpoint
   writer's thread and the async CLOSEs), nested some pair of lock classes,
   each class registered in the lint's LOCK_RANK and no pair against its
   declared order.  Printed:
   each save's blocking copy to the host, its wait for the previous write
   and its writes, the last wait, the restore, bytes and files written,
   each run's critical and async RPCs by verb, the pipelines' batches,
   samples and hedged reads, peak host and device memory.
   buffetfs_ingest — the paper's mechanism at that file size on the card
   machine's host: 4,096 samples of 2049 tokens (8,208-byte files) in 16
   shard directories of a 4-server cluster, the directories warmed, one
   epoch read through `DataPipeline` (prefetch, no hedging) with each
   batch bitwise the batch from memory and its tokens copied to the card;
   gated exactly (`ingest_failures`): READ RPCs = samples read = the
   critical-path RPCs, no LOOKUP_DIR, LOOKUP_TREE or OPEN_RECORD, one async
   CLOSE a READ, and the agent's permission-check RPCs (`perm_check_rpcs`:
   its group-table fetches) flat over the epoch and the pass below: warm
   files serve their own permission checks.  Then every file opened, read
   and closed one by one
   through BuffetFS, Lustre-Normal and Lustre-DoM (each baseline on a
   cluster of its own, its namespace made by the baseline path): critical
   and async RPCs per file and host wall microseconds per file, no latency
   injected; BuffetFS's one READ and one CLOSE a file gated.
   train_moe — deepseek-v2-lite-16b at
   full width, cut to its first 6 of 27 layers (the dense layer and 5 MoE
   layers, ~3.42 B params), fp32 moments: 8 steps of 8 x 512 tokens, the
   same checks (MLA's expanded branch through the <192, 128> flash kernels,
   kv_norm's backward at its row pitch, the CE at vocab 102400).
   train_v3 — deepseek-v3-671b at full width, cut to its 3 dense layers,
   with the MTP layer loss_fn runs on them (~4.19 B params), fp32 moments:
   8 steps of 8 x 512 tokens, the same checks, mtp_ce finite and falling
   too (the flash passes at <192, 128> over 128 heads, q_norm's backward at
   d 1536, the RMSNorm backward at d 7168, the CE at vocab 129280 in 8
   chunks and the MTP loss's 7).  train_musicgen — musicgen-large at full
   width (48 layers, 2.42 B params), nothing cut, fp32 moments, 8 steps of
   8 x 512 tokens on tokens alone, as the Trainer feeds it.
   train_command_r — command-r-35b at full width cut to 2 of 40 layers,
   fp32 moments: the CE at vocab 256000 and the tied table's two gradient
   paths.  Every launch count per step: `dense_train_launches`.
   train_sharded — the train phase's chatglm3-6b run again (its weights,
   fixed batch and 8 steps) with the state through `shard_train_state` on
   a 1 x 1 (data, model) DeviceMesh of a one-rank NCCL process group and
   the batch through `shard_batch`, each step under `activation_specs_for`:
   each loss within TOL_SHARDED_LOSS of the train phase's and each param
   leaf after the last step within TOL_SHARDED_PARAM (relative L2; whether
   all are bitwise printed), every param and moment leaf at its spec's
   placements, `dense_train_launches` a step (`sharded_failures`); printed:
   the step ms beside the train phase's (DTensor's host cost), peak
   memory, the NCCL version.  compress — one train step's gradient tree
   from the same weights and batch through `compressed_all_reduce` (the
   reduction `compressed_psum_tree` maps, which is the identity on a dim
   of size 1) over a one-dim "pod" mesh of the same group: every leaf
   bitwise plain `_dequantize(_quantize(g))` and within half a
   quantization step of g (`compress_failures`); printed: its ms beside a
   plain bf16 all-reduce of the tree, and the bytes each sends.
   serve_sharded — the serve phase's chatglm3-6b run again (its weights, 4 x
   512 prompts, 64 new tokens, cache 1024) through `Server(..., mesh=...)`
   on the same 1 x 1 mesh of the one-rank NCCL group: params by
   `shard_params`, the cache by `shard_cache`, each step under its
   activation specs; the same tokens as the serve phase's, the last step's
   logits bitwise or within TOL_SHARDED_LOGITS, `dense_serve_launches`
   (`sharded_serve_failures`); printed: prefill ms and decode tokens/s
   beside the serve phase's (DTensor's host cost), peak GB.
   dryrun — with the NCCL group destroyed, `repro_torch.launch.dryrun`
   traces on a fake process group (fake tensors of the card's device; no
   launch, no allocation): chatglm3-6b's cells on a 1 x 1 mesh at the
   phases' own shapes, the train cell (8 x 512, bf16 moments) held to what
   the train phase measured (argument bytes exactly the state and batch
   bytes; peak within TOL_DRYRUN_PEAK of `max_memory_allocated()`; kernel
   calls `dense_train_launches`; FLOPs within TOL_DRYRUN_FLOPS of
   `dense_train_flops`), the prefill and decode cells (B 4, S 512) held to
   one prefill's and one decode step's launches, their peaks printed beside
   the serve phase's (JAX's serve cells size the cache at the shape's
   seq_len, the serve phase's is 1024: not gated); then chatglm3-6b's
   train_4k, prefill_32k and decode_32k cells at 16x16 (256 fake ranks),
   each ok, its record printed: per-device counts of a mesh the card cannot
   form, traced, not run (`dryrun_failures`).
   train_sharded_ssm — train_ssm's run again (its weights, fixed batch and 8
   steps of 8 x 2048) with the state on a 1 x 1 mesh of a one-rank NCCL
   group: the Mamba mixer's sharded path (`models/ssm.py`: heads over
   "model", a dim of size 1 here), each loss and param leaf within
   `sharded_failures`' bounds (bitwise so far), `ssm_train_launches` a step,
   the peak within TOL_SHARDED_PEAK of train_ssm's.  train_sharded_resume —
   on the same group, train_sharded_ssm's run (its weights, fixed batch and
   8 x 2048) stopped after step 4 and saved sharded, async, through
   `CheckpointManager` over the port's BuffetFS (4 in-process BServers in
   a temp dir, removed at the end: 34
   leaves gathered one by one onto rank 0, ~1.29 GB), then restored by
   `elastic_restore` into a fresh sharded state from another seed, and
   resumed for steps 5-8 (`sharded_resume_failures`): the restored state
   bitwise A's at the save and at its placements; the save's MANIFEST a
   plain save's of the same full tensors (names, shapes, dtypes, crc32s);
   the checkpoint restored into a plain `like` bitwise too; every loss and
   the final params bitwise train_sharded_ssm's; `ssm_train_launches` a
   step; the peak device memory within TOL_SHARDED_PEAK of
   train_sharded_ssm's plus the largest leaf's bytes.  Printed: the save's
   gather, copy and write seconds, bytes and files, the restore's seconds,
   peak host and device memory.  dryrun_ssm —
   mamba2-130m's 1 x 1 train cell traced at train_ssm's shape (fp32
   moments), held as chatglm3-6b's is: argument bytes exactly train_ssm's
   state and batch, the traced peak within TOL_DRYRUN_PEAK of train_ssm's
   `max_memory_allocated()`, the FLOPs within TOL_DRYRUN_FLOPS of
   `ssm_train_flops`, the kernel calls `ssm_train_launches`.
   train_sharded_moe — train_moe's run again (6 layers, 8 x 512, 8 steps)
   on the same kind of mesh: the MoE's expert-parallel path and MLA's
   sharded branches, `sharded_failures`' bounds, `moe_train_launches` a
   step, and every route of every MoE call (a RouteRecorder on both runs)
   the unsharded run's.  serve_sharded_ssm, serve_sharded_moe — serve_ssm's
   and serve_moe's runs again through `Server(..., mesh=...)` on that mesh
   (the mixer's decode path against a cache of DTensors; MLA's absorbed
   attention on the sharded latent cache): the same tokens, the last logits
   bitwise or within TOL_SHARDED_LOGITS, the unsharded phase's launches.
   train_hybrid — `hybrid_small_config()` (one period block at d 128 with
   the full model's head dims: GQA rep 8 at D 128, SSD P 64, N 16; a
   full-width hybrid train state does not fit one card) trains 8 steps of 8
   x 512 with bf16 moments, every route recorded; train_sharded_hybrid —
   the same run on the 1 x 1 mesh of one NCCL rank (a period block's Mamba
   mixer, expert-parallel MoE and GQA side by side): losses and params
   bitwise, every leaf at its placements, `hybrid_train_launches` a step, no
   route flipped.  serve_sharded_hybrid — serve_hybrid's run again through
   `Server(..., mesh=...)` (its weights placed with no copy, 51.6 GB once;
   the peak printed beside serve_hybrid's): the same tokens, the last
   logits bitwise or within TOL_SHARDED_LOGITS, serve_hybrid's launches.
   dryrun_hybrid — train_hybrid's 1 x 1 train cell traced: argument bytes
   exactly the measured state and batch, the traced peak within
   TOL_DRYRUN_PEAK of train_hybrid's, the kernel calls
   `hybrid_train_launches`.
   The run's total wall time is printed last of the phases ("total").

Before the last line it prints {"kernels": [...]} and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
without the repo's `src/repro_torch` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (NVIDIA): bf16 dense tensor-core rate, fp32
# CUDA-core rate, HBM3 bandwidth.  The card's power limit is printed beside.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TOL_BF16 = 3e-2          # rtol = atol, as tests/test_kernels.py's TOL_BF16
TOL_RMSNORM = 1e-2       # as tests/test_kernels.py's rmsnorm tolerance
TOL_LSE = 1e-2
TOL_CE = 1e-4            # per-row nll and lse: fp32 sums over the vocab
TOL_DSCALE = 2e-2        # rmsnorm dscale: x its largest |value| (a sum over 4096 rows)
TOL_GRAD = 3e-2          # train_check: relative error of the loss and of all gradients
AUX_WEIGHT = 0.01        # loss_fn's default weight of the MoE aux loss
# the SSD scan's y and final state: relative L2 error against the fp64
# recurrence (`ssd_scan_f64`), at the serve shape and the 8193-token tail;
# the kernel's split bf16 hi + lo operands keep ~16 bits of mantissa, and
# the limit sits between their readings and those of the same products
# without the lo terms (plain bf16 operands), both recorded in PERF.md
TOL_SSD_REL_L2 = 1e-4
# the SSD scan's gradients: relative L2 error against fp64 autograd of the
# plain scan (chunk 256).  dx, dB and dC are bf16 outputs, whose rounding
# alone reads ~1.5e-3: they are held to the fp64 gradient rounded to bf16
# (both numbers are printed)
TOL_SSD_BWD_REL_L2 = 1e-3
# a routing flip between two paths is a near-tie only if the k-th and
# (k+1)-th selection scores of the token are closer than this on both sides
# (tests/test_torch_cuda.py's near_tie)
NEAR_TIE = 1e-2
# prefill(513) against prefill(512) + decode(1): max |diff| over the
# logits' largest magnitude, the bound tests/test_torch_serve.py holds the
# reduced model to (the elementwise 3e-2 bound fails at full width; see
# ROADMAP.md Queue 3)
TOL_CROSS = 3e-2

ARCH = "chatglm3-6b"
BATCH, PROMPT, NEW, MAX_LEN = 4, 512, 64, 1024
SEED = 0
# the train phase: global batch x sequence, steps, cross-entropy chunks
TRAIN_B, TRAIN_S, TRAIN_STEPS, CE_CHUNKS = 8, 512, 8, 8
TRAIN_CUT = ["adamw moment_dtype bf16 (fp32 state is 74.9 GB)"]
# the serve_ssm phase: mamba2-130m at 4 prompts x 8192 tokens, 64 new
SSM_ARCH, SSM_PROMPT = "mamba2-130m", 8192
SSD_CHUNK = 64           # the SSD-scan kernel's chunk (csrc/ssd_scan.cu)
# the train_ssm phase: mamba2-130m at 8 x 2048 tokens (the Mamba-2 paper's
# training context, arXiv:2405.21060), 8 steps
SSM_TRAIN_S, SSM_TRAIN_STEPS = 2048, 8
# the train_resume phase: full-width mamba2-130m at train_ssm's shape over a
# corpus of small sample files (the Trainer's own: 128 samples of 2049
# tokens) and checkpoints on the Trainer's own BuffetFS (4 in-process
# BServers backed by a temp dir; each run's Trainer starts them anew over
# it).  Run A is stopped at
# step RESUME_STOP of RESUME_STEPS (checkpoints at 4 and 8), run B resumes
# from A's checkpoint and runs the steps left, run C runs them all
# uninterrupted; B's losses within TOL_RESUME_LOSS (relative) of C's
RESUME_STOP, RESUME_STEPS, RESUME_CKPT_EVERY = 8, 12, 4
TOL_RESUME_LOSS = 1e-3
# the buffetfs_ingest phase: a corpus of INGEST_FILES samples of train_ssm's
# 2049 tokens (8,208-byte files) in INGEST_DIRS shard directories on a
# cluster of INGEST_SERVERS in-process BServers (the Trainer's default), read
# for one epoch through DataPipeline; then the same files opened, read and
# closed one by one through BuffetFS, Lustre-Normal and Lustre-DoM
INGEST_FILES, INGEST_DIRS, INGEST_SERVERS = 4096, 16, 4
# the serve_stablelm and train_stablelm phases: stablelm-3b, head dim 80
LM_ARCH, LM_TRAIN_STEPS = "stablelm-3b", 4
# decode attention's lengths in the serve runs: cache_pos + 1, 513 to 576
SERVE_LENGTHS = (PROMPT + 1, PROMPT + NEW)
# the serve_moe phase: deepseek-v2-lite-16b, MLA (kv_norm reads 512 of each
# 576-column row of its projection) and capacity-routed MoE
MOE_ARCH = "deepseek-v2-lite-16b"
# MLA's expanded (train) branch attends at q/k head dim 128 + 64 against v
# head dim 128, MHA over 16 heads; FLASH_TILE: the flash kernels' 64-row tile
MLA_DQK, MLA_DV, MLA_HEADS, FLASH_TILE = 192, 128, 16, 64
# the train_moe phase: the dense layer and 5 MoE layers of the 27 (~3.42 B
# params; fp32 moments, ~41 GB of state, fit one card), 8 steps
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 6, 8
MOE_TRAIN_CUT = ["n_layers 6 of 27: the dense layer + 5 MoE layers (the full model's "
                 "15.7 B params and their fp32 AdamW state, ~188 GB, do not fit 80 GB)"]
# the serve_v3 and train_v3 phases: deepseek-v3-671b (arXiv:2412.19437) at
# full width, 128 MLA heads at d 7168, q-LoRA 1536, 256 experts top-8 with
# the sigmoid router, MTP on.  serve_v3 keeps its first 4 of 61 layers (the 3
# dense ones and the first MoE layer); train_v3 its 3 dense layers, with the
# MTP layer that loss_fn runs on them
V3_ARCH, V3_HEADS = "deepseek-v3-671b", 128
V3_SERVE_LAYERS, V3_TRAIN_LAYERS, V3_TRAIN_STEPS = 4, 3, 8
V3_SERVE_CUT = ["n_layers 4 of 61: the 3 dense layers + the first MoE layer (15.7 B params "
                "with the embedding, head and MTP head, 31.4 GB in bf16; the full model's "
                "671 B do not fit 80 GB)"]
V3_TRAIN_CUT = ["n_layers 3 of 61: the 3 dense layers, + the MTP layer loss_fn runs (4.19 B "
                "params, ~50 GB with fp32 AdamW moments; one MoE layer alone holds ~11.5 B "
                "params, ~138 GB with its fp32 AdamW state)"]
# the serve_hybrid phase: jamba-1.5-large-398b (arXiv:2403.19887) at full
# width (d 8192, 64 heads over 8 kv heads at D 128, d_ff and expert width
# 24576, 256 SSD heads of P 64 at N 16, vocab 65536), cut to one of its 9
# period blocks (attention at index 4, seven Mamba layers, MoE on layers 1,
# 3, 5 and 7) and 8 of its 16 experts, top-2 kept
HYBRID_ARCH, HYBRID_SERVE_LAYERS, HYBRID_SERVE_EXPERTS = "jamba-1.5-large-398b", 8, 8
HYBRID_SERVE_CUT = ["n_layers 8 of 72: one of the 9 period blocks",
                    "n_experts 8 of 16 (top-2 kept): one block at 16 experts holds ~45 B "
                    "params, ~90 GB in bf16; at 8, ~25.8 B, ~51.6 GB"]
# train_hybrid and train_sharded_hybrid: `hybrid_small_config()` (one period
# block at d 128 with the full model's head dims), 8 steps of TRAIN_B x
# HYBRID_TRAIN_S (8 SSD chunks of SSD_CHUNK), bf16 moments (as the
# sweep's jamba cells): the unsharded run, then the same on a 1 x 1 mesh,
# bitwise; dryrun_hybrid traces its cell
HYBRID_TRAIN_STEPS, HYBRID_TRAIN_S = 8, 512
HYBRID_TRAIN_CUT = ["hybrid_small_config: one period block at d_model 128 (8 query heads over "
                    "1 kv head at D 128, SSD P 64 N 16, 8 experts top-2): one full-width "
                    "period block with 2 experts holds ~11.3 B params, ~90 GB with bf16 "
                    "AdamW moments, past one 80 GB card"]
# the last four families, each served at full width and full depth:
# command-r-35b (tied embeddings, vocab 256000, GQA 64 over 8), starcoder2-15b
# (GELU, QKV bias, GQA 48 over 4: rep 12), pixtral-12b (the vit stub frontend,
# RMSNorm at d 5120, GQA 32 over 8: rep 4) and musicgen-large (the encodec
# stub frontend, sinusoidal positions, MHA at D 64); each serve run's seed of
# its prompts
DENSE_SERVES = (("serve_command_r", "command-r-35b", SEED + 40),
                ("serve_starcoder2", "starcoder2-15b", SEED + 41),
                ("serve_pixtral", "pixtral-12b", SEED + 42),
                ("serve_musicgen", "musicgen-large", SEED + 43))
# train_musicgen: musicgen-large at full width (48 layers, 2.42 B params,
# ~29 GB with fp32 AdamW moments), nothing cut, 8 steps
MG_ARCH, MG_TRAIN_STEPS = "musicgen-large", 8
# train_command_r: command-r-35b at full width cut to 2 of its 40 layers, so
# that the CE at vocab 256000 and the tied table's two gradient paths (the
# gather and the head) run in a real step; fp32 moments (3.51 B params, ~42
# GB of state; AdamW updates the 2.1 B-element table in blocks)
CR_ARCH, CR_TRAIN_LAYERS, CR_TRAIN_STEPS = "command-r-35b", 2, 8
CR_TRAIN_CUT = ["n_layers 2 of 40 (the full model's 30.3 B params hold 60.6 GB in bf16 alone)"]
# train_check_starcoder2: reduced starcoder2-15b with 12 query heads over 1 kv
# head at D 128 (rep 12, as 48 over 4 at full width)
SC_ARCH = "starcoder2-15b"
# train_sharded: the train phase's chatglm3-6b run again with its state on a
# 1 x 1 (data, model) DeviceMesh over NCCL (world 1): each loss within
# TOL_SHARDED_LOSS (relative) of the train phase's, each param leaf after the
# last step within TOL_SHARDED_PARAM (relative L2) of the train phase's
TOL_SHARDED_LOSS, TOL_SHARDED_PARAM = 1e-5, 1e-3
# train_sharded_ssm and train_sharded_moe: the peak device memory within
# TOL_SHARDED_PEAK (relative) of the unsharded run's (the same device work)
TOL_SHARDED_PEAK = 0.01
# train_sharded_resume: train_sharded_ssm's run stopped after step
# SHARDED_RESUME_STOP, saved sharded (async), restored into a fresh sharded
# state and resumed; everything bitwise, the peak within TOL_SHARDED_PEAK of
# train_sharded_ssm's plus the largest leaf's bytes
SHARDED_RESUME_STOP = 4
# serve_sharded: the serve phase's chatglm3-6b run again with its params and
# cache on the same 1 x 1 mesh: the same tokens, the last step's logits
# bitwise or within TOL_SHARDED_LOGITS (max |diff| over max |logit|)
TOL_SHARDED_LOGITS = 1e-5
# dryrun: the 1 x 1 train cell's traced peak within TOL_DRYRUN_PEAK
# (relative) of the train phase's max_memory_allocated(), its FLOPs within
# TOL_DRYRUN_FLOPS of `dense_train_flops`
TOL_DRYRUN_PEAK, TOL_DRYRUN_FLOPS = 0.10, 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def excess(got, want, tol: float) -> float:
    """max(|got - want| - tol - tol*|want|); > 0 means out of tolerance."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - tol - tol * w.abs()).max())


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one fn() in ms: CUDA events around each launch,
    the L2 cache flushed before each.  A sleep kernel first holds the device
    while the host queues every launch, so host overhead between the events
    is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms of device time
    events = []
    for _ in range(reps):
        flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def warm_cublas(dev) -> int:
    """One product and its backward in fp32 and in bf16, so that this
    thread's and autograd's cuBLAS workspaces are held from here on; the
    bytes that this left allocated (0 once an earlier phase ran both)."""
    before = torch.cuda.memory_allocated(dev)
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.ones(64, 64, device=dev, dtype=dtype, requires_grad=True)
        (w @ w).sum().backward()
    del w
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev) - before


def grad_fn(out, inputs, grad):
    """A callable that runs the backward of `out` (built once) again."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def bf16_normal(rng, dev):
    """randn(*shape, scale=1.0): N(0, scale^2) draws of `rng`, bf16 on `dev`."""
    def randn(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(dev, torch.bfloat16)
    return randn


def flash_bwd_inputs(randn, b, s, h, hkv, d):
    """q, k, v and dO of one layer's attention gradient: [B, H, S, D] views
    of [B, S, H, D] tensors, as the model passes them."""
    q = randn(b, s, h, d).transpose(1, 2)
    k, v = randn(b, s, hkv, d).transpose(1, 2), randn(b, s, hkv, d).transpose(1, 2)
    return q, k, v, randn(b, s, h, d).transpose(1, 2)


def sdpa_backward(q, k, v, do):
    """A callable that runs SDPA's backward of causal attention (dq, dk, dv),
    the GQA group expanded to one kv head per query head."""
    rep = q.shape[1] // k.shape[1]
    qe = q.detach().requires_grad_(True)
    ke, ve = (t.repeat_interleave(rep, dim=1).detach().requires_grad_(True) for t in (k, v))
    return grad_fn(F.scaled_dot_product_attention(qe, ke, ve, is_causal=True),
                   (qe, ke, ve), do)


def mla_flash_inputs(randn, b, s, h=MLA_HEADS):
    """q, k [B, H, S, 192] and v, dO [B, H, S, 128] bf16: [B, H, S, D] views
    of [B, S, H, D] tensors, as MLA's expanded branch passes them (MHA)."""
    q, k = (randn(b, s, h, MLA_DQK).transpose(1, 2) for _ in range(2))
    v, do = (randn(b, s, h, MLA_DV).transpose(1, 2) for _ in range(2))
    return q, k, v, do


def mla_flash_check(q, k, v, do) -> dict:
    """The three flash passes at q/k head dim 192 and v head dim 128 (causal,
    q_offset 0), each against its plain version on the same inputs: the
    excess over TOL_BF16 (TOL_LSE for lse and delta; > 0 fails), the largest
    |error|, and whether two more launches repeat its bits.  chip_smoke's
    kernel rows and tests/test_torch_cuda.py hold the passes by this one
    rule."""
    from repro_torch.kernels import (flash_attention_bwd_dkv, flash_attention_bwd_dq,
                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention import (attention_bwd_dkv_ref,
                                                     attention_bwd_dq_ref,
                                                     attention_with_lse_ref)
    out, lse = flash_attention_fwd(q, k, v)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    ref, rlse = attention_with_lse_ref(q, k, v, q_offset=0)
    rq, rdelta = attention_bwd_dq_ref(q, k, v, out, do, lse, q_offset=0)
    rk, rv = attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, q_offset=0)
    torch.cuda.synchronize()
    shapes_ok = (out.shape == q.shape[:3] + v.shape[3:] and dq.shape == q.shape
                 and dk.shape == k.shape and dv.shape == v.shape)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())
    repeat = {"fwd": True, "dq": True, "dkv": True}
    for _ in range(2):
        o2, l2 = flash_attention_fwd(q, k, v)
        q2, d2 = flash_attention_bwd_dq(q, k, v, out, do, lse)
        k2, v2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        repeat["fwd"] &= torch.equal(o2, out) and torch.equal(l2, lse)
        repeat["dq"] &= torch.equal(q2, dq) and torch.equal(d2, delta)
        repeat["dkv"] &= torch.equal(k2, dk) and torch.equal(v2, dv)
    return {"shapes_ok": bool(shapes_ok),
            "excess": {"fwd": max(excess(out, ref, TOL_BF16), excess(lse, rlse, TOL_LSE)),
                       "dq": max(excess(dq, rq, TOL_BF16), excess(delta, rdelta, TOL_LSE)),
                       "dkv": max(excess(dk, rk, TOL_BF16), excess(dv, rv, TOL_BF16))},
            "max_abs_err": {"fwd": err(out, ref), "dq": err(dq, rq),
                            "dkv": max(err(dk, rk), err(dv, rv))},
            "bitwise_repeatable": repeat}


def rmsnorm_check(x, sc) -> dict:
    """The RMSNorm forward against its plain version on the same inputs:
    the excess over TOL_RMSNORM (> 0 fails) and the largest |error|."""
    from repro_torch.kernels import rmsnorm, rmsnorm_ref
    out, ref = rmsnorm(x, sc), rmsnorm_ref(x, sc)
    torch.cuda.synchronize()
    return {"excess": excess(out, ref, TOL_RMSNORM),
            "max_abs_err": float((out.float() - ref.float()).abs().max())}


def rmsnorm_bwd_check(x, sc, dy) -> dict:
    """The RMSNorm backward against its plain version on the same inputs:
    the excess of dx over TOL_BF16 and of dscale over TOL_DSCALE x its
    largest |value| (> 0 fails), the largest errors, and whether two more
    launches repeat its bits.  chip_smoke's nested rows and
    tests/test_torch_cuda.py hold the kernel by this one rule."""
    from repro_torch.kernels import rmsnorm_bwd, rmsnorm_bwd_ref
    (dx, ds), (rdx, rds) = rmsnorm_bwd(x, sc, dy), rmsnorm_bwd_ref(x, sc, dy)
    repeat = True
    for _ in range(2):
        dx2, ds2 = rmsnorm_bwd(x, sc, dy)
        repeat &= torch.equal(dx2, dx) and torch.equal(ds2, ds)
    torch.cuda.synchronize()
    ds_err = float((ds.float() - rds.float()).abs().max())
    return {"excess": max(excess(dx, rdx, TOL_BF16),
                          ds_err - TOL_DSCALE * float(rds.float().abs().max())),
            "max_abs_err": float((dx.float() - rdx.float()).abs().max()),
            "dscale_max_abs_err": ds_err, "bitwise_repeatable": bool(repeat)}


def ce_check(logits, labels, mask, g) -> dict:
    """The fused CE forward (nll and lse at TOL_CE) and backward (dlogits at
    TOL_BF16) against their plain versions on the same inputs: the excess
    of each (> 0 fails) and the largest errors.  chip_smoke's nested rows
    and tests/test_torch_cuda.py hold the kernels by this one rule."""
    from repro_torch.kernels import fused_ce, fused_ce_bwd
    from repro_torch.kernels.cross_entropy import ce_bwd_ref, ce_rows_ref
    (nll, lse), (rn, rl) = fused_ce(logits, labels, mask), ce_rows_ref(logits, labels, mask)
    dl, rdl = fused_ce_bwd(logits, labels, mask, lse, g), ce_bwd_ref(logits, labels, mask, rl, g)
    torch.cuda.synchronize()
    return {"excess": {"fwd": max(excess(nll, rn, TOL_CE), excess(lse, rl, TOL_CE)),
                       "bwd": excess(dl, rdl, TOL_BF16)},
            "max_abs_err": {"nll": float((nll - rn).abs().max()),
                            "lse": float((lse - rl).abs().max()),
                            "dlogits": float((dl.float() - rdl.float()).abs().max())}}


def ce_inputs(rng, dev, rows, vocab) -> tuple:
    """A CE chunk's logits [rows, vocab] bf16 ~ N(0, 4), labels, a mask with
    ~10 % of rows off and an all-ones gradient, from `rng`."""
    logits = bf16_normal(rng, dev)(rows, vocab, scale=2.0)
    labels = torch.from_numpy(rng.integers(0, vocab, rows)).to(dev)
    mask = torch.from_numpy((rng.random(rows) > 0.1).astype(np.float32)).to(dev)
    return logits, labels, mask, torch.ones(rows, device=dev)


def mla_flash_work(b, s, h=MLA_HEADS) -> dict:
    """(bytes, operations) of each flash pass at <192, 128>, causal, by the
    causal pairs P = B H S (S + 1) / 2: forward 2 P (192 + 128), dq 2 P
    (2 x 192 + 128), dk/dv 2 P (2 x 192 + 2 x 128); bytes each input read
    once, each output written once (q, k, dq, dk 192 columns; v, out, dO, dv
    128; lse, delta fp32)."""
    rows, pairs = b * h * s, b * h * s * (s + 1) // 2
    dqk, dv = MLA_DQK, MLA_DV
    return {"fwd": (rows * ((2 * dqk + 2 * dv) * 2 + 4), 2 * pairs * (dqk + dv)),
            "dq": (rows * ((3 * dqk + 3 * dv) * 2 + 8), 2 * pairs * (2 * dqk + dv)),
            "dkv": (rows * ((3 * dqk + 3 * dv) * 2 + 8), 2 * pairs * (2 * dqk + 2 * dv))}


def sdpa_any_backend(q, k, v, do):
    """(backend name, forward callable, backward callable) of causal SDPA on
    q, k, v whose head dims may differ (v's from q's): the first of PyTorch's
    flash, cuDNN, memory-efficient and math backends that takes the inputs,
    probed by a forward and backward under `sdpa_kernel`.  A yardstick for
    the kernel rows only; the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        try:        # a backend that does not take these shapes raises
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        except RuntimeError:
            continue

        def fwd(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return backend.name, fwd, grad_fn(out, leaves, do)
    raise AssertionError("no SDPA backend takes these inputs")


def ssd_inputs(randn, rng, dev, batch, s, h, p, n, h0_scale):
    """The SSD scan's inputs as mamba2 passes them: x, B and C bf16 slices of
    one conv output [batch, s, h p + 2 n], dt = softplus(N(0, 1)) fp32,
    a_log = log(linspace(1, 16)) and h0 ~ N(0, h0_scale^2) fp32."""
    di = h * p
    buf = randn(batch, s, di + 2 * n)
    dt = F.softplus(torch.from_numpy(rng.standard_normal((batch, s, h), dtype=np.float32)).to(dev))
    h0 = torch.from_numpy(rng.standard_normal((batch, h, p, n), dtype=np.float32)
                          * h0_scale).to(dev)
    return (buf[..., :di].reshape(batch, s, h, p), dt,
            torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
            buf[..., di:di + n], buf[..., di + n:]), h0


def ssd_scan_f64(x, dt, a_log, B, C, h0):
    """The SSD scan as its recurrence, one row at a time in fp64:
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t, A = -exp(a_log).
    The reference both the kernel and the chunked plain version are measured
    against; it shares no code with either."""
    a = -torch.exp(a_log.double())
    dt = dt.double()
    decay = torch.exp(dt * a)                                   # [b, s, h]
    xdt = x.double() * dt[..., None]                            # [b, s, h, p]
    Bd, Cd = B.double(), C.double()
    hc = h0.double().clone()
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for t in range(x.shape[1]):
        hc.mul_(decay[:, t, :, None, None]).add_(xdt[:, t, :, :, None] * Bd[:, t, None, None, :])
        y[:, t] = (hc @ Cd[:, t, None, :, None])[..., 0]
    return y, hc


def rel_l2(got, want) -> float:
    """||got - want||_2 / ||want||_2, in fp64."""
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want))


def ssd_rel_errors(args, h0, outs) -> dict:
    """The relative L2 error of y and of the final state of each named
    output pair in `outs` against `ssd_scan_f64` on the same inputs."""
    y64, h64 = ssd_scan_f64(*args, h0=h0)
    return {name: {"y": rel_l2(y, y64), "h_final": rel_l2(hf, h64)}
            for name, (y, hf) in outs.items()}


def ssd_grads_f64(scan_ref, args, h0, dy, dh_final, chunk=256):
    """The SSD scan's gradients (x, dt, a_log, B, C and h0 when given) by
    fp64 autograd of its plain version `scan_ref` at `chunk`: an oracle
    that shares no code with the backward kernel or its plain version."""
    leaves = [t.detach().double().requires_grad_(True) for t in args]
    h0l = None if h0 is None else h0.detach().double().requires_grad_(True)
    y, hf = scan_ref(*leaves, chunk=chunk, h0=h0l)
    loss = (y * dy.double()).sum()
    if dh_final is not None:
        loss = loss + (hf * dh_final.double()).sum()
    return torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))


def ssd_fwd_work(b, s, h, p, n, chunk=SSD_CHUNK) -> tuple:
    """(bytes, tensor-core operations) of the SSD scan's forward
    (`repro_torch.kernels.ssd_scan.kernel.fwd_work`, which the dry run's
    abstract path counts too)."""
    from repro_torch.kernels.ssd_scan.kernel import fwd_work
    return fwd_work(b, s, h, p, n, chunk)


def ssd_bwd_work(b, s, h, p, n, chunk=SSD_CHUNK) -> tuple:
    """(bytes, tensor-core operations, fp32 operations) the SSD scan's
    backward needs (`repro_torch.kernels.ssd_scan.kernel.bwd_work`)."""
    from repro_torch.kernels.ssd_scan.kernel import bwd_work
    return bwd_work(b, s, h, p, n, chunk)


def mla_moe_serve_bound(cfg, params, batch, prompt) -> dict:
    """The least time of an MLA + MoE model's serve steps as the port
    computes them.  Prefill of batch x prompt tokens: the bf16 products
    (MLA projections, every expert at its capacity, the shared experts, the
    dense prefix layers, the head on the last token) over the bf16 peak plus
    the fp32 ones (the absorbed attention over every (row, column) of the
    prompt's cache rows, the router) over the fp32 peak, the two run one
    after the other; or the weight bytes over the memory rate, if larger.
    A decode step runs every expert (capacity >= 1), so it reads every
    weight but the token-embedding table: bytes over the memory rate."""
    m, mo = cfg.mla, cfg.moe
    h, d, t = cfg.n_heads, cfg.d_model, batch * prompt
    qk, r = m.qk_nope_dim + m.qk_rope_dim, m.kv_lora_rank
    ff = mo.d_expert_ff or cfg.d_ff
    cap = int(max(1, math.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor)))
    q_proj = (d * m.q_lora_rank + m.q_lora_rank * h * qk) if m.q_lora_rank else d * h * qk
    proj = 2 * t * (q_proj + d * (r + m.qk_rope_dim) + h * m.v_head_dim * d)
    attn = 2 * batch * h * prompt * (m.qk_nope_dim * r + prompt * (2 * r + m.qk_rope_dim)
                                     + r * m.v_head_dim)
    n_prefix = mo.n_dense_prefix
    n_moe = cfg.n_layers - n_prefix
    bf16 = (cfg.n_layers * proj + n_moe * 6 * d * ff * (mo.n_experts * cap + t * mo.n_shared)
            + n_prefix * 6 * t * d * cfg.d_ff + 2 * batch * d * cfg.vocab_size)
    f32 = cfg.n_layers * attn + n_moe * 2 * t * d * mo.n_experts
    from repro_torch.tree import tree_leaves

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    weights = nbytes(params)
    # a serve step reads neither the token-embedding table (a gather) nor the
    # MTP head (deepseek-v3's, which only the training loss runs)
    read = weights - nbytes(params["embed"]["tok"]) - nbytes(params.get("mtp", {}))
    ops_ms = (bf16 / PEAK_BF16 + f32 / PEAK_F32) * 1e3
    return {"prefill_capacity": cap, "prefill_tflop_bf16": bf16 / 1e12,
            "prefill_tflop_fp32": f32 / 1e12, "weights_gb": weights / 1e9,
            "weights_read_gb": read / 1e9,
            "prefill_bound_ms": max(ops_ms, read / PEAK_BYTES * 1e3),
            "prefill_bound_by": "operations" if ops_ms >= read / PEAK_BYTES * 1e3 else "bytes",
            "decode_step_bound_ms": read / PEAK_BYTES * 1e3, "decode_bound_by": "bytes"}


class RouteRecorder:
    """While installed (`with`), stands in for `layers.moe_route`: records
    each call's top_idx ("idx"), the gap between the k-th and (k+1)-th
    largest selection scores of each token ("gap") and the call's own
    selection ("own"); with `pin` set (one top_idx a call) it selects those
    experts instead ("idx"), weighted by the call's own scores as
    `moe_route` weighs them."""

    def __init__(self, layers):
        self.layers, self.real = layers, layers.moe_route
        self.calls, self.pin = [], None

    def __enter__(self):
        self.layers.moe_route = self
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.real

    def __call__(self, p, xt, cfg):
        scores, top_idx, top_w = self.real(p, xt, cfg)
        own = top_idx.cpu()
        mo = cfg.moe
        sel = scores + p["router_bias"] if mo.router == "sigmoid" else scores
        if self.pin is not None:
            top_idx = self.pin[len(self.calls)].to(top_idx.device)
            top_w = torch.gather(scores, 1, top_idx)
            if mo.router == "sigmoid":
                top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
            top_w = top_w * mo.router_scale
        top = torch.sort(sel.float(), dim=-1, descending=True).values
        self.calls.append({"idx": top_idx.cpu(), "own": own,
                           "gap": (top[:, mo.top_k - 1] - top[:, mo.top_k]).detach().cpu()})
        return scores, top_idx, top_w

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def route_flips(a_calls, b_calls, rows_a=None) -> list:
    """The tokens whose experts differ between two recorded runs, call by
    call (MoE layer by layer), with the gap of each side; `rows_a` picks the
    tokens of the first run that the second run's tokens are."""
    out = []
    for layer, (a, b) in enumerate(zip(a_calls, b_calls)):
        ia, ga = ((a["idx"], a["gap"]) if rows_a is None
                  else (a["idx"][rows_a], a["gap"][rows_a]))
        for tok in range(ia.shape[0]):
            if set(ia[tok].tolist()) != set(b["idx"][tok].tolist()):
                out.append({"layer": layer, "token": tok,
                            "experts_a": sorted(ia[tok].tolist()),
                            "experts_b": sorted(b["idx"][tok].tolist()),
                            "gap_a": float(ga[tok]), "gap_b": float(b["gap"][tok])})
    return out


def wide_flips(flips, near_tie=NEAR_TIE) -> list:
    """The flips of `route_flips` that are not near-ties: a gap of either
    side at or above `near_tie`.  A routing fault, not rounding, moves such
    a token to other experts."""
    return [f for f in flips if max(f["gap_a"], f["gap_b"]) >= near_tie]


def moe_cross_check(srv, prompts, dev, cache_len) -> dict:
    """cross_check for an MoE model: the last logits of a prefill of every
    prompt token against a prefill of all but the last plus one decode step.

    Every expert gets room for every route (capacity_factor n_experts /
    top_k, as tests/test_arch_smoke.py gives the JAX model for the same
    equivalence): at the served 1.25 a 4-token decode step has capacity
    ceil(4 * 6 / 64 * 1.25) = 1 and drops routes by design.  Even so the
    decode step's hidden states differ from the prefill's by rounding, and a
    token whose k-th and (k+1)-th selection scores nearly tie may take the
    other expert: such a flip moves the logits by that expert's whole share.
    So the decode step runs twice from the prefill's cache (from a copy of
    it the second time: a step advances a Mamba layer's states in place):
    as served ("unpinned"), and with each MoE layer's selection pinned to
    the prefill's for the same token ("pinned", its own scores as weights),
    which leaves every difference but the flips.  Both are returned, with
    the flips and their gaps."""
    from repro_torch.models import init_cache, layers
    from repro_torch.runtime.steps import prefill_step, serve_step
    from repro_torch.tree import tree_map

    mo = srv.cfg.moe
    cfg = replace(srv.cfg, moe=replace(mo, capacity_factor=mo.n_experts / mo.top_k))
    b, s = prompts.shape[0], prompts.shape[1] - 1
    last = torch.arange(b) * (s + 1) + s                   # the last token's rows
    with torch.inference_mode(), RouteRecorder(layers) as rec:
        toks = torch.from_numpy(prompts).long().to(dev)
        full, _ = prefill_step(srv.params, init_cache(cfg, b, cache_len, dev),
                               {"tokens": toks}, cfg)
        r_full = rec.take()
        cache = init_cache(cfg, b, cache_len, dev)
        prefill_step(srv.params, cache, {"tokens": toks[:, :s]}, cfg)
        rec.take()
        # the step updates the cache in place (a Mamba layer's states advance):
        # the pinned run starts from a copy of the prefill's
        again = tree_map(torch.clone, cache)
        step, _ = serve_step(srv.params, cache, {"tokens": toks[:, s:]}, s, cfg)
        r_step = rec.take()
        rec.pin = [c["idx"][last] for c in r_full]
        pinned, _ = serve_step(srv.params, again, {"tokens": toks[:, s:]}, s, cfg)
        rec.pin = None
        torch.cuda.synchronize()
    scale = float(full.abs().max())
    flips = route_flips(r_full, r_step, rows_a=last)
    return {"arch": cfg.name, "prompt": s, "capacity_factor": cfg.moe.capacity_factor,
            "finite": bool(torch.isfinite(full).all() and torch.isfinite(step).all()
                           and torch.isfinite(pinned).all()),
            "unpinned": {"max_abs_err": float((step - full).abs().max()), "logit_absmax": scale,
                         "rel_err": float((step - full).abs().max()) / scale},
            "pinned": {"max_abs_err": float((pinned - full).abs().max()), "logit_absmax": scale,
                       "rel_err": float((pinned - full).abs().max()) / scale},
            "tol": TOL_CROSS, "gated": "pinned",
            "routes": len(r_full) * b, "route_flips": len(flips),
            "largest_flip_gap": max([max(f["gap_a"], f["gap_b"]) for f in flips], default=None),
            "near_tie": NEAR_TIE, "wide_flips": len(wide_flips(flips)), "flips": flips,
            "note": "capacity_factor n_experts / top_k: at the served factor a 4-token decode "
                    "step has capacity 1 and drops routes by design; the gate holds the decode "
                    "step with each layer's selection pinned to the prefill's, since a "
                    "near-tie flip moves the logits by a whole expert's share"}


def model_flops(cfg, n_params, batch, seq, chunk=SSD_CHUNK) -> float:
    """Model FLOPs of one train step (forward and backward, no recompute):
    6 x the parameters a token's products read x tokens, plus the
    sequence mixing.  Dense: every parameter but an untied token-embedding
    table (a gather; a tied one is the head's matrix), plus causal attention at 4 D flops per unmasked (row,
    column) pair forward, 3x with the backward.  ssm (tied embeddings, so
    the table is the head's matrix and counts): the SSD products as
    `ssd_chunked` runs them at `chunk`-row chunks, per (batch, chunk) C B^T
    (L L N) and per head att (x dt) (L L P), the chunk state and the
    inter-chunk output (L N P each), 3x with the backward.  hybrid: every
    parameter a token reads (top_k experts of each MoE layer, not the
    table), the SSD products of its Mamba layers and the causal attention of
    its attention layers, as above."""
    tokens = batch * seq
    if cfg.family == "moe":
        return moe_model_flops(cfg, batch, seq)
    if cfg.family == "hybrid":
        # the top_k of each MoE layer's experts, not the table (a gather);
        # the SSD products of each Mamba layer as the ssm family's, causal
        # attention in each block's one attention layer
        mo, p, n = cfg.moe, cfg.ssm.head_dim, cfg.ssm.d_state
        idle = moe_layer_count(cfg) * (mo.n_experts - mo.top_k) * 3 * cfg.d_model * (
            mo.d_expert_ff or cfg.d_ff)
        h = cfg.ssm.expand * cfg.d_model // p
        nc = -(-seq // chunk)
        macs = batch * nc * (chunk * chunk * n + h * (chunk * chunk * p + 2 * chunk * n * p))
        nb = cfg.n_layers // cfg.hybrid.period
        pairs = batch * cfg.n_heads * seq * (seq + 1) // 2
        return (6 * (n_params - idle - cfg.vocab_size * cfg.d_model) * tokens
                + 3 * 2 * macs * nb * (cfg.hybrid.period - 1) + 12 * cfg.head_dim * pairs * nb)
    if cfg.family == "ssm":
        p, n = cfg.ssm.head_dim, cfg.ssm.d_state
        h = cfg.ssm.expand * cfg.d_model // p
        nc = -(-seq // chunk)
        macs = batch * nc * (chunk * chunk * n + h * (chunk * chunk * p + 2 * chunk * n * p))
        return 6 * n_params * tokens + 3 * 2 * macs * cfg.n_layers
    pairs = batch * cfg.n_heads * seq * (seq + 1) // 2
    gather = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return 6 * (n_params - gather) * tokens + 12 * cfg.head_dim * pairs * cfg.n_layers


def moe_model_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one train step of an MLA + MoE model (forward and
    backward, no recompute): 6 x the params a token's products read x
    tokens, plus causal attention.  A token reads, in every layer, MLA's
    projections (wq, or q-LoRA's wq_a and wq_b; wkv_a, wk_b, wv_b, wo), and
    in the dense prefix layers the dense FFN, in the MoE layers the router,
    top_k routed experts and the shared experts; then the untied head; not
    the embedding table (a gather) nor the norms.  Attention: 2 (q/k head
    dim + v head dim) per unmasked (row, column) pair a head forward, 3x
    with the backward.  With an MTP head (deepseek-v3) one more dense layer
    (MLA, the dense FFN, its attention) over every token, and the head
    again over the B (S - 1) tokens of its loss."""
    m, mo, d, h = cfg.mla, cfg.moe, cfg.d_model, cfg.n_heads
    qk, ff = m.qk_nope_dim + m.qk_rope_dim, mo.d_expert_ff or cfg.d_ff
    q_proj = (d * m.q_lora_rank + m.q_lora_rank * h * qk) if m.q_lora_rank else d * h * qk
    mla = (q_proj + d * (m.kv_lora_rank + m.qk_rope_dim)
           + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim) + h * m.v_head_dim * d)
    n_prefix = min(mo.n_dense_prefix, cfg.n_layers)
    n_moe = cfg.n_layers - n_prefix
    n_dense = n_prefix + int(cfg.mtp)
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    active = ((cfg.n_layers + int(cfg.mtp)) * mla + n_dense * 3 * d * cfg.d_ff
              + n_moe * (d * mo.n_experts + 3 * d * ff * (mo.top_k + mo.n_shared)) + head)
    pairs = batch * h * seq * (seq + 1) // 2
    mtp_head = 6 * head * batch * (seq - 1) if cfg.mtp else 0
    return (6 * active * batch * seq + mtp_head
            + 3 * 2 * (qk + m.v_head_dim) * pairs * (cfg.n_layers + int(cfg.mtp)))


def leaf_names(tree, prefix=""):
    """Dotted names of a param tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grad_rel_errors(got, want, names):
    """(relative error of the loss, relative L2 error of all gradients taken
    together, {leaf: relative L2 error}) of [loss, *grads] lists."""
    (loss_g, *g_g), (loss_w, *g_w) = got, want
    return (float((loss_g - loss_w).abs() / loss_w.abs()),
            float(torch.cat([(a - b).flatten() for a, b in zip(g_g, g_w)]).norm()
                  / torch.cat([b.flatten() for b in g_w]).norm()),
            {nm: float((a - b).norm() / max(float(b.norm()), 1e-12))
             for nm, a, b in zip(names, g_g, g_w)})


def moe_small_config():
    """Reduced deepseek-v2-lite-16b (4 layers, the first dense, d 128, 4
    heads, 8 experts top-2) with MLA at the full model's head dims (qk_nope
    128, qk_rope 64, v 128; kv_lora 64), so its attention runs the flash
    kernels' <192, 128> instances."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    return get_config(MOE_ARCH).reduced(mla=MLAConfig(
        kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))


def v3_small_config():
    """Reduced deepseek-v3-671b (4 layers: the 3 dense ones and 1 MoE layer
    with the sigmoid router, 8 experts top-2; d 128, 4 heads; the MTP head)
    with MLA at the full model's head dims (qk_nope 128, qk_rope 64, v 128;
    kv_lora 64) and q-LoRA at its full rank 1536, so its attention runs the
    flash kernels' <192, 128> instances and q_norm's backward runs at D 1536."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    return get_config(V3_ARCH).reduced(mla=MLAConfig(
        kv_lora_rank=64, q_lora_rank=1536, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))


def hybrid_small_config():
    """Reduced jamba-1.5-large-398b (one period block of 8 layers, d 128, 8
    experts top-2) with the full model's head dims: 8 query heads over 1 kv
    head at D 128 (GQA rep 8, as 64 over 8 at full width) and the full
    model's SSM (P 64, N 16), so its attention runs the flash kernels' D 128
    instances at rep 8 and its Mamba layers the SSD kernels' P 64, N 16
    ones."""
    from repro_torch.configs import get_config
    full = get_config(HYBRID_ARCH)
    return full.reduced(n_heads=8, n_kv_heads=1, d_head=128, ssm=full.ssm)


def hybrid_serve_config():
    """serve_hybrid's config: the full model cut to HYBRID_SERVE_LAYERS layers
    and HYBRID_SERVE_EXPERTS experts, every width kept."""
    from repro_torch.configs import get_config
    full = get_config(HYBRID_ARCH)
    return replace(full, n_layers=HYBRID_SERVE_LAYERS,
                   moe=replace(full.moe, n_experts=HYBRID_SERVE_EXPERTS))


def moe_layer_count(cfg) -> int:
    """The MoE layers of a model: each hybrid period block's (every
    moe_every-th layer from 1), or the layers after an MoE model's dense
    prefix; 0 without MoE."""
    if cfg.moe is None:
        return 0
    if cfg.hybrid is not None:
        hy = cfg.hybrid
        return cfg.n_layers // hy.period * len(range(1, hy.period, hy.moe_every))
    return cfg.n_layers - cfg.moe.n_dense_prefix


def hybrid_serve_launches(cfg) -> dict:
    """Kernel launches of a serve run (a prefill and NEW decode steps) of a
    hybrid model: per forward every layer's mixer_norm and ffn_norm, each
    Mamba layer's gated out_norm, and final_norm; the prefill's attention
    through the flash forward and its Mamba layers through the SSD scan;
    each decode step's attention through decode attention (its Mamba layers
    run the plain recurrence, as JAX's decode)."""
    hy = cfg.hybrid
    nb = cfg.n_layers // hy.period
    norms = nb * (2 * hy.period + hy.period - 1) + 1
    return {"rmsnorm": norms * (1 + NEW), "flash_attention_fwd": nb,
            "ssd_scan": nb * (hy.period - 1), "decode_attention": nb * NEW}


def hybrid_train_launches(cfg) -> dict:
    """Kernel launches of one train step of a hybrid model (each period block
    checkpointed whole, CE_CHUNKS cross-entropy chunks): each block's norms
    (mixer_norm and ffn_norm a layer, the Mamba layers' gated out_norm)
    forward twice (the recompute) and backward once, final_norm once each
    way; the attention layer's flash forward twice, dq and dk/dv once; each
    Mamba layer's SSD scan twice and its backward once; the CE forward twice
    and its backward once a chunk."""
    hy = cfg.hybrid
    nb = cfg.n_layers // hy.period
    norms = nb * (2 * hy.period + hy.period - 1)
    return {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "flash_attention_fwd": 2 * nb, "flash_attention_bwd_dq": nb,
            "flash_attention_bwd_dkv": nb, "ssd_scan": 2 * nb * (hy.period - 1),
            "ssd_scan_bwd": nb * (hy.period - 1), "fused_ce": 2 * CE_CHUNKS,
            "fused_ce_bwd": CE_CHUNKS}


def hybrid_serve_bound(cfg, params, batch, prompt) -> dict:
    """The least time of a hybrid model's serve steps as the port computes
    them.  Prefill of batch x prompt tokens: the bf16 products (the Mamba
    layers' in_proj and out_proj, the attention projections and its causal
    pairs at 4 D flops a pair a head, the dense FFNs, every expert at its
    capacity, the head on the last token, the SSD scan's chunked products
    at 64-row chunks: C B^T a (batch, chunk), att x and the state in and out
    a head) over the bf16 peak plus the fp32 router over the fp32 peak, one
    after the other; or the weight bytes over the memory rate, if larger.
    A decode step runs every expert (capacity >= 1), so it reads every
    weight but the token-embedding table.  The active-param count (a token's
    top_k experts, not the capacity) is given beside it."""
    from repro_torch.tree import tree_leaves
    hy, mo, ss = cfg.hybrid, cfg.moe, cfg.ssm
    d, h, hkv, dh, t = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, batch * prompt
    nb = cfg.n_layers // hy.period
    di = ss.expand * d
    hs, n, pp = di // ss.head_dim, ss.d_state, ss.head_dim
    in_dim = 2 * di + 2 * ss.n_groups * n + hs
    n_moe = len(range(1, hy.period, hy.moe_every))
    ff = mo.d_expert_ff or cfg.d_ff
    cap = int(max(1, math.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor)))
    nc, L = -(-prompt // SSD_CHUNK), SSD_CHUNK
    ssd = 2 * batch * nc * (L * L * n + hs * (L * L * pp + 2 * L * n * pp))
    pairs = batch * h * prompt * (prompt + 1) // 2
    mamba = 2 * t * (d * in_dim + di * d) + ssd
    attn = 2 * t * d * dh * (2 * h + 2 * hkv) + 4 * dh * pairs
    dense = 2 * t * 3 * d * cfg.d_ff
    experts = 2 * mo.n_experts * cap * 3 * d * ff
    bf16 = (nb * ((hy.period - 1) * mamba + attn + (hy.period - n_moe) * dense
                  + n_moe * experts) + 2 * batch * d * cfg.vocab_size)
    f32 = nb * n_moe * 2 * t * d * mo.n_experts
    total = sum(x.numel() for x in tree_leaves(params))
    active = total - nb * n_moe * (mo.n_experts - mo.top_k) * 3 * d * ff

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    weights = nbytes(params)
    read = weights - nbytes(params["embed"]["tok"])
    ops_ms = (bf16 / PEAK_BF16 + f32 / PEAK_F32) * 1e3
    return {"prefill_capacity": cap, "prefill_tflop_bf16": bf16 / 1e12,
            "prefill_tflop_fp32": f32 / 1e12, "params": total,
            "active_params": active,
            "prefill_tflop_active_params": 2 * t * active / 1e12,
            "weights_gb": weights / 1e9, "weights_read_gb": read / 1e9,
            "prefill_bound_ms": max(ops_ms, read / PEAK_BYTES * 1e3),
            "prefill_bound_by": "operations" if ops_ms >= read / PEAK_BYTES * 1e3 else "bytes",
            "decode_step_bound_ms": read / PEAK_BYTES * 1e3, "decode_bound_by": "bytes"}


def dense_prefill_launches(cfg) -> dict:
    """Kernel launches of one prefill of a dense model: its attention
    through the flash forward a layer; with RMS norms (not LayerNorm, which
    stays plain torch as JAX computes it in jnp) attn_norm and ffn_norm a
    layer and final_norm."""
    out = {"flash_attention_fwd": cfg.n_layers}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = 2 * cfg.n_layers + 1
    return out


def dense_decode_launches(cfg) -> dict:
    """Kernel launches of one decode step of a dense model: decode attention
    a layer, and the norms as a prefill's."""
    out = {"decode_attention": cfg.n_layers}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = 2 * cfg.n_layers + 1
    return out


def dense_serve_launches(cfg, new=NEW) -> dict:
    """Kernel launches of a serve run of a dense model: a prefill and `new`
    decode steps."""
    out = dict(dense_prefill_launches(cfg))
    for k, v in dense_decode_launches(cfg).items():
        out[k] = out.get(k, 0) + new * v
    return out


def dense_train_launches(cfg) -> dict:
    """Kernel launches of one train step of a dense model (remat per layer,
    CE_CHUNKS cross-entropy chunks): each layer's flash forward twice (the
    recompute), dq and dk/dv once; the CE forward twice and its backward once
    a chunk; with RMS norms attn_norm and ffn_norm forward twice and backward
    once a layer, final_norm once each way."""
    out = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd_dq": cfg.n_layers,
           "flash_attention_bwd_dkv": cfg.n_layers, "fused_ce": 2 * CE_CHUNKS,
           "fused_ce_bwd": CE_CHUNKS}
    if cfg.norm == "rmsnorm":
        out.update(rmsnorm=4 * cfg.n_layers + 1, rmsnorm_bwd=2 * cfg.n_layers + 1)
    return out


def dense_train_flops(cfg, batch, seq, ce_chunks=CE_CHUNKS) -> float:
    """The FLOPs one train step of a dense model executes (remat per layer,
    chunked CE): every product of the forward (q, k, v and o projections;
    the MLP's two (GELU) or three (SwiGLU) products; the head) four times,
    for the forward, the recompute (each layer's and each CE chunk's) and
    the backward's two, less the MLP's last product once a layer (the
    recompute stops at the last tensor the backward saved, as
    `torch.utils.checkpoint` does); the flash passes by causal pairs P = B
    H S (S + 1) / 2 a layer: 4 D P forward and again in the recompute, dq
    6 D P, dk/dv 8 D P; the kernels' elementwise work: RMSNorm 4 an element
    forward (twice a layer's norm, once the final), 10 backward; the CE 4 a
    logit forward (twice) and backward."""
    d, h, hkv, dh, t = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, batch * seq
    attn = 2 * t * d * dh * (2 * h + 2 * hkv)
    mlp = 2 * t * (2 if cfg.act == "gelu" else 3) * d * cfg.d_ff
    forward = cfg.n_layers * (attn + mlp) + 2 * t * d * cfg.vocab_size
    pairs = batch * h * seq * (seq + 1) // 2
    flops = (4 * forward - cfg.n_layers * 2 * t * cfg.d_ff * d
             + cfg.n_layers * 22 * dh * pairs + 3 * 4 * t * cfg.vocab_size)
    if cfg.norm == "rmsnorm":
        flops += ((4 * cfg.n_layers + 1) * 4 + (2 * cfg.n_layers + 1) * 10) * t * d
    return flops


def ssm_train_flops(cfg, batch, seq, ce_chunks=CE_CHUNKS) -> float:
    """The FLOPs one train step of a mamba2 model executes (remat per
    layer, chunked CE), as the dry run counts them: in_proj and out_proj
    four times (the forward, the recompute and the backward's two) less
    out_proj once a layer (the recompute stops at the last tensor the
    backward saved); the tied head four times; the SSD scan's forward
    (`fwd_work`'s tensor-core operations) twice a layer and its backward
    (`bwd_work`'s) once; RMSNorm 4 an element forward (the layer's norm at d
    and the gated out_norm at d_inner, twice each; final_norm once), 10
    backward; the CE 4 a logit forward (twice) and backward.  The conv and
    the gating are elementwise, not counted."""
    from repro_torch.kernels.ssd_scan.kernel import bwd_work, fwd_work
    s_ = cfg.ssm
    d, t, layers = cfg.d_model, batch * seq, cfg.n_layers
    di = s_.expand * d
    h, gn = di // s_.head_dim, s_.n_groups * s_.d_state
    proj, out = 2 * t * d * (2 * di + 2 * gn + h), 2 * t * di * d
    scan = (2 * fwd_work(batch, seq, h, s_.head_dim, s_.d_state)[1]
            + bwd_work(batch, seq, h, s_.head_dim, s_.d_state)[1])
    norms = 4 * t * (2 * layers * (d + di) + d) + 10 * t * (layers * (d + di) + d)
    return (layers * (4 * (proj + out) - out + scan) + 4 * 2 * t * d * cfg.vocab_size
            + norms + 3 * 4 * t * cfg.vocab_size)


def dense_serve_bound(cfg, params, batch, prompt) -> dict:
    """The least time of a dense model's serve steps.  Prefill of batch x
    prompt tokens: the bf16 products (q, k, v and o projections, the causal
    pairs at 4 D flops a pair a head, the MLP: two products with GELU, three
    with SwiGLU; the head on the last token) over the bf16 peak, or the
    weights it reads over the memory rate, if larger.  A decode step reads
    every weight but an untied token table (a gather; a tied one is the
    head) and the KV cache's live rows at the serve run's mean length."""
    from repro_torch.tree import tree_leaves
    d, h, hkv, dh, t = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, batch * prompt
    pairs = batch * h * prompt * (prompt + 1) // 2
    attn = 2 * t * d * dh * (2 * h + 2 * hkv) + 4 * dh * pairs
    mlp = 2 * t * (2 if cfg.act == "gelu" else 3) * d * cfg.d_ff
    flops = cfg.n_layers * (attn + mlp) + 2 * batch * d * cfg.vocab_size

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    weights = nbytes(params)
    read = weights - (0 if cfg.tie_embeddings else nbytes(params["embed"]["tok"]))
    mean_len = (SERVE_LENGTHS[0] + SERVE_LENGTHS[1]) / 2
    kv = cfg.n_layers * 2 * batch * mean_len * hkv * dh * 2
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, read / PEAK_BYTES * 1e3
    return {"params": sum(x.numel() for x in tree_leaves(params)),
            "prefill_tflop_bf16": flops / 1e12, "weights_gb": weights / 1e9,
            "weights_read_gb": read / 1e9, "kv_read_gb": kv / 1e9,
            "prefill_bound_ms": max(ops_ms, bytes_ms),
            "prefill_bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "decode_step_bound_ms": (read + kv) / PEAK_BYTES * 1e3, "decode_bound_by": "bytes",
            "decode_tok_per_s_bound": batch / ((read + kv) / PEAK_BYTES)}


def starcoder2_small_config():
    """Reduced starcoder2-15b (4 layers, d 128, GELU, QKV bias, LayerNorm)
    with 12 query heads over 1 kv head at D 128: the flash kernels' and
    decode attention's rep 12 at the full model's head dim."""
    from repro_torch.configs import get_config
    return get_config(SC_ARCH).reduced(n_heads=12, n_kv_heads=1, d_head=128)


def ce_chunks_of(s, n=CE_CHUNKS) -> int:
    """`_chunked_ce`'s number of chunks of a length-s sequence: the largest
    count <= n that divides s (the MTP loss's S - 1 = 511: 7 of 73 rows)."""
    while s % n:
        n -= 1
    return n


def mla_norms(cfg) -> int:
    """RMS norms a layer of an MLA model runs: attn_norm, kv_norm, ffn_norm,
    and q-LoRA's q_norm where the config has it."""
    return 3 + int(bool(cfg.mla.q_lora_rank))


def moe_serve_launches(cfg) -> dict:
    """Kernel launches of a serve run (a prefill and NEW decode steps) of an
    MLA + MoE model: every layer's norms and final_norm, every step; nothing
    else (MLA's absorbed attention and the MoE are plain torch)."""
    return {"rmsnorm": (mla_norms(cfg) * cfg.n_layers + 1) * (1 + NEW)}


def moe_train_launches(cfg, seq) -> dict:
    """Kernel launches of one train step of an MLA + MoE model (remat per
    layer, CE_CHUNKS cross-entropy chunks): each layer's norms forward twice
    (the recompute) and backward once, final_norm once each way; the flash
    forward twice, dq and dk/dv once a layer; the CE forward twice and its
    backward once a chunk.  An MTP head adds its layer's norms and its own
    norm, once each way (it is not checkpointed), a flash forward, dq and
    dk/dv, and the CE of its S - 1 positions in `ce_chunks_of(seq - 1)`
    chunks."""
    n, layers = mla_norms(cfg), cfg.n_layers
    mtp = int(cfg.mtp)
    chunks = CE_CHUNKS + (ce_chunks_of(seq - 1) if mtp else 0)
    return {"rmsnorm": 2 * n * layers + 1 + mtp * (n + 1),
            "rmsnorm_bwd": n * layers + 1 + mtp * (n + 1),
            "flash_attention_fwd": 2 * layers + mtp, "flash_attention_bwd_dq": layers + mtp,
            "flash_attention_bwd_dkv": layers + mtp, "fused_ce": 2 * chunks,
            "fused_ce_bwd": chunks}


def capacity_changes(a_calls, b_calls, cfg, tokens) -> list:
    """The tokens of two recorded runs that select the same experts but keep
    other routes: `moe_slots` numbers each expert's routes token-major and
    drops those past its capacity, so a flip moves later tokens' routes past
    it or back under it.  Call by call, as `route_flips`."""
    from repro_torch.models.layers import moe_slots
    mo = cfg.moe
    cap = int(max(1, math.ceil(tokens * mo.top_k / mo.n_experts * mo.capacity_factor)))
    out = []
    for layer, (a, b) in enumerate(zip(a_calls, b_calls)):
        ka, kb = (moe_slots(c["idx"], mo.n_experts, cap)[1] for c in (a, b))
        for tok in range(ka.shape[0]):
            ia, ib = a["idx"][tok], b["idx"][tok]
            kept_a, kept_b = sorted(ia[ka[tok]].tolist()), sorted(ib[kb[tok]].tolist())
            if set(ia.tolist()) == set(ib.tolist()) and kept_a != kept_b:
                out.append({"layer": layer, "token": tok, "kept_a": kept_a, "kept_b": kept_b})
    return out


def upstream_of(flip, changes, seq) -> list:
    """The changes (flips, capacity changes) that can have moved `flip`'s
    token: in an earlier MoE layer, in the same sequence, at the same or an
    earlier position (causal attention).  Tokens are rows of the flattened
    [batch, seq]."""
    row, pos = divmod(flip["token"], seq)
    return [f for f in changes if f["layer"] < flip["layer"]
            and f["token"] // seq == row and f["token"] % seq <= pos]


def ssm_train_launches(cfg) -> dict:
    """A mamba2 train step's launches: per layer the norm and the gated
    out_norm, each recomputed, and the scan (forward, recompute, backward);
    final_norm; the CE's chunks (forward twice, backward once)."""
    return {"rmsnorm": 4 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1,
            "ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers,
            "fused_ce": 2 * CE_CHUNKS, "fused_ce_bwd": CE_CHUNKS}


def host_copy(state):
    """A train state's leaves copied to the host, by dotted name (a DTensor
    leaf gathered whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_leaves
    return dict(zip(leaf_names(state), (
        (t.full_tensor() if isinstance(t, DTensor) else t).detach().to("cpu", copy=True)
        for t in tree_leaves(state))))


def host_peak_gb():
    """The process's peak resident memory in GB and where it was read:
    /proc's VmHWM where the kernel keeps it, else getrusage's ru_maxrss
    (which counts from the process's start)."""
    with open("/proc/self/status") as f:
        m = re.search(r"VmHWM:\s+(\d+) kB", f.read())
    if m:
        return int(m.group(1)) * 1024 / 1e9, "VmHWM"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9, "ru_maxrss"


def reset_host_peak() -> bool:
    """Restart the peak resident memory count (Linux's clear_refs 5);
    False where the kernel refuses, and the peak then runs from the
    process's start."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def train_resume(dev, arch=SSM_ARCH, reduced=False, batch=TRAIN_B, seq=SSM_TRAIN_S,
                 steps=RESUME_STEPS, stop=RESUME_STOP, ckpt_every=RESUME_CKPT_EVERY,
                 counter=None) -> dict:
    """The Trainer over its BuffetFS data path and checkpoints, on the
    Trainer's default storage: the port's BuffetFS, a cluster of 4
    in-process BServers backed by a temp dir (removed at the end).  Run A
    is stopped at step `stop` of `steps`; run B (a new Trainer over the
    same directory and run name, so a new cluster that restarts the servers
    from what they persisted) resumes from A's checkpoint and runs the
    steps left; run C (another run name, the same corpus) runs all `steps`
    uninterrupted.  The record holds A's final state against B's restored
    one leaf by leaf, B's batches and losses against C's at the same steps,
    every save's times (the blocking copy to the host, the wait for the
    previous write, the writes on the thread), the last wait, the restore,
    the bytes and files written, the pipelines' counts, each run's RPCs
    (the agent's critical and async counts and its count by verb, after its
    async closes drained), the corpus as read through the Trainer's client,
    peak host and device memory, each run's launches (`counter`: a
    (reset, read) pair, by default the kernel wrappers' counts), and each
    run's lock nestings: the (held, acquired) pairs of lock classes that a
    `LockOrderRecorder` saw on its Trainer's servers from just after the
    Trainer was built (so A's corpus build is not recorded; its saves,
    reads and restarts are).  `resume_failures` reads it."""
    from repro_torch.core.analysis import LockOrderRecorder
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.train import Trainer, TrainerConfig
    reset, read = counter or (reset_launches, launches)
    root = tempfile.mkdtemp(prefix="train_resume_")
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rec = {"arch": arch, "reduced": reduced, "global_batch": batch, "seq_len": seq,
           "steps": steps, "stop": stop, "ckpt_every": ckpt_every,
           "disk_free_gb": shutil.disk_usage(root).free / 1e9,
           "runs": {}}
    host_reset = reset_host_peak()

    def run(name, run_name, until=None):
        tc = TrainerConfig(arch=arch, reduced=reduced, global_batch=batch, seq_len=seq,
                           steps=steps, ckpt_every=ckpt_every, log_every=steps,
                           run_name=run_name, data_dir=root, device=str(dev), seed=SEED)
        tr = Trainer(tc)
        locks = LockOrderRecorder()
        for srv in tr.cluster.servers.values():
            locks.instrument_server(srv)
        seen, to_device = [], tr._to_device
        tr._to_device = lambda b: (seen.append({k: np.array(v) for k, v in b.items()}),
                                   to_device(b))[1]
        t0 = time.perf_counter()
        tr.init_or_restore()      # B's: the restore
        if on_card:
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        restored = host_copy(tr.state) if tr.start_step else None
        reset()
        out = tr.run(until)
        got = read()
        tr.agent.drain()
        rpc = tr.agent.stats.snapshot()
        if name == "A":     # the corpus, through the Trainer's client
            paths = [p for p in tr.lib.walk_files("/corpus/train") if p.endswith(".tok")]
            sizes = [len(tr.lib.read_file(p)) for p in paths]
            rec["corpus"] = {"files": len(sizes), "bytes_each": sorted(set(sizes)),
                             "shard_dirs": len({p.rsplit("/", 1)[0] for p in paths})}
        tr.shutdown()
        st = tr.pipeline.stats
        rec["runs"][name] = {
            "n_servers": len(tr.cluster.servers), "critical_rpcs": rpc["critical_path"],
            "async_rpcs": rpc["async_offpath"], "rpcs_by_type": rpc["by_type"],
            "run_name": run_name, "start_step": tr.start_step, "init_or_restore_s": init_s,
            "steps_run": len(out["losses"]), "losses": out["losses"],
            "step_ms": out["step_s"] * 1e3,
            "step_times_ms": [t * 1e3 for t in out["step_times_s"]], "saves": tr.ckpt.saves,
            "last_wait_s": out["ckpt_wait_s"], "launches": got,
            "lock_pairs": sorted(locks.pairs),
            "bytes_written": sum(s["bytes"] for s in tr.ckpt.saves),
            "files_written": sum(s["files"] for s in tr.ckpt.saves),
            "pipeline": {"batches": st.batches, "samples": st.samples, "hedged": st.hedged}}
        return tr, seen, restored

    t_phase = time.perf_counter()
    try:
        a, a_seen, _ = run("A", "stopped", until=stop)
        a_final = host_copy(a.state)
        del a
        b, b_seen, b_restored = run("B", "stopped")
        del b
        c, c_seen, _ = run("C", "whole")
        del c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["restored_diff_leaves"] = (
        sorted(set(a_final) ^ set(b_restored or {})) + [
            n for n in a_final if n in (b_restored or {})
            and not torch.equal(a_final[n], b_restored[n])])
    rec["state_leaves"] = len(a_final)
    rec["batch_diffs"] = [stop + i + 1 for i, (x, y) in enumerate(zip(b_seen, c_seen[stop:]))
                          if any(x[k].tobytes() != y[k].tobytes() for k in y)]
    rec["batches_compared"] = min(len(b_seen), len(c_seen[stop:]))
    lb, lc = rec["runs"]["B"]["losses"], rec["runs"]["C"]["losses"][stop:]
    rec["loss_rel_err"] = [abs(x - y) / abs(y) for x, y in zip(lb, lc)]
    rec["losses_bitwise"] = lb == lc
    rec["stopped_losses_bitwise"] = rec["runs"]["A"]["losses"] == rec["runs"]["C"]["losses"][:stop]
    rec["peak_host_gb"], source = host_peak_gb()
    rec["peak_host_since"] = ("the phase's start" if host_reset and source == "VmHWM"
                              else f"the process's start ({source})")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    return rec


def resume_failures(rec, per_step) -> list:
    """Why `train_resume`'s record fails its checks (none: it passes): B
    resumes at the stop; its restored state is A's final state bitwise,
    every leaf; its batches are C's at the same steps bitwise; its losses
    are within TOL_RESUME_LOSS of C's; every loss finite; every run's
    launches `per_step` (name: count, every counted name) times its steps;
    every run went through BuffetFS RPCs and sent no OPEN_RECORD (BuffetFS
    defers the open onto the first data RPC); every run recorded lock
    nestings (a silent recorder would make the next two checks vacuous),
    of registered lock classes only, none against the declared order."""
    from repro_torch.core.analysis import LockOrderRecorder
    from repro_torch.core.analysis.buffetlint import LOCK_RANK
    runs, stop = rec["runs"], rec["stop"]
    out = []
    for name, r in runs.items():
        if not r["critical_rpcs"] > 0:
            out.append(f"run {name} sent no critical RPC: {r['rpcs_by_type']}")
        if r["rpcs_by_type"].get("OPEN_RECORD", 0):
            out.append(f"run {name} sent {r['rpcs_by_type']['OPEN_RECORD']} OPEN_RECORD")
        pairs = {tuple(p) for p in r["lock_pairs"]}
        unregistered = sorted({c for p in pairs for c in p} - LOCK_RANK.keys())
        locks = LockOrderRecorder()     # its verdict on the registered pairs
        locks.pairs = {p for p in pairs if not set(p) - LOCK_RANK.keys()}
        inverted = locks.violations()
        if not pairs:
            out.append(f"run {name} recorded no lock nesting")
        if unregistered:
            out.append(f"run {name} nested unregistered lock classes {unregistered}")
        if inverted:
            out.append(f"run {name} nested locks against the declared order: {inverted}")
    if runs["B"]["start_step"] != stop:
        out.append(f"B resumed at step {runs['B']['start_step']}, not {stop}")
    if rec["restored_diff_leaves"]:
        out.append(f"B's restored state differs from A's final in {rec['restored_diff_leaves']}")
    if rec["batch_diffs"] or rec["batches_compared"] != rec["steps"] - stop:
        out.append(f"B's batches differ from C's at steps {rec['batch_diffs']} "
                   f"({rec['batches_compared']} compared)")
    if len(rec["loss_rel_err"]) != rec["steps"] - stop or not all(
            e <= TOL_RESUME_LOSS for e in rec["loss_rel_err"]):
        out.append(f"B's losses differ from C's: relative {rec['loss_rel_err']} "
                   f"(tol {TOL_RESUME_LOSS})")
    losses = [x for r in runs.values() for x in r["losses"]]
    if not all(np.isfinite(losses)):
        out.append(f"non-finite loss: {losses}")
    for name, r in runs.items():
        want = {k: 0 for k in r["launches"]}
        want.update({k: v * r["steps_run"] for k, v in per_step.items()})
        if r["launches"] != want:
            out.append(f"run {name}'s launches {r['launches']} != {r['steps_run']} x {per_step}")
    return out


def lustre_mkfiles(core, client, blobs, n_dirs, prefix="/corpus") -> list:
    """The files `blobs` (as many a directory, in `n_dirs` directories under
    `prefix`) in a namespace made by the Lustre baselines' own path, as
    `benchmarks/common.py::mkfiles` makes it for them: the whole namespace
    on the MDS (host 0), each file's object on an OSS (hosts 1.., round
    robin) under Lustre-Normal and on the MDS under Lustre-DoM.  `client` is
    a `core.LustreNormalClient` or `core.LustreDoMClient` of a cluster of
    `core` (either package's BuffetFS); its dentry cache holds every
    directory afterwards.  Returns the paths, in the order of `blobs`."""
    Message, MsgType = core.Message, core.MsgType
    n_servers = client.cluster.n_servers
    oss = [0] if client.dom or n_servers == 1 else list(range(1, n_servers))
    per_dir = len(blobs) // n_dirs
    client.mkdir(prefix)
    paths = []
    for i, blob in enumerate(blobs):
        dname = f"{prefix}/d{i // per_dir:03d}"
        if i % per_dir == 0:
            client.mkdir(dname)
        parent_fid, _ = client._resolve_parent(dname + "/x")
        path = f"{dname}/f{i % per_dir:05d}"
        host = oss[i % len(oss)]
        r = client._rpc(host, Message(MsgType.MKNOD_OBJ, {
            "is_dir": False, "mode": 0o644, "uid": 0, "gid": 0}))
        client._rpc(0, Message(MsgType.LINK_DENTRY, {
            "parent": parent_fid, "name": path.rsplit("/", 1)[1],
            "ino": r.header["ino"], "perm": r.header["perm"]}))
        client._rpc(host, Message(MsgType.WRITE, {
            "file_id": core.Inode.unpack(r.header["ino"]).file_id, "offset": 0}, blob))
        paths.append(path)
    client.drain()
    return paths


def open_read_close(client, paths, blobs, flags=0) -> dict:
    """Each of `paths` opened, read whole and closed through `client` (a
    BAgent or a Lustre baseline client), its async closes drained after:
    the RPCs per file by kind and verb (the client's counts, reset first)
    and the host's wall time per file (no latency injected), every read
    checked against `blobs`."""
    client.stats.reset()
    bad = 0
    t0 = time.perf_counter()
    for path, blob in zip(paths, blobs):
        fd = client.open(path, flags)
        bad += client.read(fd) != blob
        client.close(fd)
    wall = time.perf_counter() - t0
    client.drain()
    snap = client.stats.snapshot()
    n = len(paths)
    return {"files": n, "bad_reads": bad, "critical_per_file": snap["critical_path"] / n,
            "async_per_file": snap["async_offpath"] / n,
            "by_type_per_file": {k: v / n for k, v in sorted(snap["by_type"].items())},
            "host_wall_us_per_file": wall / n * 1e6}


def write_corpus(lib, samples, name, shard_size, root="/corpus") -> None:
    """`BuffetDataset.build`'s corpus of `samples` (the same paths, bytes
    and INDEX; no replicas), written through `BLib.write_files`, one call a
    shard directory, whose creates go to each host in one BATCH: the same
    namespace in fewer round trips than a CREATE a file."""
    from repro_torch.data import DatasetSpec, encode_sample
    base = f"{root}/{name}"
    lib.makedirs(base)
    counts = []
    for si in range(0, max(1, -(-len(samples) // shard_size))):
        shard = samples[si * shard_size:(si + 1) * shard_size]
        sdir = f"{base}/shard_{si:04d}"
        lib.makedirs(sdir)
        lib.write_files([f"{sdir}/s_{j:06d}.tok" for j in range(len(shard))],
                        [encode_sample(x) for x in shard])
        counts.append(len(shard))
    spec = DatasetSpec(name=name, n_shards=len(counts), samples_per_shard=counts)
    lib.write_file(f"{base}/INDEX", json.dumps(spec.__dict__).encode())


def buffetfs_ingest(dev, n_files=INGEST_FILES, n_dirs=INGEST_DIRS, seq=SSM_TRAIN_S,
                    batch=TRAIN_B, n_servers=INGEST_SERVERS, seed=SEED + 70,
                    agent_cls=None) -> dict:
    """The paper's mechanism at the Trainer's file size, on the host of the
    card's machine.  A corpus of `n_files` samples of seq + 1 tokens (of
    mamba2-130m's vocab, drawn from `seed`) is written in
    `BuffetDataset.build`'s layout (`write_corpus`) into `n_dirs` shard
    directories on a cluster of
    `n_servers` in-process BServers (the port's BuffetFS, in a temp dir
    removed at the end); the shard directories are warmed, the agent's
    async closes drained and its counts reset, and its `perm_check_rpcs`
    (the group-table fetches of its permission checks) read; then one
    epoch (n_files // batch batches) is read through `DataPipeline` (prefetch on, no
    hedging), each batch held bitwise to the same batch built from the
    samples in memory (`corpus_batches`) and its tokens copied to `dev`,
    where they are summed.  The samples read are counted at the dataset
    (the pipeline's thread reads ahead of the epoch), and the agent's RPCs
    after the pipeline stops and its closes drain.  Then every file is
    opened, read and closed one by one (`open_read_close`) through the same
    agent, and through `core.LustreNormalClient` and `core.LustreDoMClient`,
    each on a cluster of its own whose namespace the baseline path made
    (`lustre_mkfiles`) with the same bytes.  `perm_check_rpcs` is read
    again after the epoch and after the agent's pass.  `agent_cls` (default
    `core.BAgent`) builds the BuffetFS agent.  `ingest_failures` reads the
    record."""
    import threading
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.data import (BuffetDataset, DataPipeline, ShardedSampler,
                                  corpus_batches, encode_sample)
    vocab = get_config(SSM_ARCH).vocab_size
    corpus = list(np.random.default_rng(seed).integers(
        1, vocab, size=(n_files, seq + 1)).astype(np.uint32))
    root = tempfile.mkdtemp(prefix="buffetfs_ingest_")
    rec = {"files": n_files, "shard_dirs": n_dirs, "n_servers": n_servers,
           "tokens_each": seq + 1, "global_batch": batch, "seq_len": seq}
    clusters, clients = [], []
    t_phase = time.perf_counter()
    try:
        cluster = core.BuffetCluster(root_dir=os.path.join(root, "buffetfs"),
                                     n_servers=n_servers)
        clusters.append(cluster)
        agent = (agent_cls or core.BAgent)(cluster)
        clients.append(agent)
        lib = core.BLib(agent)
        t0 = time.perf_counter()
        write_corpus(lib, corpus, "ingest", n_files // n_dirs)
        agent.drain()
        ds = BuffetDataset(lib, name="ingest")
        rec["build_s"] = time.perf_counter() - t0
        blobs = [encode_sample(s) for s in corpus]
        rec["bytes_each"] = sorted({len(b) for b in blobs})
        ds.warm_dirs()
        agent.drain()
        agent.stats.reset()
        perm = {"warmed": agent.perm_check_rpcs}
        reads, lock, read_sample = [0], threading.Lock(), ds.read_sample

        def counted(idx, **kw):
            with lock:
                reads[0] += 1
            return read_sample(idx, **kw)
        ds.read_sample = counted
        n_batches = n_files // batch
        pipe = DataPipeline(ds, ShardedSampler(n_samples=n_files, global_batch=batch,
                                               dp_rank=0, dp_size=1),
                            seq_len=seq, hedge_delay_s=None)
        want = corpus_batches(corpus, ShardedSampler(n_samples=n_files, global_batch=batch,
                                                     dp_rank=0, dp_size=1), seq)
        mismatched, dev_sum, host_sum = 0, torch.zeros((), dtype=torch.long, device=dev), 0
        t0 = time.perf_counter()
        for b, w in zip(itertools.islice(pipe, n_batches), want):
            mismatched += any(b[k].tobytes() != w[k].tobytes() for k in w)
            dev_sum += torch.as_tensor(b["tokens"]).to(dev).sum()
            host_sum += int(w["tokens"].sum())
        dev_sum = int(dev_sum)          # waits for the copies
        epoch_s = time.perf_counter() - t0
        pipe.stop()
        agent.drain()
        perm["after_epoch"] = agent.perm_check_rpcs
        snap = agent.stats.snapshot()
        rec["epoch"] = {
            "batches": n_batches, "batches_mismatched": mismatched,
            "samples_read": reads[0], "pipeline_samples": pipe.stats.samples,
            "token_sum_device": dev_sum, "token_sum_host": host_sum,
            "critical_rpcs": snap["critical_path"], "async_rpcs": snap["async_offpath"],
            "by_type": snap["by_type"], "host_wall_s": epoch_s,
            "samples_per_s": n_batches * batch / epoch_s}
        ds.read_sample = read_sample
        paths = [ds.sample_path(i) for i in range(n_files)]
        systems = {"buffetfs": open_read_close(agent, paths, blobs)}
        perm["after_open_read_close"] = agent.perm_check_rpcs
        rec["perm_check_rpcs"] = perm
        for name, cls in (("lustre_normal", core.LustreNormalClient),
                          ("lustre_dom", core.LustreDoMClient)):
            cl = core.BuffetCluster(root_dir=os.path.join(root, name), n_servers=n_servers)
            clusters.append(cl)
            client = cls(cl)
            clients.append(client)
            t0 = time.perf_counter()
            lpaths = lustre_mkfiles(core, client, blobs, n_dirs)
            systems[name] = {"build_s": time.perf_counter() - t0,
                             **open_read_close(client, lpaths, blobs)}
        rec["systems"] = systems
    finally:
        for c in clients:
            c.shutdown()
        for c in clusters:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def ingest_failures(rec) -> list:
    """Why `buffetfs_ingest`'s record fails its checks (none: it passes):
    over the epoch, READ RPCs equal the samples read, the critical-path
    RPCs equal READ, no LOOKUP_DIR, LOOKUP_TREE or OPEN_RECORD, and the
    async RPCs are CLOSEs, one a READ (`tests/test_data_and_ckpt.py`'s
    pipeline property, exact); every sample was read at least once, every
    batch is bitwise the batch from memory, the device's token sum the
    host's; and BuffetFS's open, read and close of a file costs one
    critical RPC (READ) and one async (CLOSE).  The agent's
    `perm_check_rpcs` stays where warming left it over the epoch and over
    its open/read/close pass: warm files serve their own permission checks
    (the paper's "serve yourself").  Every system read back its files'
    bytes.  The Lustre counts are not gated here (the CPU tests hold them
    to the JAX package's)."""
    out = []
    ep = rec["epoch"]
    perm = rec["perm_check_rpcs"]
    if perm["after_epoch"] != perm["warmed"]:
        out.append(f"perm_check_rpcs moved over the epoch: {perm['warmed']} -> "
                   f"{perm['after_epoch']}")
    if perm["after_open_read_close"] != perm["after_epoch"]:
        out.append(f"perm_check_rpcs moved over the open/read/close pass: "
                   f"{perm['after_epoch']} -> {perm['after_open_read_close']}")
    bt = ep["by_type"]
    read = bt.get("READ", 0)
    if read != ep["samples_read"]:
        out.append(f"READ {read} != samples read {ep['samples_read']}")
    if ep["critical_rpcs"] != read:
        out.append(f"critical RPCs {ep['critical_rpcs']} != READ {read}")
    for verb in ("LOOKUP_DIR", "LOOKUP_TREE", "OPEN_RECORD"):
        if bt.get(verb, 0):
            out.append(f"{bt[verb]} {verb} in the epoch")
    if bt.get("CLOSE", 0) != read or ep["async_rpcs"] != read:
        out.append(f"CLOSE {bt.get('CLOSE', 0)} / async {ep['async_rpcs']} != READ {read}")
    if ep["samples_read"] < rec["files"]:
        out.append(f"{ep['samples_read']} samples read of {rec['files']}")
    if ep["batches_mismatched"]:
        out.append(f"{ep['batches_mismatched']} batches differ from the corpus's")
    if ep["token_sum_device"] != ep["token_sum_host"]:
        out.append(f"device token sum {ep['token_sum_device']} != {ep['token_sum_host']}")
    bfs = rec["systems"]["buffetfs"]
    if bfs["critical_per_file"] != 1 or bfs["async_per_file"] != 1 or \
            bfs["by_type_per_file"] != {"CLOSE": 1.0, "READ": 1.0}:
        out.append(f"BuffetFS open/read/close per file: {bfs}")
    for name, r in rec["systems"].items():
        if r["bad_reads"] or r["files"] != rec["files"]:
            out.append(f"{name}: {r['bad_reads']} of {r['files']} reads differ")
    return out


def fixed_batch(vocab, batch, seq, seed) -> dict:
    """The train phases' fixed batch (numpy, as `DataPipeline` yields it):
    tokens drawn from `seed`, every position counted."""
    toks = np.random.default_rng(seed).integers(1, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": np.ones((batch, seq), np.float32)}


def init_world(dev) -> str:
    """A one-rank process group on `dev` (NCCL on a card, gloo on the CPU)
    over an in-memory store: no address, no network.  Returns the NCCL
    version on a card."""
    import torch.distributed as dist
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0 if dev.index is None else dev.index)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        return ".".join(map(str, torch.cuda.nccl.version()))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return None


def train_sharded(dev, ref, arch=ARCH, reduced=False, batch=TRAIN_B, seq=TRAIN_S,
                  steps=TRAIN_STEPS, moment_dtype=torch.bfloat16, batch_seed=SEED + 4,
                  counter=None, n_layers=None, keep=None) -> dict:
    """The train phase's run again on a DeviceMesh: the same weights (the
    Trainer's init from SEED) and fixed batch, the state through
    `shard_train_state` on a 1 x 1 (data, model) mesh of the process group
    (`init_world`), the batch through `shard_batch`, `steps` train steps
    under `activation_specs_for` (the first `n_layers` layers where given,
    as the Trainer cuts them).  `ref` is the unsharded run: its losses, its
    final params (`host_copy`) and its peak bytes, where it kept them.  The record holds each loss's
    relative error and whether all are bitwise, each param leaf's relative
    L2 error and whether all are bitwise, the leaves not at their spec's
    placements, the launches (`counter`: a (reset, read) pair, by default
    the kernel wrappers' counts), step times and peak memory.
    `sharded_failures` reads it.  `keep`, a dict, gets the losses, the
    final params (host copies, by dotted name) and the peak, for
    `train_sharded_resume`."""
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import (shard_batch, shard_train_state, train_state_specs,
                                           train_step)
    from repro_torch.tree import tree_leaves
    reset, read = counter or (reset_launches, launches)
    on_card = torch.device(dev).type == "cuda"
    tc = TrainerConfig(arch=arch, reduced=reduced, global_batch=batch, seq_len=seq,
                       steps=steps, device=str(dev), seed=SEED, moment_dtype=moment_dtype,
                       n_layers=n_layers)
    fixed = fixed_batch(get_config_of(arch, reduced).vocab_size, batch, seq, batch_seed)
    tr = Trainer(tc, batches=[fixed])
    cfg, opt_cfg = tr.cfg, tr.opt_cfg
    tr.init_state()
    mesh = make_host_mesh(1, 1, device_type=torch.device(dev).type)
    ms = sh.mesh_shape(mesh)
    shape = InputShape("train", seq, batch, "train")
    specs = train_state_specs(tr.state["params"], cfg, ms)
    state = shard_train_state(tr.state, cfg, mesh)
    tr.state = None
    sbatch = shard_batch(tr._to_device(fixed), mesh, shape)
    faults = sh.misplaced(state, specs, mesh)
    act = sh.activation_specs_for(ms, shape, cfg)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        with activation_specs(act):
            state, metrics = train_step(state, sbatch, cfg, opt_cfg)
        losses.append(float(metrics["loss"]))          # waits for the step
        times.append(time.perf_counter() - t0)
    got = read()
    faults += sh.misplaced(state, specs, mesh, prefix="after.")
    names = leaf_names(state["params"])
    final = {nm: t.detach().full_tensor() for nm, t in zip(names, tree_leaves(state["params"]))}
    rel = {}
    bitwise = True
    for nm, want in ref["params"].items():
        g = final[nm].cpu() if nm in final else None
        rel[nm] = (math.inf if g is None or g.shape != want.shape
                   else float((g.float() - want.float()).norm()
                              / max(float(want.float().norm()), 1e-30)))
        bitwise = bitwise and g is not None and torch.equal(g, want)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    if keep is not None:
        keep.update(losses=losses, params={nm: t.cpu() for nm, t in final.items()},
                    peak_mem_gb=peak)
    return {"arch": arch, "reduced": reduced, "mesh": ms, "global_batch": batch,
            "seq_len": seq, "steps": steps, "steps_run": len(losses),
            "ref_step_ms": ref.get("step_ms"),
            "moment_dtype": str(moment_dtype).split(".")[-1],
            "activation_specs": {k: v and list(v) for k, v in act.items()},
            "losses": losses, "ref_losses": ref["losses"],
            "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])],
            "losses_bitwise": losses == ref["losses"],
            "param_rel_l2": rel, "params_bitwise": bitwise, "placement_faults": faults,
            "launches": got, "step_ms": statistics.median(times[1:] or times) * 1e3,
            "step_times_ms": [t * 1e3 for t in times],
            "peak_mem_gb": peak, "ref_peak_mem_gb": ref.get("peak_mem_gb")}


def serve_sharded(dev, ref, arch=ARCH, reduced=False, prompt=PROMPT, max_len=MAX_LEN,
                  new=NEW, prompt_seed=SEED + 1, counter=None) -> dict:
    """The serve phase's run again on a DeviceMesh: the same weights (the
    Server's init from SEED), prompts (from `prompt_seed`) and cache length,
    through `Server(..., mesh=...)`: params by `shard_params` and the cache
    by `shard_cache` on a 1 x 1 (data, model) mesh of the process group
    (`init_world`), each step under its activation specs.  `ref` is the
    serve phase's record: its tokens, its last step's logits, prefill ms,
    decode tokens/s and peak GB.  The record holds the tokens' match, the
    logits' max |diff| over their max |value| and whether they are bitwise,
    the launches of the run (`counter`: a (reset, read) pair, by default the
    kernel wrappers' counts), the times and the peak.
    `sharded_serve_failures` reads it."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.runtime import sharding as sh
    from repro_torch.tree import tree_leaves
    reset, read = counter or (reset_launches, launches)
    on_card = torch.device(dev).type == "cuda"
    mesh = make_host_mesh(1, 1, device_type=torch.device(dev).type)
    srv = Server(arch, reduced=reduced, max_len=max_len, device=str(dev), seed=SEED, mesh=mesh)
    prompts = np.random.default_rng(prompt_seed).integers(
        1, srv.cfg.vocab_size, size=(BATCH, prompt + 1)).astype(np.int32)[:, :prompt]
    # warm-up at the served shape: DTensor's sharding propagation runs once
    # for each new op shape (~0.5 s at the first 4 x 512 prefill), and a
    # batch of 1 (the serve phase's warm-up) split over a mesh dim, even of
    # size 1, is a reshape DTensor refuses
    srv.generate(prompts, 2)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset()
    out = srv.generate(prompts, new)
    got = read()
    logits = out["last_logits"].float().cpu()
    want = ref["last_logits"].float()
    scale = float(want.abs().max())
    return {"arch": arch, "reduced": reduced, "mesh": sh.mesh_shape(mesh), "batch": BATCH,
            "prompt": prompt, "new_tokens": new, "max_len": max_len,
            "param_placements": sorted({str(getattr(t, "placements", None))
                                        for t in tree_leaves(srv.params)}),
            "tokens_equal": bool(np.array_equal(out["tokens"], ref["tokens"])),
            "logits_rel_err": float((logits - want).abs().max()) / max(scale, 1e-30),
            "logits_bitwise": bool(torch.equal(logits, want)), "finite": out["finite"],
            "launches": got, "prefill_ms": out["prefill_s"] * 1e3,
            "decode_tok_per_s": out["decode_tok_per_s"],
            "ref_prefill_ms": ref.get("prefill_ms"),
            "ref_decode_tok_per_s": ref.get("decode_tok_per_s"),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
            "ref_peak_mem_gb": ref.get("peak_mem_gb")}


def sharded_serve_failures(rec, want) -> list:
    """Why `serve_sharded`'s record fails its checks (none: it passes): the
    same tokens as the serve phase's, finite logits, the last step's within
    TOL_SHARDED_LOGITS, the launches `want` (name: count, every counted
    name), every param a DTensor."""
    out = []
    if not rec["tokens_equal"]:
        out.append("tokens differ from the serve phase's")
    if not rec["finite"]:
        out.append("non-finite logits")
    if not rec["logits_rel_err"] <= TOL_SHARDED_LOGITS:
        out.append(f"last logits differ from the serve phase's: max |diff| / max |logit| "
                   f"{rec['logits_rel_err']} (tol {TOL_SHARDED_LOGITS})")
    expect = {k: 0 for k in rec["launches"]}
    expect.update(want)
    if rec["launches"] != expect:
        out.append(f"launches {rec['launches']} != {expect}")
    if not all(p.startswith("(") for p in rec["param_placements"]):
        out.append(f"params not DTensors: {rec['param_placements']}")
    return out


def dryrun_cells(dev, train_ref, serve_ref, arch=ARCH, reduced=False) -> dict:
    """The dry run (`repro_torch.launch.dryrun.run_cell`, on a fake process
    group; no real one may be up) of `arch`'s cells on a 1 x 1 mesh at the
    phases' own shapes: the train phase's (TRAIN_B x TRAIN_S, bf16
    moments) and the serve phase's prefill (BATCH x PROMPT) and decode
    (BATCH, one token against a PROMPT-row cache), traced with `dev`'s
    device type; `train_ref` is the train phase's measured argument bytes
    (state and batch) and peak, `serve_ref` the serve phase's peak.
    `dryrun_failures` reads the record."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import run_cell
    device = torch.device(dev).type
    cfg = get_config_of(arch, reduced)
    cells = {
        "train": run_cell(arch, InputShape("train", TRAIN_S, TRAIN_B, "train"),
                          mesh_shape=(1, 1), device=device, moment_dtype=torch.bfloat16,
                          config=cfg),
        "prefill": run_cell(arch, InputShape("prefill", PROMPT, BATCH, "prefill"),
                            mesh_shape=(1, 1), device=device, config=cfg),
        "decode": run_cell(arch, InputShape("decode", PROMPT, BATCH, "decode"),
                           mesh_shape=(1, 1), device=device, config=cfg)}
    train = cells["train"]
    flops = dense_train_flops(cfg, TRAIN_B, TRAIN_S)
    peak = train["memory"]["peak_bytes"]
    return {"arch": arch, "reduced": reduced, "cells": cells,
            "train_argument_bytes": train["memory"]["argument_bytes"],
            "measured_argument_bytes": train_ref["argument_bytes"],
            "train_peak_bytes": peak, "measured_peak_bytes": train_ref["peak_bytes"],
            "peak_rel_err": abs(peak - train_ref["peak_bytes"]) / train_ref["peak_bytes"],
            "train_flops": train["flops_per_device"], "analytic_flops": flops,
            "flops_rel_err": abs(train["flops_per_device"] - flops) / flops,
            "prefill_peak_gb": cells["prefill"]["memory"]["peak_bytes"] / 1e9,
            "decode_peak_gb": cells["decode"]["memory"]["peak_bytes"] / 1e9,
            "serve_phase_peak_gb": serve_ref.get("peak_mem_gb"),
            "kernel_calls": {k: c["kernel_calls"] for k, c in cells.items()},
            "expected_kernel_calls": {"train": dense_train_launches(cfg),
                                      "prefill": dense_prefill_launches(cfg),
                                      "decode": dense_decode_launches(cfg)}}


def production_cells(arch=ARCH, device="cuda") -> dict:
    """`arch`'s cells at the production 16x16 mesh (`shapes_for`), as the
    dry run's sweep traces them: shape name -> record."""
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.launch.dryrun import run_cell
    return {shp.name: run_cell(arch, shp, mesh_shape=(16, 16), device=device)
            for shp in shapes_for(get_config(arch))}


def dryrun_failures(rec, production=None) -> list:
    """Why `dryrun_cells`'s record (and the production cells, if given)
    fails its checks (none: it passes): every cell ok; the train cell's
    argument bytes equal to the measured state and batch bytes, exactly;
    its peak within TOL_DRYRUN_PEAK of the measured peak; its FLOPs within
    TOL_DRYRUN_FLOPS of `dense_train_flops` (where the record has an
    analytic count); each cell's kernel calls those of one train step, one
    prefill, one decode step."""
    out = []
    for name, c in list(rec["cells"].items()) + list((production or {}).items()):
        if not c.get("ok"):
            out.append(f"cell {name} not ok: {c.get('error')}")
    if rec["train_argument_bytes"] != rec["measured_argument_bytes"]:
        out.append(f"train argument bytes {rec['train_argument_bytes']} != measured "
                   f"{rec['measured_argument_bytes']}")
    if not rec["peak_rel_err"] <= TOL_DRYRUN_PEAK:
        out.append(f"train peak {rec['train_peak_bytes']} vs measured "
                   f"{rec['measured_peak_bytes']}: {rec['peak_rel_err']} > {TOL_DRYRUN_PEAK}")
    if rec["analytic_flops"] is not None and not rec["flops_rel_err"] <= TOL_DRYRUN_FLOPS:
        out.append(f"train FLOPs {rec['train_flops']} vs analytic {rec['analytic_flops']}: "
                   f"{rec['flops_rel_err']} > {TOL_DRYRUN_FLOPS}")
    for name, want in rec["expected_kernel_calls"].items():
        if rec["kernel_calls"][name] != want:
            out.append(f"{name} cell's kernel calls {rec['kernel_calls'][name]} != {want}")
    return out


def dryrun_ssm_cell(dev, train_ref, arch=SSM_ARCH, reduced=False, batch=TRAIN_B,
                    seq=SSM_TRAIN_S) -> dict:
    """The dry run of `arch`'s (mamba2-130m's) train cell on a 1 x 1 mesh at
    train_ssm's own shape (TRAIN_B x SSM_TRAIN_S, fp32 moments), traced
    with `dev`'s device type, in the record `dryrun_failures` reads:
    `train_ref` is train_ssm's measured argument bytes and peak, the FLOPs
    are held to `ssm_train_flops` and the kernel calls to
    `ssm_train_launches`."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import run_cell
    cfg = get_config_of(arch, reduced)
    cell = run_cell(arch, InputShape("train", seq, batch, "train"), mesh_shape=(1, 1),
                    device=torch.device(dev).type, moment_dtype=torch.float32, config=cfg)
    flops, peak = ssm_train_flops(cfg, batch, seq), cell["memory"]["peak_bytes"]
    return {"arch": arch, "reduced": reduced, "cells": {"train": cell},
            "train_argument_bytes": cell["memory"]["argument_bytes"],
            "measured_argument_bytes": train_ref["argument_bytes"],
            "train_peak_bytes": peak, "measured_peak_bytes": train_ref["peak_bytes"],
            "peak_rel_err": abs(peak - train_ref["peak_bytes"]) / train_ref["peak_bytes"],
            "train_flops": cell["flops_per_device"], "analytic_flops": flops,
            "flops_rel_err": abs(cell["flops_per_device"] - flops) / flops,
            "kernel_calls": {"train": cell["kernel_calls"]},
            "expected_kernel_calls": {"train": ssm_train_launches(cfg)}}


def dryrun_hybrid_cell(dev, train_ref, cfg, batch=TRAIN_B, seq=HYBRID_TRAIN_S) -> dict:
    """The dry run of train_hybrid's train cell of `cfg` (a config of
    HYBRID_ARCH: `hybrid_small_config()`) on a 1 x 1 mesh at its own shape
    (TRAIN_B x HYBRID_TRAIN_S, bf16 moments, as the sweep's jamba cells),
    traced with `dev`'s device type, in the record `dryrun_failures` reads:
    `train_ref` is train_hybrid's measured argument bytes and peak, the
    kernel calls are held to `hybrid_train_launches`; the FLOPs are printed,
    with no analytic count to hold them to (the experts run at their
    capacity)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import run_cell
    cell = run_cell(HYBRID_ARCH, InputShape("train", seq, batch, "train"), mesh_shape=(1, 1),
                    device=torch.device(dev).type, moment_dtype=torch.bfloat16, config=cfg)
    peak = cell["memory"]["peak_bytes"]
    return {"arch": HYBRID_ARCH, "reduced": True, "cells": {"train": cell},
            "train_argument_bytes": cell["memory"]["argument_bytes"],
            "measured_argument_bytes": train_ref["argument_bytes"],
            "train_peak_bytes": peak, "measured_peak_bytes": train_ref["peak_bytes"],
            "peak_rel_err": abs(peak - train_ref["peak_bytes"]) / train_ref["peak_bytes"],
            "train_flops": cell["flops_per_device"], "analytic_flops": None,
            "kernel_calls": {"train": cell["kernel_calls"]},
            "expected_kernel_calls": {"train": hybrid_train_launches(cfg)}}


@contextlib.contextmanager
def config_as(arch, cfg):
    """While entered, `get_config(arch)` returns `cfg` (a cut or a reduced
    form of it): the Server, the Trainer and the dry run read that config
    for the time they are built and run."""
    from repro_torch.configs import REGISTRY
    full = REGISTRY[arch]
    REGISTRY[arch] = cfg
    try:
        yield cfg
    finally:
        REGISTRY[arch] = full


def get_config_of(arch, reduced):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


def sharded_failures(rec, per_step, peak_tol=None) -> list:
    """Why `train_sharded`'s record fails its checks (none: it passes):
    every step ran; each loss finite and within TOL_SHARDED_LOSS (relative)
    of the unsharded run's; each param leaf of the unsharded run present
    and within TOL_SHARDED_PARAM (relative L2); every param and moment leaf
    at its spec's placements, before and after; the launches `per_step`
    (name: count, every counted name) times the steps; with `peak_tol`, the
    peak device memory within it (relative) of the unsharded run's."""
    out = []
    if rec["steps_run"] != rec["steps"] or len(rec["ref_losses"]) != rec["steps"]:
        out.append(f"{rec['steps_run']} steps run, {len(rec['ref_losses'])} to compare, "
                   f"of {rec['steps']}")
    if not all(np.isfinite(rec["losses"])):
        out.append(f"non-finite loss: {rec['losses']}")
    if len(rec["loss_rel_err"]) != rec["steps"] or not all(
            e <= TOL_SHARDED_LOSS for e in rec["loss_rel_err"]):
        out.append(f"losses differ from the unsharded run's: relative {rec['loss_rel_err']} "
                   f"(tol {TOL_SHARDED_LOSS})")
    bad = {k: v for k, v in rec["param_rel_l2"].items() if not v <= TOL_SHARDED_PARAM}
    if bad:
        out.append(f"params differ from the unsharded run's (relative L2, tol "
                   f"{TOL_SHARDED_PARAM}): {bad}")
    if rec["placement_faults"]:
        out.append(f"leaves not at their spec's placements: {rec['placement_faults']}")
    want = {k: 0 for k in rec["launches"]}
    want.update({k: v * rec["steps"] for k, v in per_step.items()})
    if rec["launches"] != want:
        out.append(f"launches {rec['launches']} != {rec['steps']} x {per_step}")
    peak, ref_peak = rec.get("peak_mem_gb"), rec.get("ref_peak_mem_gb")
    if peak_tol is not None and not abs(peak - ref_peak) <= peak_tol * ref_peak:
        out.append(f"peak {peak} GB against the unsharded run's {ref_peak} GB (tol "
                   f"{peak_tol})")
    return out


def manifest_diffs(ckpt, other, step) -> list:
    """The leaves of two managers' MANIFESTs at `step` that differ in name,
    shape, dtype, part paths (within the step) or crc32s."""
    def leaves(mgr):
        return {lm["name"]: (lm["shape"], lm["dtype"],
                             [(f["path"].split("/")[-2:], f["crc"]) for f in lm["files"]])
                for lm in mgr.manifest(step).leaves}
    a, b = leaves(ckpt), leaves(other)
    return sorted(n for n in set(a) | set(b) if a.get(n) != b.get(n))


def train_sharded_resume(dev, ref, arch=SSM_ARCH, reduced=False, batch=TRAIN_B,
                         seq=SSM_TRAIN_S, steps=SSM_TRAIN_STEPS, stop=SHARDED_RESUME_STOP,
                         moment_dtype=torch.float32, batch_seed=SEED + 15, counter=None) -> dict:
    """train_sharded's run (`ref`: its kept losses, final params and peak)
    stopped and resumed through a sharded checkpoint, on a 1 x 1 mesh of
    the process group (`init_world`): run A takes steps 1..`stop` from the
    same weights (SEED) and fixed batch, then saves the sharded state async
    through `CheckpointManager` over the port's BuffetFS (4 in-process
    BServers backed by a temp dir, removed at the end); a fresh sharded
    state from another seed (SEED + 1) is the `like_state` that
    `elastic_restore` restores the save into, with the
    state's specs; run B takes steps `stop` + 1..`steps` from it.  The record
    holds A's and B's losses beside train_sharded's, the restored state
    against A's at the save leaf by leaf (bitwise) and its placements, the
    save's MANIFEST against a plain save of the same state's full tensors,
    the same checkpoint restored into a plain `like` on the host, B's final
    params against train_sharded's (bitwise), the restored step and
    sampler step, each run's launches (`counter`: a (reset, read) pair, by
    default the kernel wrappers' counts), the save's record (gather, copy,
    write seconds, bytes, files), the restores' seconds, the storage's RPCs
    (critical, async, by verb), and peak host and device memory beside
    train_sharded's peak and the largest leaf's bytes.
    `sharded_resume_failures` reads it."""
    from torch.distributed.tensor import DTensor
    from repro_torch import core
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.steps import (shard_batch, shard_train_state, train_state_specs,
                                           train_step)
    from repro_torch.tree import tree_leaves, tree_map
    reset, read = counter or (reset_launches, launches)
    on_card = torch.device(dev).type == "cuda"
    root = tempfile.mkdtemp(prefix="train_sharded_resume_")
    cluster = agent = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    host_reset = reset_host_peak()
    t_phase = time.perf_counter()
    fixed = fixed_batch(get_config_of(arch, reduced).vocab_size, batch, seq, batch_seed)
    rec = {"arch": arch, "reduced": reduced, "global_batch": batch, "seq_len": seq,
           "steps": steps, "stop": stop, "moment_dtype": str(moment_dtype).split(".")[-1],
           "ref_losses": ref["losses"], "ref_peak_mem_gb": ref.get("peak_mem_gb")}

    def trainer(seed):
        tr = Trainer(TrainerConfig(arch=arch, reduced=reduced, global_batch=batch, seq_len=seq,
                                   steps=steps, device=str(dev), seed=seed,
                                   moment_dtype=moment_dtype), batches=[fixed])
        tr.init_state()
        return tr

    def sync():
        if on_card:
            torch.cuda.synchronize()

    try:
        cluster = core.BuffetCluster(root_dir=root, n_servers=INGEST_SERVERS)
        agent = core.BAgent(cluster)
        lib = core.BLib(agent)
        tr = trainer(SEED)
        cfg, opt_cfg = tr.cfg, tr.opt_cfg
        mesh = make_host_mesh(1, 1, device_type=torch.device(dev).type)
        ms = sh.mesh_shape(mesh)
        shape = InputShape("train", seq, batch, "train")
        specs = train_state_specs(tr.state["params"], cfg, ms)
        state = shard_train_state(tr.state, cfg, mesh)
        rec["largest_leaf_gb"] = max(t.numel() * t.element_size()
                                     for t in tree_leaves(state)) / 1e9
        sbatch = shard_batch(tr._to_device(fixed), mesh, shape)
        act = sh.activation_specs_for(ms, shape, cfg)
        del tr

        def run(state, n):
            losses = []
            reset()
            for _ in range(n):
                with activation_specs(act):
                    state, metrics = train_step(state, sbatch, cfg, opt_cfg)
                losses.append(float(metrics["loss"]))          # waits for the step
            return state, losses, read()

        state, rec["a_losses"], a_launches = run(state, stop)
        ckpt = CheckpointManager(lib, "sharded", parts=4, keep_last=2)
        extra = {"train_step": stop, "sampler": {"step": stop, "seed": SEED}}
        ckpt.save(stop, state, block=False, extra=extra)
        saved = host_copy(state)
        t0 = time.perf_counter()
        ckpt.wait()
        rec["wait_s"] = time.perf_counter() - t0
        rec["save"] = dict(ckpt.saves[-1])
        # the same values saved plainly, from the host
        plain = tree_map(lambda t: (t.full_tensor() if isinstance(t, DTensor) else t)
                         .detach().to("cpu", copy=True), state)
        CheckpointManager(lib, "plain", parts=4).save(stop, plain, extra=extra)
        rec["manifest_diffs"] = manifest_diffs(
            ckpt, CheckpointManager(lib, "plain", parts=4), stop)
        del state
        tr = trainer(SEED + 1)
        like = shard_train_state(tr.state, cfg, mesh)
        del tr
        sync()
        t0 = time.perf_counter()
        res = elastic_restore(ckpt, like, batch, batch, mesh, specs)
        sync()
        rec["restore_s"] = time.perf_counter() - t0
        del like
        rec["restored_step"], rec["sampler_step"] = res.step, res.sampler.step
        rec["placement_faults"] = sh.misplaced(res.state, specs, mesh)
        got = host_copy(res.state)
        rec["restored_diff_leaves"] = sorted(
            n for n in set(saved) | set(got)
            if n not in saved or n not in got or saved[n].dtype != got[n].dtype
            or not torch.equal(saved[n], got[n]))
        t0 = time.perf_counter()
        _, back = ckpt.restore(like=plain)
        rec["plain_restore_s"] = time.perf_counter() - t0
        back = dict(zip(leaf_names(back), tree_leaves(back)))
        rec["plain_restored_diff_leaves"] = sorted(
            n for n in saved if n not in back or saved[n].dtype != back[n].dtype
            or not torch.equal(saved[n], back[n]))
        rec["state_leaves"] = len(saved)
        del saved, got, back, plain
        state, rec["b_losses"], b_launches = run(res.state, steps - stop)
        del res
        final = host_copy(state["params"])
        rec["param_diff_leaves"] = sorted(
            n for n in set(final) | set(ref["params"])
            if n not in final or n not in ref["params"]
            or not torch.equal(final[n], ref["params"][n]))
        del state, final
        agent.drain()
        rpc = agent.stats.snapshot()
        rec["rpcs"] = {"critical": rpc["critical_path"], "async": rpc["async_offpath"],
                       "by_type": rpc["by_type"]}
    finally:
        if agent is not None:
            agent.shutdown()
        if cluster is not None:
            cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    rec["launches"] = {"A": a_launches, "B": b_launches}
    rec["losses_bitwise"] = rec["a_losses"] + rec["b_losses"] == ref["losses"]
    rec["seconds"] = time.perf_counter() - t_phase
    rec["peak_host_gb"], source = host_peak_gb()
    rec["peak_host_since"] = ("the phase's start" if host_reset and source == "VmHWM"
                              else f"the process's start ({source})")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    return rec


def sharded_resume_failures(rec, per_step) -> list:
    """Why `train_sharded_resume`'s record fails its checks (none: it
    passes): the restore stands at the stop (its step and sampler's); A's
    losses and B's are train_sharded's, bitwise, and finite; the restored
    state is A's at the save, every leaf bitwise and at its spec's
    placements; the save's MANIFEST is a plain save's (names, shapes,
    dtypes, part paths, crc32s); the checkpoint restored into a plain
    `like` is the same state bitwise; B's final params are train_sharded's
    bitwise; each run's launches `per_step` times its steps; the peak
    device memory (where measured) within TOL_SHARDED_PEAK of
    train_sharded's peak plus the largest leaf's bytes."""
    stop, steps = rec["stop"], rec["steps"]
    out = []
    if rec["restored_step"] != stop or rec["sampler_step"] != stop:
        out.append(f"restored at step {rec['restored_step']}, sampler at "
                   f"{rec['sampler_step']}, not {stop}")
    ref = rec["ref_losses"]
    if len(ref) != steps or rec["a_losses"] != ref[:stop]:
        out.append(f"run A's losses {rec['a_losses']} are not train_sharded's {ref[:stop]}")
    if rec["b_losses"] != ref[stop:] or len(rec["b_losses"]) != steps - stop:
        out.append(f"the resumed losses {rec['b_losses']} are not train_sharded's "
                   f"{ref[stop:]}")
    if not all(np.isfinite(rec["a_losses"] + rec["b_losses"])):
        out.append(f"non-finite loss: {rec['a_losses'] + rec['b_losses']}")
    for key, what in (("restored_diff_leaves", "the restored state differs from A's"),
                      ("placement_faults", "restored leaves not at their spec's placements"),
                      ("manifest_diffs", "the sharded save's MANIFEST differs from a plain "
                                         "save's"),
                      ("plain_restored_diff_leaves", "the save restored plainly differs"),
                      ("param_diff_leaves", "the final params differ from train_sharded's")):
        if rec[key]:
            out.append(f"{what} in {rec[key]}")
    for run, n in (("A", stop), ("B", steps - stop)):
        want = {k: 0 for k in rec["launches"][run]}
        want.update({k: v * n for k, v in per_step.items()})
        if rec["launches"][run] != want:
            out.append(f"run {run}'s launches {rec['launches'][run]} != {n} x {per_step}")
    peak, ref_peak = rec.get("peak_mem_gb"), rec.get("ref_peak_mem_gb")
    if peak is not None:
        bound = (ref_peak + rec["largest_leaf_gb"]) * (1 + TOL_SHARDED_PEAK)
        if not peak <= bound:
            out.append(f"peak {peak} GB past {bound} GB (train_sharded's {ref_peak} + the "
                       f"largest leaf's {rec['largest_leaf_gb']}, + {TOL_SHARDED_PEAK})")
    return out


def compress_leaf_errors(names, grads, outs) -> dict:
    """Each compressed leaf against plain torch `_dequantize(_quantize(g))`
    on the same device (bitwise), and against g: within half a quantization
    step (its block's max |g| / 254) plus the leaf dtype's rounding of the
    result.  Returns the leaves not bitwise and, for those past the bound,
    the largest excess."""
    from repro_torch.runtime.compression import BLOCK, _dequantize, _quantize
    not_bitwise, over = [], {}
    for nm, g, out in zip(names, grads, outs):
        q, scale = _quantize(g)
        if out.dtype != g.dtype or not torch.equal(out, _dequantize(q, scale, g.shape, g.dtype)):
            not_bitwise.append(nm)
        n = g.numel()
        flat = torch.nn.functional.pad(g.float().reshape(-1), (0, (-n) % BLOCK))
        half = (flat.reshape(-1, BLOCK).abs().amax(dim=1) / 254.0).repeat_interleave(BLOCK)[:n]
        gf = g.float().reshape(-1)
        tol = half + torch.finfo(g.dtype).eps / 2 * (gf.abs() + half)
        excess = float(((out.float().reshape(-1) - gf).abs() - tol).max())
        if excess > 0:
            over[nm] = excess
    return {"not_bitwise": not_bitwise, "over_bound": over}


def compress(dev, arch=ARCH, reduced=False, batch=TRAIN_B, seq=TRAIN_S, batch_seed=SEED + 4,
             counter=None) -> dict:
    """The gradient tree of one train step of `arch` (the train phase's
    weights and fixed batch) reduced over the "pod" dim of a one-dim mesh
    of the process group (`init_world`, world 1).  `compressed_psum_tree`
    is the identity there, as JAX's is at size 1; the phase runs the
    reduction it maps over the leaves, `compressed_all_reduce` (the int8
    blocks summed as int32 and the scales' max, by the process group's
    all-reduces), on every leaf.  The record holds `compress_leaf_errors`,
    the launches of the phase (the step's; the reduction launches no
    kernel of the port), the bytes each reduction sends, and on a card the
    compressed tree's ms beside a plain bf16 all-reduce of the same tree."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model, loss_fn
    from repro_torch.runtime.compression import (BLOCK, compressed_all_reduce,
                                                 compressed_psum_tree)
    from repro_torch.runtime.steps import param_grads
    from repro_torch.tree import tree_leaves
    reset, read = counter or (reset_launches, launches)
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    cfg = get_config_of(arch, reduced)
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    fixed = fixed_batch(cfg.vocab_size, batch, seq, batch_seed)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in fixed.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset()
    with torch.enable_grad():
        loss, _ = loss_fn(params, tb, cfg)
        grads = [g.detach() for g in param_grads(loss, leaves)]
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
    group = mesh.get_group("pod")
    identity = compressed_psum_tree(grads, mesh, axis="pod") is grads
    outs = [compressed_all_reduce(g, group, 1) for g in grads]
    got = read()
    names = leaf_names(params)
    rec = {"arch": arch, "reduced": reduced, "leaves": len(grads),
           "elements": sum(g.numel() for g in grads), "loss": float(loss.detach()),
           "identity_at_size_1": identity, **compress_leaf_errors(names, grads, outs),
           "launches": got}
    del outs
    blocks = sum(-(-g.numel() // BLOCK) for g in grads)
    rec.update(int8_payload_bytes=blocks * BLOCK, scale_bytes=4 * blocks,
               compressed_all_reduce_bytes=4 * blocks * BLOCK + 4 * blocks,
               bf16_all_reduce_bytes=sum(2 * g.numel() for g in grads),
               grad_dtypes=sorted({str(g.dtype).split(".")[-1] for g in grads}))
    if on_card:
        def compressed():
            for g in grads:
                compressed_all_reduce(g, group, 1)

        def plain():           # a one-rank SUM leaves every leaf as it is
            for g in grads:
                dist.all_reduce(g, group=group)
        rec["compressed_ms"] = time_ms(compressed, lambda: None, reps=5, warmup=1)
        rec["plain_bf16_all_reduce_ms"] = time_ms(plain, lambda: None, reps=5, warmup=1)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def compress_failures(rec, per_step) -> list:
    """Why `compress`'s record fails its checks (none: it passes)."""
    out = []
    if not rec["identity_at_size_1"]:
        out.append("compressed_psum_tree is not the identity on a dim of size 1")
    if rec["not_bitwise"]:
        out.append(f"leaves not bitwise _dequantize(_quantize(g)): {rec['not_bitwise']}")
    if rec["over_bound"]:
        out.append(f"leaves past half a quantization step: {rec['over_bound']}")
    want = {k: 0 for k in rec["launches"]}
    want.update(per_step)
    if rec["launches"] != want:
        out.append(f"launches {rec['launches']} != {per_step}")
    return out


def train_check(dev, cfg, seed, seq=64, row1_len=40) -> dict:
    """One loss and every gradient of the reduced `cfg` at batch 2 x `seq`
    tokens (the second row padded after `row1_len`, as pack_batch makes it)
    on `dev` (kernels) against the same weights and batch on the CPU (plain
    versions).  Beside it each side against the same weights in fp32 on the
    CPU: the bf16 model's own rounding.

    For an MoE model each MoE layer's selection on the CPU is pinned to the
    card's, call by call (the remat recompute included), weighted by the
    CPU's own scores: the inputs of every layer are then the card's choice,
    so where the CPU's own selection in that run differs, the token is a
    flip of that layer alone, reported with the top-k gap of each side.  An
    unpinned CPU forward is reported beside it, not gated: there a flip
    changes the inputs of every later layer, so each flip at a gap >=
    NEAR_TIE is listed with what moved upstream of it (`upstream_of`): the
    flips, and the tokens whose routes past an expert's capacity changed
    (`capacity_changes`).
    A model without MoE makes no route calls and reports no flips.

    A sigmoid router's bias (deepseek-v3), zero at init, is drawn from the
    seed (N(0, 0.1^2)) so that it shifts the selection.  It only selects, so
    its gradient is exactly zero: it is held to that on every side, and the
    loss's gradients of every leaf come from `param_grads`, as the train
    step takes them.

    The record's "ok" holds the gate: loss and all gradients within
    TOL_GRAD (relative), every router_bias gradient exactly zero, no flip
    of the pinned run at a gap >= NEAR_TIE."""
    from repro_torch.models import init_model, layers, loss_fn
    from repro_torch.runtime.steps import param_grads
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    with torch.no_grad():
        sp = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        brng = np.random.default_rng(seed + 2)
        for lp in sp["blocks"]:
            if "router_bias" in lp.get("ffn", {}):
                lp["ffn"]["router_bias"].copy_(torch.from_numpy(
                    brng.standard_normal(lp["ffn"]["router_bias"].shape) * 0.1))
    sp_cpu = tree_map(lambda t: t.detach().cpu(), sp)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (2, seq + 1))
    smask = np.ones((2, seq), np.float32)
    smask[1, row1_len:] = 0.0

    def batch_on(where):
        return {"tokens": torch.from_numpy(toks[:, :-1]).to(where),
                "labels": torch.from_numpy(toks[:, 1:]).to(where),
                "loss_mask": torch.from_numpy(smask).to(where)}

    res, routes = {}, {}
    with RouteRecorder(layers) as rec:
        for side, where, params, pin in (
                ("cuda", dev, sp, None), ("cpu", "cpu", sp_cpu, "cuda"),
                ("cpu_fp32", "cpu", tree_map(lambda t: t.detach().float(), sp_cpu), "cuda")):
            leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
            rec.pin = None if pin is None else [c["idx"] for c in routes[pin]]
            loss, _ = loss_fn(params, batch_on(where), cfg)
            res[side] = [loss.detach().float().cpu()] + [
                g.float().cpu() for g in param_grads(loss, leaves)]
            routes[side] = rec.take()
        rec.pin = None
        with torch.no_grad():          # the forward's calls only: no recompute
            loss_fn(sp_cpu, batch_on("cpu"), cfg)
        unpinned = rec.take()
    names = leaf_names(sp)
    # the leaves the loss has no path to: exactly zero on every side
    zero = {nm: {side: float(res[side][1 + i].abs().max()) for side in res}
            for i, nm in enumerate(names) if nm.endswith("router_bias")}
    # The bf16 kernels round P and dS where the plain versions keep fp32.
    # Gate on the loss and on the relative L2 error of all gradients taken
    # together; per leaf it is reported, not gated: the key-bias gradient's
    # unrotated half is exactly 0 (softmax ignores a shift shared by all
    # keys), so that leaf is rounding noise on both sides.
    rel_loss, rel_all, rel_leaf = grad_rel_errors(res["cuda"], res["cpu"], names)
    worst = sorted(rel_leaf, key=rel_leaf.get, reverse=True)[:4]
    witness = {}
    for side in ("cuda", "cpu"):
        w_loss, w_all, w_leaf = grad_rel_errors(res[side], res["cpu_fp32"], names)
        witness[f"{side}_bf16_vs_cpu_fp32"] = {
            "rel_err_loss": w_loss, "rel_l2_all_grads": w_all,
            "worst_leaf_rel_l2": {nm: w_leaf[nm] for nm in worst}}
    flips = route_flips(routes["cuda"], [{"idx": c["own"], "gap": c["gap"]}
                                         for c in routes["cpu"]])
    wide = wide_flips(flips)
    free = route_flips(routes["cuda"][:len(unpinned)], unpinned)
    moved = free + (capacity_changes(routes["cuda"], unpinned, cfg, 2 * seq) if cfg.moe else [])
    free_wide = [{**f, "upstream": upstream_of(f, moved, seq)} for f in wide_flips(free)]
    return {"arch": cfg.name, "reduced": True, "batch": 2, "seq": seq,
            "loss_cuda": float(res["cuda"][0]), "loss_cpu": float(res["cpu"][0]),
            "rel_err_loss": rel_loss, "n_grads": len(names), "rel_l2_all_grads": rel_all,
            "worst_leaf_rel_l2": {nm: rel_leaf[nm] for nm in worst}, "tol": TOL_GRAD,
            "moe_route_calls": len(routes["cuda"]),
            "routes": sum(int(c["idx"].numel()) for c in routes["cuda"]),
            "gated": "cpu pinned to the card's selection" if routes["cuda"] else "no routing",
            "route_flips": len(flips),
            "largest_flip_gap": max([max(f["gap_a"], f["gap_b"]) for f in flips], default=None),
            "near_tie": NEAR_TIE, "wide_flips": len(wide), "flips": flips,
            "unpinned_forward": {
                "route_flips": len(free),
                "largest_flip_gap": max([max(f["gap_a"], f["gap_b"]) for f in free],
                                        default=None),
                "capacity_changes": len(moved) - len(free),
                "wide_flips": free_wide,
                "wide_flips_with_nothing_upstream": sum(not f["upstream"] for f in free_wide)},
            "zero_grad_leaves_max_abs": zero,
            "witness_fp32_params": witness, "seconds": time.perf_counter() - t0,
            "ok": bool(rel_loss <= TOL_GRAD and rel_all <= TOL_GRAD and not wide
                       and not any(v for z in zero.values() for v in z.values()))}


def hybrid_layer_chain(params, batch, cfg, forced=None):
    """`loss_fn`'s loss (AUX_WEIGHT its aux_weight) and every gradient of a
    hybrid model, taken a unit at a time: the token embedding, each layer of
    each period block (`_apply_hybrid_layer`) and the head (final_norm and
    the chunked CE).  Each unit runs forward from its own input and backward
    from the gradient at its own output, and chained they give the whole
    model's loss and gradients.  `forced`, another run's chain, gives each
    unit that run's input and output gradient instead, cast to this run's
    dtype, so that each unit of two runs is compared on the same operands.
    Returns (loss, [each leaf's gradient in `tree_leaves` order], the chain:
    {"ins": the input of each layer and of the head, "grads": the gradient
    at each}), all on the CPU."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]

    def operand(key, k, own):
        return (own if forced is None else forced[key][k].to(own.device, own.dtype)).detach()

    h0 = L.embed_tokens(params["embed"], batch["tokens"])
    positions = torch.arange(h0.shape[1], device=h0.device)
    units = [(i, lp) for bp in params["blocks"] for i, lp in enumerate(bp["layers"])]
    ins, outs, h = [], [], h0.detach()
    for k, (i, lp) in enumerate(units):
        ins.append(operand("ins", k, h).requires_grad_(True))
        h, aux, _ = T._apply_hybrid_layer(cfg, lp, i, ins[-1], positions)
        outs.append((h, aux))
        h = h.detach()
    ins.append(operand("ins", len(units), h).requires_grad_(True))
    nll, msum = T._chunked_ce(params["embed"], L.apply_norm(params["final_norm"], ins[-1]),
                              batch["labels"], batch["loss_mask"], cfg)
    ce = nll / torch.clamp(msum, min=1.0)
    ce.backward()
    grads = [ins[-1].grad]
    for k in reversed(range(len(units))):
        y, aux = outs[k]
        g = operand("grads", k + 1, grads[0])
        if aux.requires_grad:       # an MoE layer: the loss takes AUX_WEIGHT x its aux
            torch.autograd.backward([y, aux], [g, torch.full_like(aux, AUX_WEIGHT)])
        else:
            y.backward(g)
        grads.insert(0, ins[k].grad)
    h0.backward(operand("grads", 0, grads[0]))
    loss = ce.detach() + AUX_WEIGHT * sum(aux.detach() for _, aux in outs)
    return (loss.float().cpu(),
            [(t.grad if t.grad is not None else torch.zeros_like(t)).float().cpu()
             for t in leaves],
            {"ins": [x.detach().cpu() for x in ins], "grads": [g.detach().cpu() for g in grads]})


def chain_unit(name: str, period: int):
    """The unit of `hybrid_layer_chain` a leaf belongs to: "embed" (the
    token table), "head" (final_norm, the head) or the layer's index."""
    if name == "embed.tok":
        return "embed"
    if not name.startswith("blocks."):
        return "head"
    _, blk, _, i = name.split(".")[:4]
    return int(blk) * period + int(i)


def hybrid_train_check(dev, cfg, seed, seq, row1_len) -> dict:
    """train_check of a hybrid model, unit by unit: its loss and every
    gradient on `dev` (kernels), taken by `hybrid_layer_chain`, against the
    CPU's (plain versions) with each unit forced to the card's operands (its
    input and the gradient at its output) and each MoE layer's selection
    pinned to the card's, weighted by the CPU's own scores.

    A bf16 hybrid model's gradients are not fixed to TOL_GRAD by its
    rounding: rounding the Mamba layers' gated output to bf16 turns a
    difference in the fp32 sums' last bit into a whole bf16 ulp now and
    then, each Mamba layer roughly doubles a relative difference of its
    input in its output and triples it in its input's gradient, and seven
    follow one another in a block.  So a whole-model comparison reads
    several percent between any two orders of summation, and so does the
    card against the CPU (the `unforced` record: the CPU's own chain, the
    selection pinned).  Unit by unit the same kernels meet the same
    operands, and each unit and each leaf is held at TOL_GRAD.

    The record's "ok" holds the gate: the loss, all gradients together, each
    unit's (its leaves' gradients and the gradient at its input) and each
    leaf's within TOL_GRAD (relative L2), and no flip of the pinned run at a
    gap >= NEAR_TIE.  Beside it each side against the same units on the CPU in
    fp32 (the card's operands, cast): each unit's own bf16 rounding."""
    from repro_torch.models import init_model, layers
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    with torch.no_grad():
        sp = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sp_cpu = tree_map(lambda t: t.detach().cpu(), sp)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (2, seq + 1))
    smask = np.ones((2, seq), np.float32)
    smask[1, row1_len:] = 0.0

    def batch_on(where):
        return {"tokens": torch.from_numpy(toks[:, :-1]).to(where),
                "labels": torch.from_numpy(toks[:, 1:]).to(where),
                "loss_mask": torch.from_numpy(smask).to(where)}

    res, routes = {}, {}
    with RouteRecorder(layers) as rec:
        res["cuda"] = hybrid_layer_chain(sp, batch_on(dev), cfg)
        routes["cuda"] = rec.take()
        rec.pin = [c["idx"] for c in routes["cuda"]]
        for side, params, forced in (
                ("cpu", sp_cpu, res["cuda"][2]),
                ("cpu_fp32", tree_map(lambda t: t.detach().float(), sp_cpu), res["cuda"][2]),
                ("cpu_unforced", sp_cpu, None)):
            res[side] = hybrid_layer_chain(tree_map(lambda t: t.detach().clone(), params),
                                           batch_on("cpu"), cfg, forced=forced)
            routes[side] = rec.take()
        rec.pin = None
    names = leaf_names(sp)
    units = {}
    for i, nm in enumerate(names):
        units.setdefault(chain_unit(nm, cfg.hybrid.period), []).append(i)

    def unit_grads(run, u):
        """a unit's leaves' gradients and the gradient at its input"""
        return [run[1][i] for i in units[u]] + (
            [] if u == "embed" else [run[2]["grads"][-1 if u == "head" else u]])

    def unit_errors(got, want):
        return {str(u): float(torch.cat([(x - y).flatten() for x, y in
                                         zip(unit_grads(got, u), unit_grads(want, u))]).norm()
                              / torch.cat([y.flatten() for y in unit_grads(want, u)]).norm())
                for u in units}

    def compare(a, b):
        rel_loss, rel_all, rel_leaf = grad_rel_errors([a[0]] + a[1], [b[0]] + b[1], names)
        return rel_loss, rel_all, rel_leaf, unit_errors(a, b)

    rel_loss, rel_all, rel_leaf, rel_unit = compare(res["cuda"], res["cpu"])
    worst = sorted(rel_leaf, key=rel_leaf.get, reverse=True)[:4]
    witness = {}
    for side in ("cuda", "cpu"):
        w_loss, w_all, w_leaf, w_unit = compare(res[side], res["cpu_fp32"])
        witness[f"{side}_bf16_vs_cpu_fp32"] = {
            "rel_err_loss": w_loss, "rel_l2_all_grads": w_all,
            "max_unit_rel_l2": max(w_unit.values()),
            "worst_leaf_rel_l2": {nm: w_leaf[nm] for nm in worst}}
    u_loss, u_all, _, u_unit = compare(res["cuda"], res["cpu_unforced"])
    flips = route_flips(routes["cuda"], [{"idx": c["own"], "gap": c["gap"]}
                                         for c in routes["cpu"]])
    wide = wide_flips(flips)
    return {"arch": cfg.name, "reduced": True, "batch": 2, "seq": seq,
            "loss_cuda": float(res["cuda"][0]), "loss_cpu": float(res["cpu"][0]),
            "rel_err_loss": rel_loss, "n_grads": len(names), "rel_l2_all_grads": rel_all,
            "unit_rel_l2": rel_unit, "worst_leaf_rel_l2": {nm: rel_leaf[nm] for nm in worst},
            "tol": TOL_GRAD, "moe_route_calls": len(routes["cuda"]),
            "routes": sum(int(c["idx"].numel()) for c in routes["cuda"]),
            "gated": "cpu forced to the card's operands unit by unit, its selection pinned",
            "route_flips": len(flips),
            "largest_flip_gap": max([max(f["gap_a"], f["gap_b"]) for f in flips], default=None),
            "near_tie": NEAR_TIE, "wide_flips": len(wide), "flips": flips,
            "unforced": {"rel_err_loss": u_loss, "rel_l2_all_grads": u_all,
                         "max_unit_rel_l2": max(u_unit.values())},
            "witness_fp32_params": witness, "seconds": time.perf_counter() - t0,
            "ok": bool(max(rel_loss, rel_all, *rel_unit.values(), *rel_leaf.values()) <= TOL_GRAD
                       and not wide)}


# The kernels written for Hopper (wgmma, TMA, mbarrier rings): their
# ptxas report, dynamic shared memory and blocks an SM, at each value of
# their template parameters (the head dim D, the SSD scan's state dim N, the
# SSD backward's head dim P and state dim N).  Each names its entry point
# for the shared memory and the arguments that come before the parameters.
HEAD_DIM_VALUES = (("D", "DV"), ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128)))
SSD_BWD_VALUES = (("P", "N"), tuple((p, n) for p in (16, 32, 64) for n in (16, 32, 64, 128)))
HOPPER_KERNELS = (("flash_fwd_kernel", "flash_attention.cu", ("flash_attention_fwd_smem_bytes",),
                   160, HEAD_DIM_VALUES),
                  ("flash_bwd_dq_kernel", "flash_attention_bwd.cu",
                   ("flash_attention_bwd_dq_smem_bytes",), 384, HEAD_DIM_VALUES),
                  ("flash_bwd_dkv_kernel", "flash_attention_bwd.cu",
                   ("flash_attention_bwd_dkv_smem_bytes",), 160, HEAD_DIM_VALUES),
                  ("ssd_scan_kernel", "ssd_scan.cu", ("ssd_scan_smem_bytes",), 288,
                   (("N",), ((16,), (32,), (64,), (128,)))),
                  ("ssd_bwd_walk_kernel", "ssd_scan_bwd.cu", ("ssd_scan_bwd_smem_bytes", 0), 160,
                   SSD_BWD_VALUES),
                  ("ssd_bwd_grads_kernel", "ssd_scan_bwd.cu", ("ssd_scan_bwd_smem_bytes", 1), 512,
                   SSD_BWD_VALUES))


def ptxas_entries(text: str) -> dict:
    """{mangled entry name: {registers, stack, spill_stores, spill_loads}}
    from a `ptxas -v` report."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def hopper_kernel_report(build) -> list:
    rows = []
    for kernel, source, (smem_fn, *lead), threads, (params, values) in HOPPER_KERNELS:
        entries = ptxas_entries((build.BUILD_DIR / f"{source}.log").read_text())
        smem_of = build.function(smem_fn, (build.INT,) * (len(lead) + len(params)))
        for vals in values:
            tag = kernel + "I" + "".join(f"Li{v}E" for v in vals) + "E"
            name = next(n for n in entries if tag in n)
            e = entries[name]
            smem = smem_of(*lead, *vals)
            # registers are allocated per warp in units of 256; 1 KB of
            # shared memory a block is reserved; 228 KB an SM
            per_warp = -(-e["registers"] * 32 // 256) * 256
            by_regs = 65536 // (per_warp * -(-threads // 32))
            by_smem = 233472 // (smem + 1024)
            rows.append({"kernel": kernel, "source": source, **dict(zip(params, vals)),
                         "threads": threads, **e, "dynamic_smem_bytes": smem,
                         "blocks_per_sm_by_registers": by_regs,
                         "blocks_per_sm_by_smem": by_smem,
                         "blocks_per_sm": min(by_regs, by_smem)})
    return rows


def check_no_spills(entry: dict) -> None:
    """Raise if `entry` (a row of the ptxas reports) is an instance that
    must not spill: the flash kernels' head dim 80 ones and their q/k head
    dim 192, v head dim 128 ones (MLA), which hold dq, dk, dv or O in
    registers, the SSD backward's at mamba2-130m's P 64, N 128 and at
    jamba-1.5-large-398b's P 64, N 16, which hold the states and the dB, dC
    sums, the SSD scan's at jamba's N 16, the RMSNorm backward (two
    instances: two vectors a thread up to d 8192, deepseek-v3-671b's 7168
    among them, and four up to 16384, jamba's gated out_norm), which holds a
    row of x and of dy and its dscale partials, and every
    instance of decode attention, whose kv loop runs once per decode step
    and layer."""
    if not (entry.get("spill_stores") or entry.get("spill_loads")):
        return
    if entry["kernel"] == "rmsnorm_bwd_kernel":
        raise AssertionError(f"rmsnorm_bwd_kernel<{entry.get('V')}> spills: {entry}")
    if entry["kernel"] == "decode_kernel":
        raise AssertionError(f"decode_kernel<{entry.get('D')}, {entry.get('MT')}> spills: "
                             f"{entry}")
    if entry["kernel"].startswith("flash_") and (entry.get("D"), entry.get("DV")) in (
            (80, 80), (MLA_DQK, MLA_DV)):
        raise AssertionError(f"{entry['kernel']}<{entry['D']}, {entry['DV']}> spills: {entry}")
    if entry["kernel"].startswith("ssd_bwd_") and (entry.get("P"), entry.get("N")) in (
            (64, 128), (64, 16)):
        raise AssertionError(f"{entry['kernel']}<{entry['P']}, {entry['N']}> spills: {entry}")
    if entry["kernel"] == "ssd_scan_kernel" and entry.get("N") == 16:
        raise AssertionError(f"ssd_scan_kernel<16> spills: {entry}")


# Kernels of plain CUDA (mma.sync, cp.async): registers and spills of each
# instance (template arguments named), from the `ptxas -v` report.
PTXAS_KERNELS = (("decode_kernel", "decode_attention.cu", ("D", "MT")),
                 ("rmsnorm_bwd_kernel", "rmsnorm.cu", ("V",)))


def ptxas_report(build) -> list:
    rows = []
    for kernel, source, params in PTXAS_KERNELS:
        entries = ptxas_entries((build.BUILD_DIR / f"{source}.log").read_text())
        for name, e in entries.items():
            m = re.search(kernel + r"(?:I((?:Li\d+E)+))?E", name)
            if m:
                args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(1) or "")]
                rows.append({"kernel": kernel, "source": source, **dict(zip(params, args)),
                             **e})
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, decode_attention, decode_attention_ref,
                                     flash_attention_bwd, flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq,
                                     flash_attention_fwd, fused_ce, fused_ce_bwd,
                                     launches, reset_launches, rmsnorm, rmsnorm_bwd,
                                     rmsnorm_bwd_ref, rmsnorm_ref, ssd_scan, ssd_scan_bwd,
                                     ssd_scan_bwd_ref, ssd_scan_ref)
    from repro_torch.kernels.cross_entropy import ce_bwd_ref, ce_rows_ref
    from repro_torch.kernels.decode_attention.kernel import CLUSTERS as DECODE_CLUSTERS
    from repro_torch.kernels.decode_attention.kernel import cluster_size as decode_cluster_size
    from repro_torch.kernels.decode_attention.kernel import head_chunks as decode_head_chunks
    from repro_torch.kernels.flash_attention import (attention_bwd_dkv_ref,
                                                     attention_bwd_dq_ref,
                                                     attention_with_lse_ref)
    from repro_torch.kernels.flash_attention.kernel import DKV_CLUSTERS, dkv_cluster_size
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.models import init_cache
    from repro_torch.models import layers as L
    from repro_torch.runtime.steps import prefill_step, serve_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # the bytes of this thread's and autograd's cuBLAS workspaces, which a
    # traced peak does not hold: `train()` warms them before its peak's base
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "cublas_workspace_bytes": warm_cublas(dev)})

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library_dir": str(_build.BUILD_DIR)})
    for entry in hopper_kernel_report(_build) + ptxas_report(_build):
        emit({"phase": "build_kernel", **entry})
        check_no_spills(entry)

    # -- kernels at the serve path's shapes ------------------------------------
    rng = np.random.default_rng(SEED)
    scratch = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2

    def flush():     # a read leaves no dirty lines for the timed kernel to write back
        scratch.sum()

    randn = bf16_normal(rng, dev)
    rows = []

    def kernel_row(name, source, replaces, over, kern, plain, lib, nbytes, flops,
                   peak):
        if not over <= 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (excess over tolerance {over})")
        b_ms, b_by = bound(nbytes, flops, peak)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": None, "max_abs_err": None, "ms": time_ms(kern, flush),
               "plain_ms": time_ms(plain, flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if lib is None else time_ms(lib, flush)}
        rows.append(row)
        return row

    def other_shape(what, over, kern, plain, lib, nbytes, flops, peak, err, **extra):
        """A kernel at another shape of the main paths, checked and timed as
        a row is; nested in that kernel's row."""
        if not over <= 0:
            raise AssertionError(f"{what}: kernel disagrees with its plain version "
                                 f"(excess over tolerance {over})")
        b_ms, b_by = bound(nbytes, flops, peak)
        return {**extra, "max_abs_err": err, "ms": time_ms(kern, flush),
                "plain_ms": None if plain is None else time_ms(plain, flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(lib, flush)}

    # the inputs of the later shapes (the decode steps' norms, head dim 80, the
    # serve lengths), from their own generator, so that the other rows'
    # inputs stay as they were
    xrandn = bf16_normal(np.random.default_rng(SEED + 7), dev)

    # rmsnorm: every attn_norm / ffn_norm of a 4 x 512 prefill
    d = 4096
    x = randn(BATCH * PROMPT, d, scale=3.0)
    sc = 1.0 + 0.1 * randn(d)
    out, ref = rmsnorm(x, sc), rmsnorm_ref(x, sc)
    torch.cuda.synchronize()
    r = kernel_row("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "src/repro/kernels/rmsnorm/kernel.py:17",
                   excess(out, ref, TOL_RMSNORM),
                   lambda: rmsnorm(x, sc), lambda: rmsnorm_ref(x, sc),
                   lambda: F.rms_norm(x, (d,), sc, 1e-6),
                   nbytes=2 * x.numel() * 2 + d * 2, flops=4 * x.numel(),
                   peak=PEAK_F32)
    r["max_abs_err"] = float((out.float() - ref.float()).abs().max())
    # the decode steps' norms: [4, 4096] (chatglm3-6b, 57 a step) and [4, 768]
    # (mamba2-130m, 49 a step), 6,784 of the serve runs' 7,794 launches
    def rms_case(randn_, rows_, dd, pitch=None):
        """The forward at another shape of the serve and train paths, [rows_,
        dd] read from rows `pitch` apart, drawn from `randn_`: held by
        rmsnorm_check and timed as other_shape."""
        pitch = pitch or dd
        xd, sd = randn_(rows_, pitch, scale=3.0)[:, :dd], 1.0 + 0.1 * randn_(dd)
        chk = rmsnorm_check(xd, sd)
        return other_shape(
            f"rmsnorm [{rows_}, {dd}] at pitch {pitch}", chk["excess"],
            lambda: rmsnorm(xd, sd), lambda: rmsnorm_ref(xd, sd),
            lambda: F.rms_norm(xd, (dd,), sd, 1e-6),
            2 * xd.numel() * 2 + dd * 2, 4 * xd.numel(), PEAK_F32, chk["max_abs_err"],
            **({"pitch": pitch} if pitch != dd else {}))

    r["decode_shapes"] = {f"{BATCH}x{dd}": rms_case(xrandn, BATCH, dd) for dd in (4096, 768)}
    # deepseek-v2-lite-16b's norms (serve_moe: 5,330 launches): d 2048, and
    # kv_norm's [rows, 512] read in place from rows 576 apart, at its prefill's
    # 2048 rows and its decode steps' 4; own generator, as above
    mrandn = bf16_normal(np.random.default_rng(SEED + 12), dev)
    r["deepseek_v2_lite_shapes"] = {
        f"{rows_}x{dd}" + (f"_pitch{pitch}" if pitch != dd else ""):
            rms_case(mrandn, rows_, dd, pitch)
        for rows_, dd, pitch in ((BATCH * PROMPT, 2048, 2048), (BATCH * PROMPT, 512, 576),
                                 (BATCH, 2048, 2048), (BATCH, 512, 576))}
    # deepseek-v3-671b's norms (serve_v3, train_v3): attn_norm and ffn_norm at
    # d 7168 and q-LoRA's q_norm at 1536, at its prefill's 2048 rows and its
    # decode steps' 4 (the train step's 4096 rows take the prefill's geometry);
    # kv_norm's rows are v2-lite's above.  Own generator, as above
    vrandn3 = bf16_normal(np.random.default_rng(SEED + 23), dev)
    r["deepseek_v3_shapes"] = {
        f"{rows_}x{dd}": rms_case(vrandn3, rows_, dd)
        for rows_, dd in ((BATCH * PROMPT, 7168), (BATCH * PROMPT, 1536), (BATCH, 7168),
                          (BATCH, 1536))}
    # jamba-1.5-large-398b's norms (serve_hybrid): mixer_norm, ffn_norm and
    # final_norm at d 8192, the Mamba layers' gated out_norm at d_inner 16384,
    # at its prefill's 2048 rows and its decode steps' 4; own generator
    jrandn = bf16_normal(np.random.default_rng(SEED + 33), dev)
    r["jamba_shapes"] = {
        f"{rows_}x{dd}": rms_case(jrandn, rows_, dd)
        for rows_, dd in ((BATCH * PROMPT, 8192), (BATCH * PROMPT, 16384), (BATCH, 8192),
                          (BATCH, 16384))}
    # pixtral-12b's norms (serve_pixtral: 5,265 launches): d 5120 at its
    # prefill's 2048 rows and its decode steps' 4; own generator
    prandn = bf16_normal(np.random.default_rng(SEED + 44), dev)
    r["pixtral_shapes"] = {f"{rows_}x5120": rms_case(prandn, rows_, 5120)
                           for rows_ in (BATCH * PROMPT, BATCH)}
    emit({"phase": "kernel", **r, "shape": [BATCH * PROMPT, d]})

    # flash forward: one layer's prefill attention, q from the cache layout
    b, h, hkv, s, hd = BATCH, 32, 2, PROMPT, 128
    q = randn(b, s, h, hd).transpose(1, 2)
    ck, cv = randn(b, MAX_LEN, hkv, hd), randn(b, MAX_LEN, hkv, hd)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    (out, lse) = flash_attention_fwd(q, k, v, kv_len=s)
    ref, ref_lse = attention_with_lse_ref(q, k, v, q_offset=0, kv_len=s)
    torch.cuda.synchronize()
    over = max(excess(out, ref, TOL_BF16), excess(lse, ref_lse, TOL_LSE))
    ke = k[:, :, :s].repeat_interleave(h // hkv, dim=1)
    ve = v[:, :, :s].repeat_interleave(h // hkv, dim=1)
    pairs = b * h * s * (s + 1) // 2                       # unmasked (row, col)
    r = kernel_row("flash_attention_fwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:36", over,
                   lambda: flash_attention_fwd(q, k, v, kv_len=s),
                   lambda: attention_with_lse_ref(q, k, v, q_offset=0, kv_len=s),
                   lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                   nbytes=(2 * q.numel() + 2 * b * hkv * s * hd) * 2 + b * h * s * 4,
                   flops=4 * hd * pairs, peak=PEAK_BF16)
    r["max_abs_err"] = float((out.float() - ref.float()).abs().max())
    # the train step's shape (B 8, no cache), 448 of the forward's launches in
    # a run against 28 at the serve shape; its own generator leaves the other
    # rows' inputs as they were
    trng = np.random.default_rng(SEED + 6)

    def trandn(*shape):
        return torch.from_numpy(trng.standard_normal(shape, dtype=np.float32)).to(
            dev, torch.bfloat16)

    qt = trandn(TRAIN_B, s, h, hd).transpose(1, 2)
    kt, vt = (trandn(TRAIN_B, s, hkv, hd).transpose(1, 2) for _ in range(2))
    (out_t, lse_t), (ref_t, rlse_t) = (flash_attention_fwd(qt, kt, vt),
                                       attention_with_lse_ref(qt, kt, vt, q_offset=0))
    torch.cuda.synchronize()
    over_t = max(excess(out_t, ref_t, TOL_BF16), excess(lse_t, rlse_t, TOL_LSE))
    if not over_t <= 0:
        raise AssertionError(f"flash_attention_fwd at B {TRAIN_B} disagrees with its plain "
                             f"version (excess over tolerance {over_t})")
    kte, vte = (x.repeat_interleave(h // hkv, dim=1) for x in (kt, vt))
    pairs_t = TRAIN_B * h * s * (s + 1) // 2
    r["train_shape"] = {
        "B": TRAIN_B, "max_abs_err": float((out_t.float() - ref_t.float()).abs().max()),
        "ms": time_ms(lambda: flash_attention_fwd(qt, kt, vt), flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kte, vte,
                                                                     is_causal=True), flush),
        "bound_ms": bound((2 * qt.numel() + 2 * kt.numel()) * 2 + TRAIN_B * h * s * 4,
                          4 * hd * pairs_t, PEAK_BF16)[0]}
    del qt, kt, vt, out_t, lse_t, ref_t, rlse_t, kte, vte
    # stablelm-3b's head dim 80 (MHA, 32 heads): its serve prefill (k and v
    # read from the 1024-row cache) and its train step
    r["head_dim_80"] = {}
    for what, bb, t80 in (("serve", BATCH, MAX_LEN), ("train", TRAIN_B, s)):
        q8 = xrandn(bb, s, h, 80).transpose(1, 2)
        k8, v8 = (xrandn(bb, t80, h, 80).transpose(1, 2) for _ in range(2))
        (o8, l8), (r8, rl8) = (flash_attention_fwd(q8, k8, v8, kv_len=s),
                               attention_with_lse_ref(q8, k8, v8, q_offset=0, kv_len=s))
        torch.cuda.synchronize()
        k8s, v8s = k8[:, :, :s], v8[:, :, :s]
        pairs8 = bb * h * s * (s + 1) // 2
        r["head_dim_80"][what] = other_shape(
            f"flash_attention_fwd at D 80 ({what})",
            max(excess(o8, r8, TOL_BF16), excess(l8, rl8, TOL_LSE)),
            lambda q8=q8, k8=k8, v8=v8: flash_attention_fwd(q8, k8, v8, kv_len=s),
            lambda q8=q8, k8=k8, v8=v8: attention_with_lse_ref(q8, k8, v8, q_offset=0,
                                                               kv_len=s),
            lambda q8=q8, k8s=k8s, v8s=v8s: F.scaled_dot_product_attention(q8, k8s, v8s,
                                                                           is_causal=True),
            (2 * q8.numel() + 2 * k8s.numel()) * 2 + bb * h * s * 4, 4 * 80 * pairs8,
            PEAK_BF16, float((o8.float() - r8.float()).abs().max()),
            shape={"B": bb, "H": h, "Hkv": h, "S": s, "T": t80, "kv_len": s, "D": 80})
    del q8, k8, v8, o8, l8, r8, rl8, k8s, v8s
    def flash_fwd_case(what, gen_seed, bb, g_h, g_kv, dd, t_kv):
        """The forward at a model's prefill (k and v read from the t_kv-row
        cache, kv_len s) or train shape (t_kv = s): q, then k and v drawn
        from their own generator, held to the plain version, timed beside
        SDPA with the group expanded, the bound by causal pairs."""
        frandn = bf16_normal(np.random.default_rng(gen_seed), dev)
        qj = frandn(bb, s, g_h, dd).transpose(1, 2)
        kj, vj = (frandn(bb, t_kv, g_kv, dd).transpose(1, 2) for _ in range(2))
        (oj, lj), (rj, rlj) = (flash_attention_fwd(qj, kj, vj, kv_len=s),
                               attention_with_lse_ref(qj, kj, vj, q_offset=0, kv_len=s))
        torch.cuda.synchronize()
        kje, vje = (x[:, :, :s].repeat_interleave(g_h // g_kv, dim=1) for x in (kj, vj))
        pairs_j = bb * g_h * s * (s + 1) // 2
        return other_shape(
            f"flash_attention_fwd ({what})",
            max(excess(oj, rj, TOL_BF16), excess(lj, rlj, TOL_LSE)),
            lambda: flash_attention_fwd(qj, kj, vj, kv_len=s),
            lambda: attention_with_lse_ref(qj, kj, vj, q_offset=0, kv_len=s),
            lambda: F.scaled_dot_product_attention(qj, kje, vje, is_causal=True),
            (2 * qj.numel() + 2 * bb * g_kv * s * dd) * 2 + bb * g_h * s * 4, 4 * dd * pairs_j,
            PEAK_BF16, float((oj.float() - rj.float()).abs().max()),
            shape={"B": bb, "H": g_h, "Hkv": g_kv, "S": s, "T": t_kv, "kv_len": s, "D": dd},
            causal_pairs=pairs_j)

    # jamba-1.5-large-398b's prefill attention (serve_hybrid): 64 query heads
    # over 8 kv heads (GQA rep 8) at D 128, k and v read from the 1024-row cache
    r["jamba_rep8"] = flash_fwd_case("rep 8, jamba-1.5-large-398b", SEED + 36, b, 64, 8, hd,
                                     MAX_LEN)
    # the last four families' prefills, from the 1024-row cache: command-r-35b
    # (64 over 8, the instance above on other inputs), starcoder2-15b (48 over
    # 4: rep 12), pixtral-12b (32 over 8: rep 4), musicgen-large (MHA at D
    # 64); and musicgen-large's train step (B 8, no cache)
    for key, what, gen_seed, bb, g_h, g_kv, dd, t_kv in (
            ("command_r_35b", "rep 8, command-r-35b", SEED + 45, b, 64, 8, hd, MAX_LEN),
            ("starcoder2_15b", "rep 12, starcoder2-15b", SEED + 46, b, 48, 4, hd, MAX_LEN),
            ("pixtral_12b", "rep 4, pixtral-12b", SEED + 47, b, 32, 8, hd, MAX_LEN),
            ("musicgen_large", "D 64 MHA, musicgen-large", SEED + 48, b, 32, 32, 64, MAX_LEN),
            ("musicgen_large_train", "D 64 MHA, musicgen-large train", SEED + 49, TRAIN_B, 32,
             32, 64, s)):
        r[key] = flash_fwd_case(what, gen_seed, bb, g_h, g_kv, dd, t_kv)
    emit({"phase": "kernel", **r,
          "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": hd, "q_offset": 0}})

    # decode: one layer's decode attention, at the serve runs' lengths
    # (cache_pos + 1: 513 to 576 of T = 1024), for chatglm3-6b (GQA, 16 heads
    # a kv head, D 128) and stablelm-3b (MHA, D 80); the bytes are those of
    # the live rows; every cluster size is checked and timed
    t = MAX_LEN
    qd = randn(b, h, hd)                       # the ragged-lengths case below
    lens_np = rng.integers(1, t + 1, size=(b,)).astype(np.int32)

    def decode_case(what, q_, ck_, cv_, lens_np_):
        """The kernel, its plain version and masked SDPA (the group expanded)
        at these inputs, checked: other_shape's arguments.  The lse output
        (for the merge over a sequence-split cache) and the fp32 output that
        comes with it are held to the plain version's at TOL_LSE and
        TOL_BF16 at every cluster size, and the fp32 output rounded is the
        bf16 output bit for bit."""
        lens_ = torch.from_numpy(lens_np_).to(dev)
        h_, d_, hkv_ = q_.shape[1], q_.shape[2], ck_.shape[2]
        out_ = decode_attention(q_, ck_, cv_, lens_)
        out32_, lse_ = decode_attention(q_, ck_, cv_, lens_, return_lse=True)
        ref_ = decode_attention_ref(q_, ck_, cv_, lens_)
        ref32_, rlse_ = decode_attention_ref(q_, ck_, cv_, lens_, return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out32_.to(out_.dtype), out_):
            raise AssertionError(f"decode_attention ({what}): the fp32 output with the lse, "
                                 "rounded, differs from the output without")
        kd_, vd_ = (c.transpose(1, 2).repeat_interleave(h_ // hkv_, dim=1) for c in (ck_, cv_))
        mask_ = (torch.arange(t, device=dev)[None, :] < lens_[:, None])[:, None, None, :]
        used = int(lens_np_.sum())
        clusters = {}
        for c in DECODE_CLUSTERS:
            oc, lc = decode_attention(q_, ck_, cv_, lens_, cluster=c, return_lse=True)
            torch.cuda.synchronize()
            over_c = max(excess(oc, ref32_, TOL_BF16), excess(lc, rlse_, TOL_LSE))
            if not torch.equal(oc.to(out_.dtype), decode_attention(q_, ck_, cv_, lens_,
                                                                   cluster=c)):
                over_c = max(over_c, float("inf"))
            if not over_c <= 0:
                raise AssertionError(f"decode_attention ({what}) with cluster {c} disagrees "
                                     f"with its plain version (excess {over_c})")
            clusters[str(c)] = time_ms(
                lambda c=c: decode_attention(q_, ck_, cv_, lens_, cluster=c), flush)
        # one launch combines the cluster's partials in a fixed order
        for _ in range(3):
            if not torch.equal(decode_attention(q_, ck_, cv_, lens_), out_):
                raise AssertionError(f"decode_attention ({what}) is not bitwise repeatable")
        args = (f"decode_attention ({what})",
                max(excess(out_, ref_, TOL_BF16), excess(lse_, rlse_, TOL_LSE)),
                lambda: decode_attention(q_, ck_, cv_, lens_),
                lambda: decode_attention_ref(q_, ck_, cv_, lens_),
                lambda: F.scaled_dot_product_attention(q_[:, :, None], kd_, vd_,
                                                       attn_mask=mask_),
                2 * used * hkv_ * d_ * 2 + 2 * q_.numel() * 2 + b * 4, 4 * d_ * h_ * used,
                PEAK_BF16, float((out_.float() - ref_.float()).abs().max()))
        extra = {"shape": {"B": b, "H": h_, "Hkv": hkv_, "T": t, "D": d_,
                           "lengths": lens_np_.tolist()},
                 "cluster": decode_cluster_size(b * hkv_ * decode_head_chunks(h_ // hkv_)),
                 "cluster_ms": clusters, "bitwise_repeatable": True,
                 "lse_max_abs_err": float((lse_ - rlse_).abs().max()), "lse_tol": TOL_LSE,
                 "out32_max_abs_err": float((out32_ - ref32_).abs().max())}
        return args, extra

    serve_lens = np.random.default_rng(SEED + 10).integers(
        SERVE_LENGTHS[0], SERVE_LENGTHS[1] + 1, size=(b,)).astype(np.int32)
    args, extra = decode_case("chatglm3-6b", xrandn(b, h, hd), ck, cv, serve_lens)
    what, over, kern, plain, lib, nbytes, flops, peak, err = args
    r = kernel_row("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:25", over, kern, plain, lib,
                   nbytes=nbytes, flops=flops, peak=peak)
    r["max_abs_err"] = err
    r.update(extra)
    ck8, cv8 = xrandn(b, t, h, 80), xrandn(b, t, h, 80)
    args, extra = decode_case("stablelm-3b", xrandn(b, h, 80), ck8, cv8, serve_lens)
    r["stablelm_3b"] = other_shape(*args, **extra)
    args, extra = decode_case("ragged lengths", qd, ck, cv, lens_np)
    r["ragged_lengths"] = other_shape(*args, **extra)
    # jamba-1.5-large-398b's decode steps (serve_hybrid): 64 query heads over
    # 8 kv heads (rep 8) at D 128, at the serve lengths; own generator
    drandn = bf16_normal(np.random.default_rng(SEED + 37), dev)
    ckj, cvj = drandn(b, t, 8, hd), drandn(b, t, 8, hd)
    args, extra = decode_case("jamba-1.5-large-398b", drandn(b, 64, hd), ckj, cvj, serve_lens)
    r["jamba_rep8"] = other_shape(*args, **extra)
    del ck8, cv8, ckj, cvj, args
    # the last four families' decode steps at the serve lengths, every
    # cluster size: command-r-35b (64 heads over 8, rep 8), starcoder2-15b
    # (48 over 4: rep 12), pixtral-12b (32 over 8: rep 4) and musicgen-large
    # (MHA at D 64: decode_kernel<64, 1>); own generators
    for key, what, gen_seed, g_h, g_kv, dd in (
            ("command_r_35b", "command-r-35b", SEED + 50, 64, 8, hd),
            ("starcoder2_15b", "starcoder2-15b", SEED + 51, 48, 4, hd),
            ("pixtral_12b", "pixtral-12b", SEED + 52, 32, 8, hd),
            ("musicgen_large", "musicgen-large", SEED + 53, 32, 32, 64)):
        drandn = bf16_normal(np.random.default_rng(gen_seed), dev)
        ckn, cvn = drandn(b, t, g_kv, dd), drandn(b, t, g_kv, dd)
        args, extra = decode_case(what, drandn(b, g_h, dd), ckn, cvn, serve_lens)
        r[key] = other_shape(*args, **extra)
        del ckn, cvn, args
    emit({"phase": "kernel", **r})

    # rmsnorm backward: every norm of the train step, [8 x 512, 4096]
    rows_t = TRAIN_B * TRAIN_S
    x = randn(rows_t, d, scale=3.0)
    dy = randn(rows_t, d)
    (dx, dsc), (rdx, rdsc) = rmsnorm_bwd(x, sc, dy), rmsnorm_bwd_ref(x, sc, dy)
    torch.cuda.synchronize()
    over = max(excess(dx, rdx, TOL_BF16),
               float((dsc.float() - rdsc.float()).abs().max())
               - TOL_DSCALE * float(rdsc.float().abs().max()))
    xl = x.detach().requires_grad_(True)
    scl = sc.detach().requires_grad_(True)
    r = kernel_row("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "none (JAX differentiates src/repro/kernels/rmsnorm/ref.py:5 with XLA)",
                   over, lambda: rmsnorm_bwd(x, sc, dy), lambda: rmsnorm_bwd_ref(x, sc, dy),
                   grad_fn(F.rms_norm(xl, (d,), scl, 1e-6), (xl, scl), dy),
                   nbytes=3 * x.numel() * 2 + 2 * d * 2, flops=10 * x.numel(),
                   peak=PEAK_F32)
    r["max_abs_err"] = float((dx.float() - rdx.float()).abs().max())
    # dscale's sums run in a fixed order: the same inputs give the same bits
    for _ in range(3):
        dx2, dsc2 = rmsnorm_bwd(x, sc, dy)
        if not (torch.equal(dx2, dx) and torch.equal(dsc2, dsc)):
            raise AssertionError("rmsnorm_bwd is not bitwise repeatable")
    r["bitwise_repeatable"] = True
    del dx2, dsc2
    def rms_bwd_case(gen_seed, dd, pitch=None, **extra):
        """The backward at another train-path shape, [rows_t, dd] with x's
        rows `pitch` apart, from its own generator: held by
        rmsnorm_bwd_check (bitwise repeatable too), timed as other_shape."""
        brandn_ = bf16_normal(np.random.default_rng(gen_seed), dev)
        pitch = pitch or dd
        xb, sb = brandn_(rows_t, pitch, scale=3.0)[:, :dd], 1.0 + 0.1 * brandn_(dd)
        dyb = brandn_(rows_t, dd)
        chk = rmsnorm_bwd_check(xb, sb, dyb)
        if not chk["bitwise_repeatable"]:
            raise AssertionError(f"rmsnorm_bwd [{rows_t}, {dd}] at pitch {pitch} is not "
                                 "bitwise repeatable")
        xbl, sbl = xb.detach().requires_grad_(True), sb.detach().requires_grad_(True)
        return other_shape(
            f"rmsnorm_bwd [{rows_t}, {dd}] at pitch {pitch}", chk["excess"],
            lambda: rmsnorm_bwd(xb, sb, dyb), lambda: rmsnorm_bwd_ref(xb, sb, dyb),
            grad_fn(F.rms_norm(xbl, (dd,), sbl, 1e-6), (xbl, sbl), dyb),
            3 * xb.numel() * 2 + 2 * dd * 2, 10 * xb.numel(), PEAK_F32,
            chk["max_abs_err"], shape=[rows_t, dd],
            **({"pitch": pitch} if pitch != dd else {}),
            dscale_max_abs_err=chk["dscale_max_abs_err"], bitwise_repeatable=True, **extra)

    # kv_norm's backward in deepseek-v2-lite-16b's and deepseek-v3-671b's
    # train steps: x the first 512 of each 576-column row, read at that pitch,
    # [8 x 512, 512].  Its ~12.6 MB take 0.0038 ms at 3.35 TB/s, under the
    # timer's 5.54 us floor: no share of the bound is read from it
    r["kv_norm_pitch576"] = rms_bwd_case(
        SEED + 17, 512, 576, bound_note="near the timer's 5.54 us floor: no ratio claimed")
    # attn_norm's and ffn_norm's backward in deepseek-v2-lite-16b's train
    # step: d 2048, [8 x 512, 2048]
    r["deepseek_v2_lite_d2048"] = rms_bwd_case(SEED + 20, 2048)
    # deepseek-v3-671b's train step (train_v3): attn_norm, ffn_norm, the
    # final and MTP norms at d 7168 (a 512-thread group holds a row, one to
    # two vectors of x and of dy a thread), q_norm at q-LoRA's 1536
    r["deepseek_v3_d7168"] = rms_bwd_case(SEED + 24, 7168)
    r["deepseek_v3_q_norm_d1536"] = rms_bwd_case(SEED + 25, 1536)
    # jamba-1.5-large-398b's train step: each Mamba layer's gated out_norm
    # over d_inner 16384 (four vectors of x and of dy a thread, the dscale
    # partial in shared memory); no phase trains jamba at full width (its
    # train state does not fit one card): the sweep's train_4k cells count it
    r["jamba_d16384"] = rms_bwd_case(SEED + 61, 16384, nvidia_smi=smi)
    torch.cuda.empty_cache()
    emit({"phase": "kernel", **r, "shape": [rows_t, d],
          "dscale_max_abs_err": float((dsc.float() - rdsc.float()).abs().max())})
    del x, dy, dx, dsc, rdx, rdsc, xl, scl

    # flash backward: one layer's attention gradient in the train step
    b, s = TRAIN_B, TRAIN_S
    q, k, v, do = flash_bwd_inputs(randn, b, s, h, hkv, hd)
    out, lse = flash_attention_fwd(q, k, v)
    (dq, delta), (rq, rdelta) = (flash_attention_bwd_dq(q, k, v, out, do, lse),
                                 attention_bwd_dq_ref(q, k, v, out, do, lse, q_offset=0))
    (dk, dv), (rk, rv) = (flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                          attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, q_offset=0))
    # stablelm-3b's train step: head dim 80, MHA
    q8, k8, v8, do8 = flash_bwd_inputs(xrandn, b, s, h, h, 80)
    out8, lse8 = flash_attention_fwd(q8, k8, v8)
    (dq8, delta8), (rq8, rdelta8) = (flash_attention_bwd_dq(q8, k8, v8, out8, do8, lse8),
                                     attention_bwd_dq_ref(q8, k8, v8, out8, do8, lse8,
                                                          q_offset=0))
    (dk8, dv8), (rk8, rv8) = (flash_attention_bwd_dkv(q8, k8, v8, do8, lse8, delta8),
                              attention_bwd_dkv_ref(q8, k8, v8, do8, lse8, rdelta8, q_offset=0))
    torch.cuda.synchronize()
    sdpa_bwd8 = sdpa_backward(q8, k8, v8, do8)
    qb8, kvb8, pairs = q8.numel() * 2, k8.numel() * 2, b * h * s * (s + 1) // 2
    shape8 = {"B": b, "H": h, "Hkv": h, "S": s, "D": 80, "causal": True}
    dq80 = other_shape("flash_attention_bwd_dq at D 80",
                       max(excess(dq8, rq8, TOL_BF16), excess(delta8, rdelta8, TOL_LSE)),
                       lambda: flash_attention_bwd_dq(q8, k8, v8, out8, do8, lse8),
                       lambda: attention_bwd_dq_ref(q8, k8, v8, out8, do8, lse8, q_offset=0),
                       sdpa_bwd8, 4 * qb8 + 2 * kvb8 + 2 * b * h * s * 4, 6 * 80 * pairs,
                       PEAK_BF16, float((dq8.float() - rq8.float()).abs().max()),
                       shape=shape8)
    dkv80 = other_shape("flash_attention_bwd_dkv at D 80",
                        max(excess(dk8, rk8, TOL_BF16), excess(dv8, rv8, TOL_BF16)),
                        lambda: flash_attention_bwd_dkv(q8, k8, v8, do8, lse8, delta8),
                        lambda: attention_bwd_dkv_ref(q8, k8, v8, do8, lse8, rdelta8,
                                                      q_offset=0),
                        sdpa_bwd8, 2 * qb8 + 4 * kvb8 + 2 * b * h * s * 4, 8 * 80 * pairs,
                        PEAK_BF16, max(float((dk8.float() - rk8.float()).abs().max()),
                                       float((dv8.float() - rv8.float()).abs().max())),
                        shape=shape8)
    del q8, k8, v8, do8, out8, lse8, dq8, delta8, rq8, rdelta8, dk8, dv8, rk8, rv8, sdpa_bwd8
    def flash_bwd_case(what, gen_seed, g_h, g_kv, dd):
        """A model's attention gradient at the train shape (B 8, S 512): dq,
        and dk/dv at every cluster size, each held to its plain version,
        both passes bitwise repeatable, timed beside SDPA's backward; its
        inputs from their own generator.  Returns the (dq, dk/dv) entries."""
        jrandn = bf16_normal(np.random.default_rng(gen_seed), dev)
        qj, kj, vj, doj = flash_bwd_inputs(jrandn, b, s, g_h, g_kv, dd)
        outj, lsej = flash_attention_fwd(qj, kj, vj)
        (dqj, deltaj), (rqj, rdeltaj) = (flash_attention_bwd_dq(qj, kj, vj, outj, doj, lsej),
                                         attention_bwd_dq_ref(qj, kj, vj, outj, doj, lsej,
                                                              q_offset=0))
        (dkj, dvj), (rkj, rvj) = (flash_attention_bwd_dkv(qj, kj, vj, doj, lsej, deltaj),
                                  attention_bwd_dkv_ref(qj, kj, vj, doj, lsej, rdeltaj,
                                                        q_offset=0))
        torch.cuda.synchronize()
        for _ in range(3):
            dq2, delta2 = flash_attention_bwd_dq(qj, kj, vj, outj, doj, lsej)
            dk2, dv2 = flash_attention_bwd_dkv(qj, kj, vj, doj, lsej, deltaj)
            if not all(torch.equal(x, y) for x, y in ((dq2, dqj), (delta2, deltaj),
                                                     (dk2, dkj), (dv2, dvj))):
                raise AssertionError(f"the flash backward ({what}) is not bitwise repeatable")
        cluster_ms_j = {}
        for c in DKV_CLUSTERS:
            ck_, cv_ = flash_attention_bwd_dkv(qj, kj, vj, doj, lsej, deltaj, cluster=c)
            torch.cuda.synchronize()
            over_c = max(excess(ck_, rkj, TOL_BF16), excess(cv_, rvj, TOL_BF16))
            if not over_c <= 0:
                raise AssertionError(f"flash_attention_bwd_dkv ({what}) with cluster {c} "
                                     f"disagrees with its plain version (excess over "
                                     f"tolerance {over_c})")
            cluster_ms_j[str(c)] = time_ms(
                lambda c=c: flash_attention_bwd_dkv(qj, kj, vj, doj, lsej, deltaj, cluster=c),
                flush)
        sdpa_bwdj = sdpa_backward(qj, kj, vj, doj)
        qbj, kvbj, rowbj = qj.numel() * 2, kj.numel() * 2, b * g_h * s * 4
        pairs_j = b * g_h * s * (s + 1) // 2
        shape_j = {"B": b, "H": g_h, "Hkv": g_kv, "S": s, "D": dd, "causal": True}
        dq_entry = other_shape(
            f"flash_attention_bwd_dq ({what})",
            max(excess(dqj, rqj, TOL_BF16), excess(deltaj, rdeltaj, TOL_LSE)),
            lambda: flash_attention_bwd_dq(qj, kj, vj, outj, doj, lsej),
            lambda: attention_bwd_dq_ref(qj, kj, vj, outj, doj, lsej, q_offset=0),
            sdpa_bwdj, 4 * qbj + 2 * kvbj + 2 * rowbj, 6 * dd * pairs_j, PEAK_BF16,
            float((dqj.float() - rqj.float()).abs().max()), shape=shape_j,
            bitwise_repeatable=True)
        dkv_entry = other_shape(
            f"flash_attention_bwd_dkv ({what})",
            max(excess(dkj, rkj, TOL_BF16), excess(dvj, rvj, TOL_BF16)),
            lambda: flash_attention_bwd_dkv(qj, kj, vj, doj, lsej, deltaj),
            lambda: attention_bwd_dkv_ref(qj, kj, vj, doj, lsej, rdeltaj, q_offset=0),
            sdpa_bwdj, 2 * qbj + 4 * kvbj + 2 * rowbj, 8 * dd * pairs_j, PEAK_BF16,
            max(float((dkj.float() - rkj.float()).abs().max()),
                float((dvj.float() - rvj.float()).abs().max())), shape=shape_j,
            cluster=dkv_cluster_size(g_h // g_kv, b * g_kv * s // 64), cluster_ms=cluster_ms_j,
            bitwise_repeatable=True)
        return dq_entry, dkv_entry

    # jamba-1.5-large-398b's attention gradient at full width (64 query heads
    # over 8 kv heads, GQA rep 8, D 128): nested in the two rows as jamba_rep8.
    # starcoder2-15b's (48 over 4: rep 12, whose dk/dv cluster of 8 splits a
    # kv head's 12 query heads 1 or 2 a rank) and musicgen-large's (MHA at D
    # 64), nested as starcoder2_15b and musicgen_large
    bwd_cases = {key: flash_bwd_case(what, gen_seed, g_h, g_kv, dd)
                 for key, what, gen_seed, g_h, g_kv, dd in (
                     ("jamba_rep8", "rep 8, jamba-1.5-large-398b", SEED + 38, 64, 8, hd),
                     ("starcoder2_15b", "rep 12, starcoder2-15b", SEED + 54, 48, 4, hd),
                     ("musicgen_large", "D 64 MHA, musicgen-large", SEED + 55, 32, 32, 64))}
    torch.cuda.empty_cache()
    sdpa_bwd = sdpa_backward(q, k, v, do)
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, b * h * s * 4   # bytes of each
    r = kernel_row("flash_attention_bwd_dq",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/kernel.py:125",
                   max(excess(dq, rq, TOL_BF16), excess(delta, rdelta, TOL_LSE)),
                   lambda: flash_attention_bwd_dq(q, k, v, out, do, lse),
                   lambda: attention_bwd_dq_ref(q, k, v, out, do, lse, q_offset=0),
                   sdpa_bwd,      # dq, dk and dv in one call
                   nbytes=4 * qb + 2 * kvb + 2 * rowb, flops=6 * hd * pairs,
                   peak=PEAK_BF16)
    r["max_abs_err"] = float((dq.float() - rq.float()).abs().max())
    # the pass writes each row from one warpgroup's registers, no atomics:
    # the same inputs give the same bits
    for _ in range(3):
        dq2, delta2 = flash_attention_bwd_dq(q, k, v, out, do, lse)
        if not (torch.equal(dq2, dq) and torch.equal(delta2, delta)):
            raise AssertionError("flash_attention_bwd_dq is not bitwise repeatable")
    r["bitwise_repeatable"] = True
    r["head_dim_80"] = dq80
    r.update({key: dq_dkv[0] for key, dq_dkv in bwd_cases.items()})
    del dq2, delta2
    # rep 1 (MHA) at head dim 128 on an odd number of q tiles (7): a block's
    # two warpgroups take two adjacent q tiles of a head, and the last item
    # of each head holds tile 0 alone
    s1 = 7 * 64
    q1, k1, v1, do1 = flash_bwd_inputs(xrandn, BATCH, s1, h, h, hd)
    out1, lse1 = flash_attention_fwd(q1, k1, v1)
    (dq1, delta1), (rq1, rdelta1) = (flash_attention_bwd_dq(q1, k1, v1, out1, do1, lse1),
                                     attention_bwd_dq_ref(q1, k1, v1, out1, do1, lse1,
                                                          q_offset=0))
    torch.cuda.synchronize()
    pairs1 = BATCH * h * s1 * (s1 + 1) // 2
    r["rep1_odd_q_tiles"] = other_shape(
        "flash_attention_bwd_dq at rep 1, D 128, 7 q tiles",
        max(excess(dq1, rq1, TOL_BF16), excess(delta1, rdelta1, TOL_LSE)),
        lambda: flash_attention_bwd_dq(q1, k1, v1, out1, do1, lse1),
        lambda: attention_bwd_dq_ref(q1, k1, v1, out1, do1, lse1, q_offset=0),
        sdpa_backward(q1, k1, v1, do1), 6 * q1.numel() * 2 + 2 * BATCH * h * s1 * 4,
        6 * hd * pairs1, PEAK_BF16, float((dq1.float() - rq1.float()).abs().max()),
        shape={"B": BATCH, "H": h, "Hkv": h, "S": s1, "D": hd, "causal": True})
    del q1, k1, v1, do1, out1, lse1, dq1, delta1, rq1, rdelta1
    # the whole backward as the train step runs it (dq, then dk/dv), beside
    # SDPA's backward, timed here
    r["flash_attention_bwd"] = {
        "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do), flush),
        "sdpa_backward_ms": time_ms(sdpa_bwd, flush),
        "covers": "dq + dk + dv (SDPA with the GQA group expanded)"}
    emit({"phase": "kernel", **r, "library_covers": "dq+dk+dv (SDPA backward, GQA expanded)",
          "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": hd, "causal": True}})
    r = kernel_row("flash_attention_bwd_dkv",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/kernel.py:162",
                   max(excess(dk, rk, TOL_BF16), excess(dv, rv, TOL_BF16)),
                   lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                   lambda: attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, q_offset=0),
                   sdpa_bwd,
                   nbytes=2 * qb + 4 * kvb + 2 * rowb, flops=8 * hd * pairs,
                   peak=PEAK_BF16)
    r["max_abs_err"] = max(float((dk.float() - rk.float()).abs().max()),
                           float((dv.float() - rv.float()).abs().max()))
    # the cluster that splits each kv tile's GQA group: the wrapper's choice,
    # and every size against the plain version and timed
    r["cluster"] = dkv_cluster_size(h // hkv, b * hkv * s // 64)
    r["cluster_ms"] = {}
    for c in DKV_CLUSTERS:
        ck_, cv_ = flash_attention_bwd_dkv(q, k, v, do, lse, delta, cluster=c)
        torch.cuda.synchronize()
        over_c = max(excess(ck_, rk, TOL_BF16), excess(cv_, rv, TOL_BF16))
        if not over_c <= 0:
            raise AssertionError(f"flash_attention_bwd_dkv with cluster {c} disagrees with "
                                 f"its plain version (excess over tolerance {over_c})")
        r["cluster_ms"][str(c)] = time_ms(
            lambda c=c: flash_attention_bwd_dkv(q, k, v, do, lse, delta, cluster=c), flush)
    r["head_dim_80"] = dkv80
    r.update({key: dq_dkv[1] for key, dq_dkv in bwd_cases.items()})
    del ck_, cv_, bwd_cases
    emit({"phase": "kernel", **r, "library_covers": "dq+dk+dv (SDPA backward, GQA expanded)",
          "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": hd, "causal": True}})
    del q, k, v, do, out, lse, dq, delta, rq, rdelta, dk, dv, rk, rv, sdpa_bwd

    # MLA's expanded branch: the <192, 128> instances of the three passes at
    # q, k [8, H, 512, 192], v [8, H, 512, 128] (MHA, causal), at
    # deepseek-v2-lite-16b's 16 heads (train_moe) and deepseek-v3-671b's 128
    # (train_v3), each held to its plain version and bitwise repeatable
    # (mla_flash_check), timed beside SDPA, the bound by causal pairs
    # (mla_flash_work); at 16 heads also a tail at S 200, checked.  Nested in
    # the three flash rows as dqk192_dv128 and dqk192_dv128_h128.
    t_mla = time.perf_counter()
    mla_rows, backends = {}, {}
    for heads, key_h, gen_seed, lengths in ((MLA_HEADS, "dqk192_dv128", SEED + 16,
                                             (200, TRAIN_S)),
                                            (V3_HEADS, "dqk192_dv128_h128", SEED + 26,
                                             (TRAIN_S,))):
        mrandn = bf16_normal(np.random.default_rng(gen_seed), dev)
        checks = {}
        for s_ in lengths:
            margs = mla_flash_inputs(mrandn, TRAIN_B, s_, heads)
            chk = mla_flash_check(*margs)
            if not (chk["shapes_ok"] and all(e <= 0 for e in chk["excess"].values())
                    and all(chk["bitwise_repeatable"].values())):
                raise AssertionError(f"flash <{MLA_DQK}, {MLA_DV}> at H {heads} S {s_}: {chk}")
            checks[s_] = chk
        q, k, v, do = margs
        out, lse = flash_attention_fwd(q, k, v)
        dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse)
        backend, sdpa_fwd, sdpa_bwd = sdpa_any_backend(q, k, v, do)
        backends[heads] = backend
        work = mla_flash_work(TRAIN_B, TRAIN_S, heads)
        passes = {
            "flash_attention_fwd": ("fwd", lambda: flash_attention_fwd(q, k, v),
                                    lambda: attention_with_lse_ref(q, k, v, q_offset=0),
                                    sdpa_fwd),
            "flash_attention_bwd_dq": ("dq",
                                       lambda: flash_attention_bwd_dq(q, k, v, out, do, lse),
                                       lambda: attention_bwd_dq_ref(q, k, v, out, do, lse,
                                                                    q_offset=0), sdpa_bwd),
            "flash_attention_bwd_dkv": ("dkv",
                                        lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                                        lambda: attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                                      q_offset=0), sdpa_bwd)}
        for name, (key, kern, plain, lib) in passes.items():
            nbytes, flops = work[key]
            b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
            inst = {
                "shape": {"B": TRAIN_B, "H": heads, "Hkv": heads, "S": TRAIN_S,
                          "D": MLA_DQK, "DV": MLA_DV, "causal": True},
                "max_abs_err": checks[TRAIN_S]["max_abs_err"][key],
                "excess_at_tol": checks[TRAIN_S]["excess"][key], "bitwise_repeatable": True,
                "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
                "library_ms": time_ms(lib, flush),
                "library": f"SDPA ({backend} backend)"
                           + (", dq+dk+dv in one backward" if key != "fwd" else ""),
                "bound_ms": b_ms, "bound_by": b_by, "gbytes": nbytes / 1e9,
                "gflop": flops / 1e9,
                "causal_pairs": TRAIN_B * heads * TRAIN_S * (TRAIN_S + 1) // 2}
            if 200 in checks:
                inst["tail_S200"] = {"excess_at_tol": checks[200]["excess"][key],
                                     "max_abs_err": checks[200]["max_abs_err"][key],
                                     "bitwise_repeatable": True}
            mla_rows.setdefault(key_h, {})[name] = inst
            next(row for row in rows if row["name"] == name)[key_h] = inst
        del q, k, v, do, out, lse, dq, delta, margs, sdpa_fwd, sdpa_bwd, passes
        torch.cuda.empty_cache()
    emit({"phase": "kernel_mla_flash", "instances": mla_rows, "sdpa_backends": backends,
          "seconds": time.perf_counter() - t_mla})

    # fused cross-entropy: one of the train step's 8 chunks, [8 x 64, 65024]
    vocab = get_config(ARCH).vocab_size
    rows_c = TRAIN_B * TRAIN_S // CE_CHUNKS
    logits = randn(rows_c, vocab, scale=2.0)
    labels = torch.from_numpy(rng.integers(0, vocab, rows_c)).to(dev)
    cmask = torch.from_numpy((rng.random(rows_c) > 0.1).astype(np.float32)).to(dev)
    g = torch.ones(rows_c, device=dev)
    (nll, lse), (rn, rl) = fused_ce(logits, labels, cmask), ce_rows_ref(logits, labels, cmask)
    dl, rdl = fused_ce_bwd(logits, labels, cmask, lse, g), ce_bwd_ref(logits, labels, cmask, rl, g)
    torch.cuda.synchronize()
    lgl = logits.detach().requires_grad_(True)
    ce_lib = (F.cross_entropy(lgl, labels, reduction="none") * cmask).sum()
    rowsb = rows_c * (8 + 4)                                   # labels + mask
    r = kernel_row("fused_ce", "src/repro_torch/kernels/csrc/cross_entropy.cu",
                   "src/repro/kernels/cross_entropy/kernel.py:25",
                   max(excess(nll, rn, TOL_CE), excess(lse, rl, TOL_CE)),
                   lambda: fused_ce(logits, labels, cmask),
                   lambda: ce_rows_ref(logits, labels, cmask),
                   lambda: (F.cross_entropy(logits, labels, reduction="none") * cmask).sum(),
                   nbytes=logits.numel() * 2 + rowsb + rows_c * 8,
                   flops=4 * logits.numel(), peak=PEAK_F32)
    r["max_abs_err"] = float((nll - rn).abs().max())

    def ce_case(gen_seed, rows_, vocab_):
        """The CE forward and backward at another train-path shape, [rows_,
        vocab_] logits from their own generator (`ce_inputs`), held by
        ce_check and timed as other_shape: (forward, backward) entries."""
        lv, lab_v, mask_v, g_ = ce_inputs(np.random.default_rng(gen_seed), dev, rows_, vocab_)
        chk = ce_check(lv, lab_v, mask_v, g_)
        lsv, rlv = fused_ce(lv, lab_v, mask_v)[1], ce_rows_ref(lv, lab_v, mask_v)[1]
        rows_b = rows_ * (8 + 4)                               # labels + mask
        fwd = other_shape(
            f"fused_ce [{rows_}, {vocab_}]", chk["excess"]["fwd"],
            lambda: fused_ce(lv, lab_v, mask_v), lambda: ce_rows_ref(lv, lab_v, mask_v),
            lambda: (F.cross_entropy(lv, lab_v, reduction="none") * mask_v).sum(),
            lv.numel() * 2 + rows_b + rows_ * 8, 4 * lv.numel(), PEAK_F32,
            chk["max_abs_err"]["nll"], shape=[rows_, vocab_],
            lse_max_abs_err=chk["max_abs_err"]["lse"])
        lvl = lv.detach().requires_grad_(True)
        bwd = other_shape(
            f"fused_ce_bwd [{rows_}, {vocab_}]", chk["excess"]["bwd"],
            lambda: fused_ce_bwd(lv, lab_v, mask_v, lsv, g_),
            lambda: ce_bwd_ref(lv, lab_v, mask_v, rlv, g_),
            grad_fn((F.cross_entropy(lvl, lab_v, reduction="none") * mask_v).sum(), (lvl,), None),
            2 * lv.numel() * 2 + rows_b + rows_ * 8, 4 * lv.numel(), PEAK_F32,
            chk["max_abs_err"]["dlogits"], shape=[rows_, vocab_])
        return fwd, bwd

    # deepseek-v2-lite-16b's vocab (train_moe): one of its 8 chunks, [512,
    # 102400], 100 whole 1024-column blocks where 65024 ends in half of one;
    # deepseek-v3-671b's (train_v3): 129280 (126.25 blocks), one of the main
    # loss's 8 chunks [512, 129280] and one of the MTP loss's 7, [8 x 73 =
    # 584, 129280].  The backward entries are nested in its row below
    ce_v2 = ce_case(SEED + 21, rows_c, get_config(MOE_ARCH).vocab_size)
    vocab_v3 = get_config(V3_ARCH).vocab_size
    rows_mtp = TRAIN_B * ((TRAIN_S - 1) // ce_chunks_of(TRAIN_S - 1))
    ce_v3 = {f"{n}x{vocab_v3}": ce_case(gen_seed, n, vocab_v3)
             for gen_seed, n in ((SEED + 27, rows_c), (SEED + 28, rows_mtp))}
    # command-r-35b's tied vocab 256000 (train_command_r: 250 whole 1024-column
    # blocks, twice the widest row so far) and musicgen-large's 2048
    # (train_musicgen), one of 8 chunks each
    ce_new = {f"{name}_vocab": ce_case(gen_seed, rows_c, get_config(arch).vocab_size)
              for name, arch, gen_seed in (("command_r_35b", CR_ARCH, SEED + 56),
                                           ("musicgen_large", MG_ARCH, SEED + 57))}
    r["deepseek_v2_lite_vocab"] = ce_v2[0]
    r["deepseek_v3_vocab"] = {name: fb[0] for name, fb in ce_v3.items()}
    r.update({name: fb[0] for name, fb in ce_new.items()})
    emit({"phase": "kernel", **r, "shape": [rows_c, vocab]})
    torch.cuda.empty_cache()
    r = kernel_row("fused_ce_bwd", "src/repro_torch/kernels/csrc/cross_entropy.cu",
                   "none (JAX differentiates src/repro/kernels/cross_entropy/ref.py:5)",
                   excess(dl, rdl, TOL_BF16),
                   lambda: fused_ce_bwd(logits, labels, cmask, lse, g),
                   lambda: ce_bwd_ref(logits, labels, cmask, rl, g),
                   grad_fn(ce_lib, (lgl,), None),
                   nbytes=2 * logits.numel() * 2 + rowsb + rows_c * 8,
                   flops=4 * logits.numel(), peak=PEAK_F32)
    r["max_abs_err"] = float((dl.float() - rdl.float()).abs().max())
    r["deepseek_v2_lite_vocab"] = ce_v2[1]
    r["deepseek_v3_vocab"] = {name: fb[1] for name, fb in ce_v3.items()}
    r.update({name: fb[1] for name, fb in ce_new.items()})
    emit({"phase": "kernel", **r, "shape": [rows_c, vocab]})
    del logits, labels, cmask, g, nll, lse, rn, rl, dl, rdl, lgl, ce_lib, ck, cv

    # SSD scan: one layer's prefill scan of mamba2-130m, x, B and C as the
    # model passes them (slices of one conv output), from the cache's zero state
    scfg = get_config(SSM_ARCH)
    ps, ns = scfg.ssm.head_dim, scfg.ssm.d_state
    hs = scfg.ssm.expand * scfg.d_model // ps

    with torch.inference_mode():
        sargs, h0 = ssd_inputs(randn, rng, dev, BATCH, SSM_PROMPT, hs, ps, ns, 0.0)
        (y, hf), (ry, rh) = (ssd_scan(*sargs, h0=h0),
                             ssd_scan_ref(*sargs, chunk=scfg.ssm.chunk, h0=h0))
        # the tail: S = 8193 (one row past a chunk), from a nonzero state
        targs, th0 = ssd_inputs(randn, rng, dev, BATCH, SSM_PROMPT + 1, hs, ps, ns, 0.3)
        (ty, thf), (rty, rth) = (ssd_scan(*targs, h0=th0),
                                 ssd_scan_ref(*targs, chunk=scfg.ssm.chunk, h0=th0))
        torch.cuda.synchronize()
        over = max(excess(y, ry, TOL_BF16), excess(hf, rh, TOL_BF16))
        tail_over = max(excess(ty, rty, TOL_BF16), excess(thf, rth, TOL_BF16))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, hf, ty, thf))
        if not (finite and tail_over <= 0):
            raise AssertionError(f"ssd_scan at S = {SSM_PROMPT + 1} from a nonzero state "
                                 f"disagrees with its plain version (excess {tail_over}, "
                                 f"finite {finite})")
        # beside TOL_BF16, the kernel and the plain version against the fp64
        # recurrence: the kernel is gated, the plain version's error is shown
        rel = {"serve": ssd_rel_errors(sargs, h0, {"kernel": (y, hf), "plain": (ry, rh)}),
               "tail": ssd_rel_errors(targs, th0, {"kernel": (ty, thf), "plain": (rty, rth)})}
        worst = max(max(e["kernel"].values()) for e in rel.values())
        if not worst <= TOL_SSD_REL_L2:
            raise AssertionError(f"ssd_scan is further from the fp64 recurrence than "
                                 f"{TOL_SSD_REL_L2} (relative L2): {rel}")
        n_chunks = -(-SSM_PROMPT // SSD_CHUNK)
        r_bytes, tc_ops = ssd_fwd_work(BATCH, SSM_PROMPT, hs, ps, ns)
        r = kernel_row("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_scan/kernel.py:28", over,
                       lambda: ssd_scan(*sargs, h0=h0),
                       lambda: ssd_scan_ref(*sargs, chunk=scfg.ssm.chunk, h0=h0),
                       None,          # no single PyTorch call computes the scan
                       nbytes=r_bytes, flops=tc_ops, peak=PEAK_BF16)
    r["max_abs_err"] = max(float((y - ry).abs().max()), float((hf - rh).abs().max()))
    # A yardstick for the earlier CUDA-core design's time, the bound that
    # design was held to: the same bytes, and the algorithm's operations
    # (64-row chunks) per (batch, head, chunk), the causal quadratic term
    # L(L+1) P and the inter-chunk term and state update 4 L N P in fp32 on
    # the CUDA cores; C B^T on the tensor cores, L(L+1) N per (batch,
    # chunk), expressed as fp32-rate operations.
    f32_ops = BATCH * hs * n_chunks * (SSD_CHUNK * (SSD_CHUNK + 1) * ps
                                       + 4 * SSD_CHUNK * ns * ps)
    bf16_ops = BATCH * n_chunks * SSD_CHUNK * (SSD_CHUNK + 1) * ns
    yard_ms, yard_by = bound(r_bytes, f32_ops + bf16_ops * PEAK_F32 / PEAK_BF16, PEAK_F32)
    # jamba-1.5-large-398b's prefill scan (serve_hybrid): x [4, 512, 256, 64]
    # at N 16 (the kernel's N 16 instance), slices of one conv output, from
    # the cache's zero state; and a 513-row tail from a nonzero state.  Held
    # as the row above: against the plain version at TOL_BF16 and against the
    # fp64 recurrence at TOL_SSD_REL_L2.  Own generator
    jcfg = get_config(HYBRID_ARCH)
    pj, nj = jcfg.ssm.head_dim, jcfg.ssm.d_state
    hj = jcfg.ssm.expand * jcfg.d_model // pj
    jrng = np.random.default_rng(SEED + 38)
    jrandn = bf16_normal(jrng, dev)
    with torch.inference_mode():
        jargs, jh0 = ssd_inputs(jrandn, jrng, dev, BATCH, PROMPT, hj, pj, nj, 0.0)
        (jy, jhf), (jry, jrh) = (ssd_scan(*jargs, h0=jh0),
                                 ssd_scan_ref(*jargs, chunk=jcfg.ssm.chunk, h0=jh0))
        jtargs, jth0 = ssd_inputs(jrandn, jrng, dev, BATCH, PROMPT + 1, hj, pj, nj, 0.3)
        (jty, jthf), (jrty, jrth) = (ssd_scan(*jtargs, h0=jth0),
                                     ssd_scan_ref(*jtargs, chunk=jcfg.ssm.chunk, h0=jth0))
        torch.cuda.synchronize()
        over_j = max(excess(jy, jry, TOL_BF16), excess(jhf, jrh, TOL_BF16))
        tail_j = max(excess(jty, jrty, TOL_BF16), excess(jthf, jrth, TOL_BF16))
        finite = all(bool(torch.isfinite(t).all()) for t in (jy, jhf, jty, jthf))
        if not (finite and tail_j <= 0):
            raise AssertionError(f"ssd_scan at N {nj}, S = {PROMPT + 1} from a nonzero state "
                                 f"disagrees with its plain version (excess {tail_j}, "
                                 f"finite {finite})")
        rel_j = {"serve": ssd_rel_errors(jargs, jh0, {"kernel": (jy, jhf), "plain": (jry, jrh)}),
                 "tail": ssd_rel_errors(jtargs, jth0, {"kernel": (jty, jthf),
                                                       "plain": (jrty, jrth)})}
        worst = max(max(e["kernel"].values()) for e in rel_j.values())
        if not worst <= TOL_SSD_REL_L2:
            raise AssertionError(f"ssd_scan at N {nj} is further from the fp64 recurrence than "
                                 f"{TOL_SSD_REL_L2} (relative L2): {rel_j}")
        nbytes_j, ops_j = ssd_fwd_work(BATCH, PROMPT, hj, pj, nj)
        r["jamba_n16"] = other_shape(
            f"ssd_scan at N {nj} (jamba-1.5-large-398b)", over_j,
            lambda: ssd_scan(*jargs, h0=jh0),
            lambda: ssd_scan_ref(*jargs, chunk=jcfg.ssm.chunk, h0=jh0), None,
            nbytes_j, ops_j, PEAK_BF16,
            max(float((jy - jry).abs().max()), float((jhf - jrh).abs().max())),
            shape={"B": BATCH, "S": PROMPT, "H": hj, "P": pj, "N": nj,
                   "x_strides": list(jargs[0].stride()), "kernel_chunk": SSD_CHUNK},
            gflop_bf16=ops_j / 1e9, rel_l2_vs_fp64=rel_j["serve"],
            tail_check={"S": PROMPT + 1, "h0": "N(0, 0.3^2)", "excess_at_tol": tail_j,
                        "max_abs_err": max(float((jty - jrty).abs().max()),
                                           float((jthf - jrth).abs().max())),
                        "rel_l2_vs_fp64": rel_j["tail"]})
    del jargs, jh0, jy, jhf, jry, jrh, jtargs, jth0, jty, jthf, jrty, jrth
    emit({"phase": "kernel", **r, "tol": TOL_BF16,
          "shape": {"B": BATCH, "S": SSM_PROMPT, "H": hs, "P": ps, "N": ns,
                    "x_strides": list(sargs[0].stride()), "kernel_chunk": SSD_CHUNK},
          "bound_type": "bf16 tensor cores (split operands)", "gflop_bf16": tc_ops / 1e9,
          "fp32_yardstick": {"ms": yard_ms, "by": yard_by,
                             "gflop": {"fp32": f32_ops / 1e9, "bf16": bf16_ops / 1e9}},
          "y_max_abs_err": float((y - ry).abs().max()),
          "h_final_max_abs_err": float((hf - rh).abs().max()),
          "y_absmax": float(ry.abs().max()),
          "rel_l2_vs_fp64": rel["serve"], "tol_rel_l2": TOL_SSD_REL_L2,
          "tail_check": {"S": SSM_PROMPT + 1, "h0": "N(0, 0.3^2)",
                         "max_abs_err": max(float((ty - rty).abs().max()),
                                            float((thf - rth).abs().max())),
                         "y_max_abs_err": float((ty - rty).abs().max()),
                         "h_final_max_abs_err": float((thf - rth).abs().max()),
                         "rel_l2_vs_fp64": rel["tail"],
                         "excess_at_tol": tail_over}})
    del sargs, h0, y, hf, ry, rh, targs, th0, ty, thf, rty, rth
    torch.cuda.empty_cache()

    # SSD scan backward: one layer's scan gradient in mamba2-130m's train step
    # (8 x 2048 tokens, x, B and C slices of one conv output, from no state,
    # no gradient on the final state), and a tail: S = 2049 from a nonzero
    # state with a gradient on the final state.  Every gradient against the
    # plain version, against fp64 autograd of the plain scan, and bitwise
    # repeatable; its own generator leaves the other rows' inputs as they were
    t_bwd = time.perf_counter()
    brng = np.random.default_rng(SEED + 13)
    names = ("dx", "ddt", "da_log", "dB", "dC", "dh0")
    checks = {}
    # jamba-1.5-large-398b's shape: a full-width train step's scan gradient,
    # [8, 512, 256, 64] at P 64, N 16 (the backward's P 64, N 16 instances),
    # from no state; its own generator
    jrng = np.random.default_rng(SEED + 39)
    for what, rng_, s_, hb, pb, nb_, h0_scale, with_dhf in (
            ("train", brng, SSM_TRAIN_S, hs, ps, ns, 0.0, False),
            ("tail", brng, SSM_TRAIN_S + 1, hs, ps, ns, 0.3, True),
            ("jamba", jrng, PROMPT, hj, pj, nj, 0.0, False)):
        bargs, bh0 = ssd_inputs(bf16_normal(rng_, dev), rng_, dev, TRAIN_B, s_, hb, pb, nb_,
                                h0_scale)
        bh0 = bh0 if h0_scale else None
        bdy = torch.from_numpy(rng_.standard_normal((TRAIN_B, s_, hb, pb),
                                                    dtype=np.float32)).to(dev)
        bdhf = (torch.from_numpy(rng_.standard_normal((TRAIN_B, hb, pb, nb_), dtype=np.float32))
                .to(dev) if with_dhf else None)
        got = ssd_scan_bwd(*bargs, bh0, bdy, bdhf)
        # the plain version at the kernel's 64-row chunks: at 256 its own fp32
        # error in ddt, where the exponents' gradients cancel over a longer
        # chunk, is ~3x the kernel's (both against fp64), and elementwise
        # TOL_BF16 sees it at the rows where ddt is near 0
        want = ssd_scan_bwd_ref(*bargs, bh0, bdy, bdhf, chunk=SSD_CHUNK)
        exact = ssd_grads_f64(ssd_scan_ref, bargs, bh0, bdy, bdhf, chunk=scfg.ssm.chunk)
        torch.cuda.synchronize()
        pairs = [(nm, g, w, e) for nm, g, w, e in zip(names, got, want, exact) if g is not None]
        over = max(excess(g, w, TOL_BF16) for _, g, w, _ in pairs)
        finite = all(bool(torch.isfinite(g.float()).all()) for _, g, _, _ in pairs)
        # bf16 outputs against the fp64 gradient rounded to bf16; fp32 ones
        # against the fp64 gradient itself
        rel = {nm: rel_l2(g, e.to(g.dtype)) for nm, g, _, e in pairs}
        rel_raw = {nm: rel_l2(g, e) for nm, g, _, e in pairs if g.dtype == torch.bfloat16}
        floor = {nm: rel_l2(e.to(g.dtype), e) for nm, g, _, e in pairs
                 if g.dtype == torch.bfloat16}
        for _ in range(2):      # every sum in a fixed order: the same bits
            again = ssd_scan_bwd(*bargs, bh0, bdy, bdhf)
            if not all(torch.equal(a, g) for a, g in zip(again, got) if g is not None):
                raise AssertionError(f"ssd_scan_bwd ({what}) is not bitwise repeatable")
        if not (finite and over <= 0 and max(rel.values()) <= TOL_SSD_BWD_REL_L2):
            raise AssertionError(f"ssd_scan_bwd ({what}): excess over TOL_BF16 against the "
                                 f"plain version {over}, finite {finite}, relative L2 against "
                                 f"fp64 {rel} (tol {TOL_SSD_BWD_REL_L2})")
        checks[what] = {
            "B": TRAIN_B, "S": s_, "H": hb, "P": pb, "N": nb_,
            "h0": "N(0, 0.3^2)" if h0_scale else None,
            "dh_final": "N(0, 1)" if with_dhf else None, "excess_at_tol": over,
            "max_abs_err": {nm: float((g.float() - w.float()).abs().max())
                            for nm, g, w, _ in pairs},
            "rel_l2_vs_fp64": rel, "bf16_rel_l2_vs_unrounded_fp64": rel_raw,
            "bf16_rounding_floor": floor, "bitwise_repeatable": True}
        if what == "train":
            nbytes, tc_ops, f32_ops = ssd_bwd_work(TRAIN_B, s_, hs, ps, ns)
            r = kernel_row("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                           "none (JAX differentiates src/repro/models/ssm.py:83 ssd_chunked "
                           "with XLA)", over,
                           lambda a=bargs, d=bdy: ssd_scan_bwd(*a, None, d, None),
                           lambda a=bargs, d=bdy: ssd_scan_bwd_ref(*a, None, d, None,
                                                                   chunk=SSD_CHUNK),
                           None,      # no single PyTorch call computes the scan's gradient
                           nbytes=nbytes, flops=tc_ops, peak=PEAK_BF16)
            r["max_abs_err"] = max(checks[what]["max_abs_err"].values())
            shape = {"B": TRAIN_B, "S": s_, "H": hs, "P": ps, "N": ns,
                     "x_strides": list(bargs[0].stride()), "kernel_chunk": SSD_CHUNK}
        if what == "jamba":
            nbytes_j, tc_j, _ = ssd_bwd_work(TRAIN_B, s_, hb, pb, nb_)
            r["jamba_p64_n16"] = other_shape(
                f"ssd_scan_bwd at P {pb}, N {nb_} (jamba-1.5-large-398b)", over,
                lambda a=bargs, d=bdy: ssd_scan_bwd(*a, None, d, None),
                lambda a=bargs, d=bdy: ssd_scan_bwd_ref(*a, None, d, None, chunk=SSD_CHUNK),
                None, nbytes_j, tc_j, PEAK_BF16, max(checks[what]["max_abs_err"].values()),
                shape={"B": TRAIN_B, "S": s_, "H": hb, "P": pb, "N": nb_,
                       "x_strides": list(bargs[0].stride()), "kernel_chunk": SSD_CHUNK},
                gflop_bf16=tc_j / 1e9, gbytes=nbytes_j / 1e9, check=checks[what])
        del bargs, bh0, bdy, bdhf, got, want, exact, pairs, again
        torch.cuda.empty_cache()
    emit({"phase": "kernel", **r, "tol": TOL_BF16, "shape": shape,
          "cuda_launches_per_call": ["ssd_bwd_walk_kernel", "ssd_bwd_grads_kernel",
                                     "ssd_bwd_da_kernel"],
          "bound_type": "bf16 tensor cores (split operands)", "gflop_bf16": tc_ops / 1e9,
          "gbytes": nbytes / 1e9,
          "fp32_yardstick": dict(zip(("ms", "by"), bound(nbytes, f32_ops, PEAK_F32)),
                                 gflop=f32_ops / 1e9),
          "rel_l2_vs_fp64": checks["train"]["rel_l2_vs_fp64"],
          "tol_rel_l2": TOL_SSD_BWD_REL_L2, "fp64_reference": "autograd of ssd_scan_ref, chunk "
          f"{scfg.ssm.chunk}", "plain_chunk": SSD_CHUNK, "train_check": checks["train"],
          "tail_check": checks["tail"],
          "bitwise_repeatable": True, "seconds": time.perf_counter() - t_bwd})
    del scratch
    torch.cuda.empty_cache()

    # -- the serve paths: Server.generate, launch counts, then prefill(S + 1)
    # against prefill(S) + decode(1) -----------------------------------------
    def serve(phase, arch, prompt, max_len, prompt_seed, want, warmup, config=None,
              cut=(), keep=None):
        """Full-width `arch` (or `config`, a cut of it: the config the Server
        reads is that one, for the time it builds) serves BATCH prompts of
        `prompt` tokens and NEW more through Server.generate; every launch
        count must be `want`(cfg).  Returns the server, the prompts (one
        token longer) and the counts; `keep` (a dict) receives the tokens,
        a host copy of the last step's logits, prefill ms, decode tokens/s
        and peak GB."""
        t0 = time.perf_counter()
        with (config_as(arch, config) if config is not None else contextlib.nullcontext()):
            srv = Server(arch, reduced=False, max_len=max_len, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = srv.cfg
        prompts = np.random.default_rng(prompt_seed).integers(
            1, cfg.vocab_size, size=(BATCH, prompt + 1)).astype(np.int32)
        srv.generate(*warmup(prompts))             # warm-up: cuBLAS, allocator
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = srv.generate(prompts[:, :prompt], NEW)
        got = launches()
        expect = {name: 0 for name in got}
        expect.update(want(cfg))
        emit({"phase": phase, "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "head_dim": cfg.head_dim, "reduced": list(cut), "batch": BATCH, "prompt": prompt,
              "new_tokens": NEW,
              "init_s": init_s, "prefill_ms": out["prefill_s"] * 1e3,
              "decode_tok_per_s": out["decode_tok_per_s"],
              "decode_step_ms": BATCH / out["decode_tok_per_s"] * 1e3,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": got, "expected_launches": expect, "finite": out["finite"],
              "tokens_head": out["tokens"][:, :8].tolist()})
        if got != expect:
            raise AssertionError(f"{phase} launch counts {got} != expected {expect}")
        if not out["finite"]:
            raise AssertionError(f"non-finite logits in the {phase} run")
        if out["tokens"].shape != (BATCH, NEW):
            raise AssertionError(f"{phase} tokens shape {out['tokens'].shape}")
        if keep is not None:
            keep.update(tokens=out["tokens"], last_logits=out["last_logits"].float().cpu(),
                        prefill_ms=out["prefill_s"] * 1e3,
                        decode_tok_per_s=out["decode_tok_per_s"],
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return srv, prompts, got

    def cross_check(phase, srv, prompts, cache_len, noise_floor=False):
        """The last logits of a prefill of every prompt token against a
        prefill of all but the last plus one decode step."""
        cfg, s = srv.cfg, prompts.shape[1] - 1
        with torch.inference_mode():
            # srv.batch: with a stub frontend, each token's row of its table
            toks = torch.from_numpy(prompts).long().to(dev)
            full, _ = prefill_step(srv.params, init_cache(cfg, BATCH, cache_len, dev),
                                   srv.batch(toks), cfg)
            cache = init_cache(cfg, BATCH, cache_len, dev)
            _, cache = prefill_step(srv.params, cache, srv.batch(toks[:, :s]), cfg)
            step, _ = serve_step(srv.params, cache, srv.batch(toks[:, s:]), s, cfg)
            # the noise floor: the same prefill at batch 2 (other GEMM shapes)
            half = (prefill_step(srv.params, init_cache(cfg, 2, cache_len, dev),
                                 srv.batch(toks[:2]), cfg)[0] if noise_floor else None)
            torch.cuda.synchronize()
        finite = bool(torch.isfinite(full).all() and torch.isfinite(step).all())
        err = float((step - full).abs().max())
        scale = float(full.abs().max())
        rec = {"phase": phase, "arch": srv.cfg.name, "prompt": s, "max_abs_err": err,
               "logit_absmax": scale, "rel_err": err / scale, "tol": TOL_CROSS,
               "elementwise_excess_at_tol": excess(step, full, TOL_CROSS), "finite": finite}
        if noise_floor:
            rec["batch2_vs_batch4_max_abs_err"] = float((half - full[:2]).abs().max())
        emit(rec)
        if not finite or not err <= TOL_CROSS * scale:
            raise AssertionError(f"{phase}: prefill+decode disagrees with prefill: max |err| "
                                 f"{err} > {TOL_CROSS} * {scale}")

    by_path = {}
    # chatglm3-6b: 4 x 512 prompt tokens, 64 new, KV cache 1024; its tokens,
    # last logits and peak are serve_sharded's and dryrun's reference
    served = {}
    srv, prompts, by_path["serve"] = serve(
        "serve", ARCH, PROMPT, MAX_LEN, SEED + 1, dense_serve_launches,
        lambda p: (p[:1, :16], 2), keep=served)
    cross_check("cross_check", srv, prompts, MAX_LEN, noise_floor=True)
    del srv
    torch.cuda.empty_cache()

    # mamba2-130m: 4 x 8192 prompt tokens, 64 new; the scan of every row
    # against the scan's final state (its tail) and the recurrence.  The
    # warm-up is at the served shape: the first 4 x 8192 prefill also pays
    # the allocator's growth and cuBLAS's choices for its shapes.
    served_ssm = {}
    srv, prompts, by_path["serve_ssm"] = serve(
        "serve_ssm", SSM_ARCH, SSM_PROMPT, SSM_PROMPT + NEW + 1, SEED + 5,
        lambda c: {"rmsnorm": (2 * c.n_layers + 1) * (1 + NEW), "ssd_scan": c.n_layers},
        lambda p: (p[:, :SSM_PROMPT], 1), keep=served_ssm)
    cross_check("cross_check_ssm", srv, prompts, 0)
    del srv
    torch.cuda.empty_cache()

    # stablelm-3b: head dim 80, LayerNorm (plain torch, as JAX's jnp), MHA
    srv, prompts, by_path["serve_stablelm"] = serve(
        "serve_stablelm", LM_ARCH, PROMPT, MAX_LEN, SEED + 8, dense_serve_launches,
        lambda p: (p[:1, :16], 2))
    cross_check("cross_check_stablelm", srv, prompts, MAX_LEN)
    del srv
    torch.cuda.empty_cache()

    # deepseek-v2-lite-16b: 31.4 GB of bf16 weights, alone on the card (every
    # earlier model freed); the norms are its one kernel: attn_norm, kv_norm
    # (at its row pitch) and ffn_norm a layer, final_norm, every step.  The
    # warm-up is at the served shape: the prefill's expert products are
    # [64, 240, ...] (capacity 240), the decode steps' [64, 1, ...].
    def serve_moe_and_check(phase, check_phase, arch, prompt_seed, config=None, cut=(),
                            want=moe_serve_launches, serve_bound=mla_moe_serve_bound,
                            keep=None):
        """An MoE model's serve phase (an MLA model's one kernel the RMSNorm),
        its serve bound, then moe_cross_check, gated with each MoE layer's
        selection pinned (no flip at a gap >= NEAR_TIE)."""
        srv, prompts, got = serve(phase, arch, PROMPT, MAX_LEN, prompt_seed, want,
                                  lambda p: (p[:, :PROMPT], 1), config=config, cut=cut,
                                  keep=keep)
        emit({"phase": f"{phase}_bound", "batch": BATCH, "prompt": PROMPT,
              **serve_bound(srv.cfg, srv.params, BATCH, PROMPT)})
        rec = moe_cross_check(srv, prompts, dev, MAX_LEN)
        emit({"phase": check_phase, **rec})
        if not (rec["finite"] and rec["pinned"]["max_abs_err"]
                <= TOL_CROSS * rec["pinned"]["logit_absmax"]):
            raise AssertionError(f"{check_phase}: prefill+decode disagrees with prefill, the "
                                 f"selection pinned: {rec['pinned']} (tol {TOL_CROSS})")
        if rec["wide_flips"]:
            raise AssertionError(f"{check_phase}: {rec['wide_flips']} routes flipped at a "
                                 f"top-k gap >= {NEAR_TIE}: {wide_flips(rec['flips'])}")
        del srv
        torch.cuda.empty_cache()
        return got

    served_moe = {}
    by_path["serve_moe"] = serve_moe_and_check("serve_moe", "cross_check_moe", MOE_ARCH,
                                               SEED + 11, keep=served_moe)
    # deepseek-v3-671b cut to its first 4 layers (31.4 GB of bf16 weights):
    # the sigmoid router at 256 experts top-8, q-LoRA, 128 MLA heads at d
    # 7168; norms attn, q, kv and ffn a layer, then final_norm.  Its
    # cross-check's prefill of 513 tokens has capacity 2052 at the factor 32
    by_path["serve_v3"] = serve_moe_and_check(
        "serve_v3", "cross_check_v3", V3_ARCH, SEED + 29,
        config=replace(get_config(V3_ARCH), n_layers=V3_SERVE_LAYERS), cut=V3_SERVE_CUT)
    # jamba-1.5-large-398b: one full-width period block with 8 of its 16
    # experts (51.6 GB of bf16 weights); per forward mixer_norm and ffn_norm a
    # layer, the seven Mamba layers' out_norm and final_norm, the prefill's
    # attention through the flash forward (rep 8) and its Mamba layers
    # through the SSD scan (N 16), each decode step's attention through
    # decode attention.  Its cross-check's prefill of 513 tokens has capacity
    # 2052 at the factor 4.  Its tokens, last logits and peak are
    # serve_sharded_hybrid's reference
    served_hybrid = {}
    by_path["serve_hybrid"] = serve_moe_and_check(
        "serve_hybrid", "cross_check_hybrid", HYBRID_ARCH, SEED + 34,
        config=hybrid_serve_config(), cut=HYBRID_SERVE_CUT, want=hybrid_serve_launches,
        serve_bound=hybrid_serve_bound, keep=served_hybrid)

    # the last four families at full width and full depth, one at a time
    # (command-r-35b's 60.6 GB of bf16 weights alone on the card): each serve
    # run's bound, then its cross-check; pixtral-12b and musicgen-large
    # through the stub frontend (its table built once, 1.34 GB for pixtral),
    # the cross-check's 513th embedding from the same table
    for phase, arch, prompt_seed in DENSE_SERVES:
        t_phase = time.perf_counter()
        srv, prompts, by_path[phase] = serve(phase, arch, PROMPT, MAX_LEN, prompt_seed,
                                             dense_serve_launches, lambda p: (p[:1, :16], 2))
        emit({"phase": f"{phase}_bound", "batch": BATCH, "prompt": PROMPT,
              **dense_serve_bound(srv.cfg, srv.params, BATCH, PROMPT),
              "stub_table_gb": (0 if srv._stub is None
                                else srv._stub.numel() * srv._stub.element_size() / 1e9)})
        cross_check(phase.replace("serve", "cross_check"), srv, prompts, MAX_LEN)
        del srv
        torch.cuda.empty_cache()
        emit({"phase": f"{phase}_seconds", "seconds": time.perf_counter() - t_phase})

    # -- train_check(_ssm, _moe): reduced chatglm3-6b, mamba2-130m and
    # deepseek-v2-lite-16b, loss and every gradient, card vs CPU
    for phase, cfg_, seed_, seq_, row1_len in (
            ("train_check", get_config(ARCH).reduced(), SEED + 2, 64, 40),
            # 192 tokens: three of the SSD kernels' 64-row chunks, so the
            # backward's state chain and the gradients entering each chunk run
            ("train_check_ssm", get_config(SSM_ARCH).reduced(), SEED + 14, 3 * SSD_CHUNK, 40),
            # MLA at full head dims (the <192, 128> flash kernels), 192 tokens
            # (three 64-row tiles), the CPU's routing pinned to the card's
            ("train_check_moe", moe_small_config(), SEED + 18, 3 * FLASH_TILE,
             3 * FLASH_TILE - 40),
            # reduced deepseek-v3-671b: 3 dense layers, 1 MoE layer with the
            # sigmoid router (router_bias drawn from the seed), the MTP layer;
            # q-LoRA at its full 1536
            ("train_check_v3", v3_small_config(), SEED + 30, 3 * FLASH_TILE,
             3 * FLASH_TILE - 40),
            # reduced starcoder2-15b at rep 12, D 128 (GELU, QKV bias,
            # LayerNorm), 192 tokens (three flash tiles)
            ("train_check_starcoder2", starcoder2_small_config(), SEED + 58, 3 * FLASH_TILE,
             3 * FLASH_TILE - 40)):
        rec = train_check(dev, cfg_, seed_, seq_, row1_len)
        emit({"phase": phase, **rec})
        if not rec["ok"]:
            raise AssertionError(
                f"{phase}: reduced {rec['arch']} on the card disagrees with the CPU: loss "
                f"{rec['rel_err_loss']}, gradients {rec['rel_l2_all_grads']} (relative, tol "
                f"{TOL_GRAD}); flips at a gap >= {NEAR_TIE}: {wide_flips(rec['flips'])}; "
                f"gradients that must be zero: {rec['zero_grad_leaves_max_abs']}")
    # reduced jamba-1.5-large-398b: one period block, GQA rep 8 at D 128, the
    # SSD kernels at P 64, N 16; 192 tokens: three 64-row SSD chunks and three
    # flash tiles; unit by unit (hybrid_train_check), the CPU's routing pinned
    rec = hybrid_train_check(dev, hybrid_small_config(), SEED + 35, 3 * SSD_CHUNK,
                             3 * SSD_CHUNK - 40)
    emit({"phase": "train_check_hybrid", **rec})
    if not rec["ok"]:
        raise AssertionError(
            f"train_check_hybrid: reduced {rec['arch']} on the card disagrees with the CPU "
            f"unit by unit: loss {rec['rel_err_loss']}, all gradients "
            f"{rec['rel_l2_all_grads']}, each unit's {rec['unit_rel_l2']}, the worst leaves "
            f"{rec['worst_leaf_rel_l2']} (relative, tol {TOL_GRAD}); flips at a gap >= "
            f"{NEAR_TIE}: {wide_flips(rec['flips'])}")

    # -- the train paths: Trainer.run on one fixed batch ------------------------
    def train(phase, arch, steps, moment_dtype, cut, want, batch_seed, seq=TRAIN_S,
              n_layers=None, keep=None, routes=False):
        """Full-width `arch` (its first `n_layers` layers when given) trains
        `steps` steps of TRAIN_B x `seq` tokens (remat per layer, CE_CHUNKS
        cross-entropy chunks, AdamW) on one fixed batch, repeated: a
        learnable target.  Every loss finite, the last below the first (and
        so the MTP head's mtp_ce, where the model has one), every launch
        count per step `want`(cfg).  `keep` (a dict) receives the losses,
        the median step ms, a host copy of the final params, the argument
        bytes, the peak device memory (`peak_mem_gb`) and its part above
        what the earlier phases still held (`peak_bytes`, the dry run's
        reference, read after `warm_cublas` so that no phase's peak holds
        the cuBLAS workspaces, whatever ran before it), and with `routes`
        every MoE call's selection (a RouteRecorder's calls)."""
        t_phase = time.perf_counter()
        tc = TrainerConfig(arch=arch, reduced=False, global_batch=TRAIN_B, seq_len=seq,
                           steps=steps, log_every=steps, device="cuda", seed=SEED,
                           moment_dtype=moment_dtype, n_layers=n_layers)
        fixed = fixed_batch(get_config(arch).vocab_size, TRAIN_B, seq, batch_seed)
        warm_bytes = warm_cublas(dev)
        base = torch.cuda.memory_allocated()      # what earlier phases still hold
        t0 = time.perf_counter()
        tr = Trainer(tc, batches=itertools.repeat(fixed))
        cfg = tr.cfg
        tr.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(tr.state["params"]))
        state_gb = torch.cuda.memory_allocated() / 1e9
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(tr.state) + list(tr._to_device(fixed).values()))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with RouteRecorder(L) if routes else contextlib.nullcontext() as recorder:
            out = tr.run()
        got = launches()
        per_step = {name: 0 for name in got}
        per_step.update(want(cfg))
        flops = model_flops(cfg, n_params, TRAIN_B, seq)
        losses = out["losses"]
        emit({"phase": phase, "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "head_dim": cfg.head_dim, "n_params": n_params, "global_batch": TRAIN_B,
              "seq_len": seq, "steps": steps, "remat": cfg.remat, "ce_chunks": CE_CHUNKS,
              "moment_dtype": str(moment_dtype).split(".")[-1], "reduced": cut,
              "init_s": init_s, "losses": losses, "mtp_ces": out.get("mtp_ces"),
              "step_ms": out["step_s"] * 1e3,
              "tokens_per_s": out["tokens_per_s"], "state_gb": state_gb,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "cublas_warm_bytes": warm_bytes,
              "model_tflops_per_step": flops / 1e12,
              "model_tflops_per_s": flops / out["step_s"] / 1e12,
              "launches_per_step": {k: v / steps for k, v in got.items()},
              "expected_launches_per_step": per_step,
              "seconds": time.perf_counter() - t_phase})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss in the {phase} run: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall in the {phase} run: {losses}")
        if cfg.mtp and not (len(out.get("mtp_ces", ())) == steps
                            and all(np.isfinite(out["mtp_ces"]))
                            and out["mtp_ces"][-1] < out["mtp_ces"][0]):
            raise AssertionError(f"mtp_ce not finite and falling in the {phase} run: "
                                 f"{out.get('mtp_ces')}")
        if got != {k: v * steps for k, v in per_step.items()}:
            raise AssertionError(f"{phase} launch counts {got} != {steps} x {per_step}")
        if keep is not None:
            keep.update(losses=losses, step_ms=out["step_s"] * 1e3,
                        params=host_copy(tr.state["params"]), argument_bytes=arg_bytes,
                        peak_bytes=torch.cuda.max_memory_allocated() - base,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if routes:
                keep["routes"] = recorder.take()
        del tr
        torch.cuda.empty_cache()
        return got

    unsharded = {}
    by_path["train"] = train(
        "train", ARCH, TRAIN_STEPS, torch.bfloat16, TRAIN_CUT, dense_train_launches, SEED + 4,
        keep=unsharded)
    unsharded_ref = {k: unsharded[k] for k in ("argument_bytes", "peak_bytes")}
    # the same run with its state on a 1 x 1 DeviceMesh over NCCL (world 1),
    # then one step's gradient tree through the int8 compressed all-reduce
    nccl = init_world(dev)
    rec = train_sharded(dev, unsharded)
    del unsharded
    failures = sharded_failures(rec, dense_train_launches(get_config(ARCH)))
    worst = sorted(rec["param_rel_l2"], key=rec["param_rel_l2"].get, reverse=True)[:4]
    emit({"phase": "train_sharded", "nccl": nccl,
          **{k: v for k, v in rec.items() if k != "param_rel_l2"}, "reduced": TRAIN_CUT,
          "worst_param_rel_l2": {k: rec["param_rel_l2"][k] for k in worst},
          "unsharded_step_ms": rec["ref_step_ms"], "failures": failures})
    if failures:
        raise AssertionError(f"train_sharded: {failures}")
    by_path["train_sharded"] = rec["launches"]
    torch.cuda.empty_cache()
    rec = compress(dev)
    failures = compress_failures(rec, dense_train_launches(get_config(ARCH)))
    emit({"phase": "compress", **rec, "failures": failures})
    if failures:
        raise AssertionError(f"compress: {failures}")
    by_path["compress"] = rec["launches"]
    torch.cuda.empty_cache()
    # the serve phase's run again with params and cache on the same mesh
    rec = serve_sharded(dev, served)
    failures = sharded_serve_failures(rec, dense_serve_launches(get_config(ARCH)))
    emit({"phase": "serve_sharded", "nvidia_smi": smi, **rec, "failures": failures})
    if failures:
        raise AssertionError(f"serve_sharded: {failures}")
    by_path["serve_sharded"] = rec["launches"]
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    # the dry run on its own fake process group (no real one up): the 1 x 1
    # cells at the train and serve phases' shapes against what they measured,
    # then chatglm3-6b's production cells at 16x16 (traced, not run)
    t0 = time.perf_counter()
    rec = dryrun_cells(dev, unsharded_ref, served)
    production = production_cells()
    failures = dryrun_failures(rec, production)
    emit({"phase": "dryrun", "nvidia_smi": smi,
          **{k: v for k, v in rec.items() if k != "cells"},
          "failures": failures, "seconds": time.perf_counter() - t0})
    for name, cell in list(rec["cells"].items()) + list(production.items()):
        emit({"phase": "dryrun_cell", "cell": name, **cell})
    if failures:
        raise AssertionError(f"dryrun: {failures}")
    del served, unsharded_ref
    # stablelm-3b: the Trainer's default fp32 moments (~34 GB of state)
    by_path["train_stablelm"] = train(
        "train_stablelm", LM_ARCH, LM_TRAIN_STEPS, torch.float32, [], dense_train_launches,
        SEED + 9)
    # mamba2-130m: 8 x 2048 tokens, the Trainer's default fp32 moments; per
    # layer the norm and the gated out_norm, each recomputed, and the scan
    # (forward, recompute, backward)
    trained_ssm = {}
    by_path["train_ssm"] = train(
        "train_ssm", SSM_ARCH, SSM_TRAIN_STEPS, torch.float32, [], ssm_train_launches,
        SEED + 15, seq=SSM_TRAIN_S, keep=trained_ssm)
    # the same run on the 1 x 1 mesh of one NCCL rank: the Mamba mixer's
    # sharded path (heads over "model", a size-1 dim here)
    nccl = init_world(dev)
    sharded_ssm = {}
    rec = train_sharded(dev, trained_ssm, arch=SSM_ARCH, seq=SSM_TRAIN_S,
                        steps=SSM_TRAIN_STEPS, moment_dtype=torch.float32,
                        batch_seed=SEED + 15, keep=sharded_ssm)
    failures = sharded_failures(rec, ssm_train_launches(get_config(SSM_ARCH)),
                                peak_tol=TOL_SHARDED_PEAK)
    emit({"phase": "train_sharded_ssm", "nccl": nccl,
          **{k: v for k, v in rec.items() if k != "param_rel_l2"},
          "worst_param_rel_l2": dict(sorted(rec["param_rel_l2"].items(), key=lambda kv: -kv[1])[:4]),
          "unsharded_step_ms": rec["ref_step_ms"], "failures": failures})
    if failures:
        raise AssertionError(f"train_sharded_ssm: {failures}")
    by_path["train_sharded_ssm"] = rec["launches"]
    torch.cuda.empty_cache()
    # the same run stopped at step 4, saved sharded, restored into a fresh
    # sharded state and resumed: bitwise train_sharded_ssm's
    rec = train_sharded_resume(dev, sharded_ssm)
    del sharded_ssm
    failures = sharded_resume_failures(rec, ssm_train_launches(get_config(SSM_ARCH)))
    emit({"phase": "train_sharded_resume", "nvidia_smi": smi, **rec, "failures": failures})
    if failures:
        raise AssertionError(f"train_sharded_resume: {failures}")
    by_path["train_sharded_resume"] = {k: v + rec["launches"]["B"][k]
                                       for k, v in rec["launches"]["A"].items()}
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    # mamba2-130m's 1 x 1 train cell traced at train_ssm's shape, held to
    # what train_ssm measured
    t0 = time.perf_counter()
    rec = dryrun_ssm_cell(dev, trained_ssm)
    failures = dryrun_failures(rec)
    emit({"phase": "dryrun_ssm", "nvidia_smi": smi,
          **{k: v for k, v in rec.items() if k != "cells"},
          "failures": failures, "seconds": time.perf_counter() - t0})
    emit({"phase": "dryrun_cell", "cell": "ssm_train", **rec["cells"]["train"]})
    if failures:
        raise AssertionError(f"dryrun_ssm: {failures}")
    del trained_ssm
    # mamba2-130m again, over the Trainer's own BuffetFS (4 BServers) with
    # checkpoints: stopped at step 8 of 12, resumed over restarted servers,
    # against 12 uninterrupted
    rec = train_resume(dev)
    failures = resume_failures(rec, ssm_train_launches(get_config(SSM_ARCH)))
    emit({"phase": "train_resume", "nvidia_smi": smi, **rec, "failures": failures})
    if failures:
        raise AssertionError(f"train_resume: {failures}")
    by_path["train_resume"] = {k: sum(r["launches"][k] for r in rec["runs"].values())
                               for k in rec["runs"]["A"]["launches"]}
    # the paper's mechanism at the Trainer's file size: an epoch of 4,096
    # samples through DataPipeline over the port's BuffetFS, one READ and
    # one async CLOSE a sample; then the files opened, read and closed
    # through BuffetFS and the two Lustre baselines
    rec = buffetfs_ingest(dev)
    failures = ingest_failures(rec)
    emit({"phase": "buffetfs_ingest", "nvidia_smi": smi, **rec, "failures": failures})
    if failures:
        raise AssertionError(f"buffetfs_ingest: {failures}")
    # deepseek-v2-lite-16b: the dense layer and 5 MoE layers at full width,
    # fp32 moments; per layer attn_norm, kv_norm (at its row pitch) and
    # ffn_norm, each recomputed, and the three flash passes at <192, 128>
    trained_moe = {}
    by_path["train_moe"] = train(
        "train_moe", MOE_ARCH, MOE_TRAIN_STEPS, torch.float32, MOE_TRAIN_CUT,
        lambda c: moe_train_launches(c, TRAIN_S), SEED + 19, n_layers=MOE_TRAIN_LAYERS,
        keep=trained_moe, routes=True)
    # reduced jamba-1.5-large-398b (hybrid_small_config), bf16 moments: the
    # unsharded reference of train_sharded_hybrid and dryrun_hybrid, every
    # route recorded
    trained_hybrid = {}
    with config_as(HYBRID_ARCH, hybrid_small_config()):
        by_path["train_hybrid"] = train(
            "train_hybrid", HYBRID_ARCH, HYBRID_TRAIN_STEPS, torch.bfloat16, HYBRID_TRAIN_CUT,
            hybrid_train_launches, SEED + 62, seq=HYBRID_TRAIN_S, keep=trained_hybrid,
            routes=True)
    # the same runs on the 1 x 1 mesh of one NCCL rank (the MoE's
    # expert-parallel path, MLA's sharded branches; a period block's Mamba,
    # MoE and attention layers side by side), every route recorded; then
    # serve_ssm's, serve_moe's and serve_hybrid's runs through
    # Server(mesh=...)
    nccl = init_world(dev)
    moe_cut = replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    with RouteRecorder(L) as recorder:
        rec = train_sharded(dev, trained_moe, arch=MOE_ARCH, steps=MOE_TRAIN_STEPS,
                            moment_dtype=torch.float32, batch_seed=SEED + 19,
                            n_layers=MOE_TRAIN_LAYERS)
    flips = route_flips(trained_moe.pop("routes"), recorder.take())
    failures = sharded_failures(rec, moe_train_launches(moe_cut, TRAIN_S))
    if flips:
        failures.append(f"{len(flips)} routes differ from the unsharded run's: {flips[:4]}")
    emit({"phase": "train_sharded_moe", "nccl": nccl,
          **{k: v for k, v in rec.items() if k != "param_rel_l2"}, "reduced": MOE_TRAIN_CUT,
          "worst_param_rel_l2": dict(sorted(rec["param_rel_l2"].items(), key=lambda kv: -kv[1])[:4]),
          "route_flips": len(flips), "unsharded_step_ms": rec["ref_step_ms"],
          "failures": failures})
    if failures:
        raise AssertionError(f"train_sharded_moe: {failures}")
    by_path["train_sharded_moe"] = rec["launches"]
    del trained_moe
    torch.cuda.empty_cache()
    with config_as(HYBRID_ARCH, hybrid_small_config()) as small:
        with RouteRecorder(L) as recorder:
            rec = train_sharded(dev, trained_hybrid, arch=HYBRID_ARCH, seq=HYBRID_TRAIN_S,
                                steps=HYBRID_TRAIN_STEPS, batch_seed=SEED + 62)
    flips = route_flips(trained_hybrid.pop("routes"), recorder.take())
    failures = sharded_failures(rec, hybrid_train_launches(small))
    if not (rec["losses_bitwise"] and rec["params_bitwise"]):
        failures.append("losses or params not bitwise the unsharded run's")
    if flips:
        failures.append(f"{len(flips)} routes differ from the unsharded run's: {flips[:4]}")
    emit({"phase": "train_sharded_hybrid", "nccl": nccl,
          **{k: v for k, v in rec.items() if k != "param_rel_l2"}, "reduced": HYBRID_TRAIN_CUT,
          "worst_param_rel_l2": dict(sorted(rec["param_rel_l2"].items(), key=lambda kv: -kv[1])[:4]),
          "route_flips": len(flips), "unsharded_step_ms": rec["ref_step_ms"],
          "failures": failures})
    if failures:
        raise AssertionError(f"train_sharded_hybrid: {failures}")
    by_path["train_sharded_hybrid"] = rec["launches"]
    torch.cuda.empty_cache()
    # serve_hybrid's cut of jamba (51.6 GB of bf16 weights) is placed on the
    # mesh leaf by leaf with no copy (a one-rank mesh keeps each leaf's
    # storage): the peak is printed beside serve_hybrid's
    for phase, arch, ref, prompt, max_len, prompt_seed, path, config in (
            ("serve_sharded_ssm", SSM_ARCH, served_ssm, SSM_PROMPT, SSM_PROMPT + NEW + 1,
             SEED + 5, "serve_ssm", None),
            ("serve_sharded_moe", MOE_ARCH, served_moe, PROMPT, MAX_LEN, SEED + 11,
             "serve_moe", None),
            ("serve_sharded_hybrid", HYBRID_ARCH, served_hybrid, PROMPT, MAX_LEN, SEED + 34,
             "serve_hybrid", hybrid_serve_config())):
        t_phase = time.perf_counter()
        with config_as(arch, config) if config is not None else contextlib.nullcontext():
            rec = serve_sharded(dev, ref, arch=arch, prompt=prompt, max_len=max_len,
                                prompt_seed=prompt_seed)
        failures = sharded_serve_failures(rec, by_path[path])
        emit({"phase": phase, "nvidia_smi": smi, **rec, "failures": failures,
              "seconds": time.perf_counter() - t_phase})
        if failures:
            raise AssertionError(f"{phase}: {failures}")
        by_path[phase] = rec["launches"]
        torch.cuda.empty_cache()
    del served_ssm, served_moe, served_hybrid
    torch.distributed.destroy_process_group()
    # train_hybrid's 1 x 1 train cell traced at its shape, held to what
    # train_hybrid measured
    t0 = time.perf_counter()
    rec = dryrun_hybrid_cell(dev, trained_hybrid, hybrid_small_config())
    failures = dryrun_failures(rec)
    emit({"phase": "dryrun_hybrid", "nvidia_smi": smi,
          **{k: v for k, v in rec.items() if k != "cells"},
          "failures": failures, "seconds": time.perf_counter() - t0})
    emit({"phase": "dryrun_cell", "cell": "hybrid_train", **rec["cells"]["train"]})
    if failures:
        raise AssertionError(f"dryrun_hybrid: {failures}")
    del trained_hybrid
    # deepseek-v3-671b: its 3 dense layers at full width and the MTP layer,
    # fp32 moments; per layer attn_norm, q_norm (d 1536), kv_norm (at its
    # row pitch) and ffn_norm, each recomputed, the flash passes at <192,
    # 128> over 128 heads; the MTP layer once, its CE in 7 chunks of 73 rows
    by_path["train_v3"] = train(
        "train_v3", V3_ARCH, V3_TRAIN_STEPS, torch.float32, V3_TRAIN_CUT,
        lambda c: moe_train_launches(c, TRAIN_S), SEED + 31, n_layers=V3_TRAIN_LAYERS)
    # musicgen-large at full width, nothing cut, fp32 moments: on tokens, as
    # the Trainer feeds it (the token table plus sinusoidal positions)
    by_path["train_musicgen"] = train(
        "train_musicgen", MG_ARCH, MG_TRAIN_STEPS, torch.float32, [], dense_train_launches,
        SEED + 59)
    # command-r-35b cut to 2 layers, fp32 moments: the CE at vocab 256000 and
    # the tied table's gradient from the gather and from the head
    by_path["train_command_r"] = train(
        "train_command_r", CR_ARCH, CR_TRAIN_STEPS, torch.float32, CR_TRAIN_CUT,
        dense_train_launches, SEED + 60, n_layers=CR_TRAIN_LAYERS)

    for row in rows:
        row["launches_by_path"] = {p: cnt[row["name"]] for p, cnt in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: no launch on the main paths")
        # MLA's expanded branch runs in train_moe (16 heads) and train_v3 (128)
        for key_h, path in (("dqk192_dv128", "train_moe"), ("dqk192_dv128_h128", "train_v3")):
            if key_h in row:
                row[key_h]["launches_by_path"] = {path: by_path[path][row["name"]]}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
