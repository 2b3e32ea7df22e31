#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names a checkout of the parent commit: its decode_step,
decode_attention, traj_logprob backward, subtb_loss and the two backward
kernels of LM training (flash attention's and the wkv scan's, both on the
fp32 cores there) are built beside this tree's and timed on the same
inputs (each of those rows prints ``parent_kernel_us``).

Run from a checkout of the repository on a machine with a CUDA GPU.  It
imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing one JSON line:

1. device  - ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build   - compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one ``nvcc`` per source, in parallel); ptxas's report with
             the function named on each line, and the functions that
             spill.  One ``nvcc -shared`` call over all sources is timed
             on a host thread while the kernel checks run (one core of
             the host's; the checks' times are the card's), and its
             seconds print after them (``build_single_call``);
3. kernel  - each kernel (decode_step, decode_attention, traj_logprob and
             subtb_loss forward and backward, flash_attention,
             rwkv6_scan) against its plain PyTorch version on the card,
             at the main paths' shapes (the sequence recipes' included:
             decode_attention at (16, 9 / 61, 8, 8) with ragged lengths,
             traj_logprob at (16, 8, 4), (16, 5, 22), (128, 61, 21), the
             fused step at their eval rollouts'; the pop-only cached
             backward's decode_attention at (16, 9 / 61, 8, 8) from full
             lengths down to BOS alone, tfbind8's replay loss's
             traj_logprob at (32, 8, 4 / 1); the graph recipes'
             traj_logprob at (32, 26, 1378), (32, 26, 53), (256, 11, 26);
             ising_ebgfn's at (256, 81, 162), (256, 81, 81) and
             ising_converge's at (64, 16, 32), (64, 16, 16); flash
             at the dense models' (2, 2,048, 40 / 64 / 96 over 8, 128)
             causal bf16, the cached (2, 16 / 2,048, 40/8, 128) call at
             q_offset 1,024 / kv_len 1,040 and the dense hold's fp32
             (1, 128, 40/8, 128); the scan at rwkv6-1.6b's (2, 4,096, 32,
             64/64) and (8, 1, ...) with u, the rwkv hold's fp32 shapes,
             Hymba's scoring pass from no state)
             and at odd ones, with its
             device time, the plain version's, the least time the card
             could take (``bound``) and, where one PyTorch call computes the
             same function, that call's (``library_us``); each flash row
             names the route it took (``ops.flash_route``: the
             tensor-core kernel for bf16 at D % 16 == 0, else SIMT), and
             each scan row its route (``ops.scan_route``: the chunk
             kernels for bf16 at T >= 64, else the step recurrence); a
             chunk row also holds and times the recurrence kernel on the
             same inputs, and one row draws decays far below the JAX
             chunk form's 1e-30 clamp; subtb rows also take potentials at
             an offset of 1e3 (where JAX's expanded prefix form cancels),
             lambda = 1 and two tiles of the block layout, each backward
             held row by row; the decode_step, decode_attention,
             traj_logprob backward and subtb rows print the launch floor
             measured in the run (``floor_us``, a one-element in-place
             add);
   decode_step_lanes - the serving batch against the same lanes reversed
             and a 5-lane subset, and a repeated call: bitwise equal;
4. serve   - the bitseq serving path at full width (n=120, k=8, a 3-layer
             dim-64 policy from a seeded generator, 64 lanes, 4 requests)
             through the scheduler; every sample is held against the port's
             ``forward_rollout`` and the kernels' launches are counted;
   serve_profile - the serving loop's device idle share, device and host
             tops;
   serve_tier - the serving tier as users run it: a ServeFront over a
             Scheduler behind the HTTP endpoint (127.0.0.1, a free port);
             each of the seven servable envs at the registry's defaults
             (two held requests, one at beta 2, one at logit_temp 0.8 on
             the KV-cache envs, then 8 timed ones from 4 client threads:
             samples/s, p50 / p99 latency, launches by env, decode_step
             on bitseq / tfbind8 / AMP only; every body held against
             forward_rollout, a tempered hypergrid one against a one-lane
             engine), 8 concurrent clients answered once each, a dedup
             repeat, the drain; serve_tier_profile (a hypergrid + AMP
             mix's device idle share), serve_tier_faults (a retried step,
             a poisoned pool quarantined and replayed, a restore fault's
             typed 500, a 504 with progress, a 408), serve_tier_autosize
             (bitseq's pool over buckets 16-64, each prewarmed);
5. train   - ``bitseq_tb`` training at full width (16 envs) for 50
             iterations through ``repro_torch.run.run_recipe`` (evals off:
             seqs_evals times them), which runs iteration 0 eagerly and
             replays its CUDA graph for the rest: the launches of every
             kernel counted, the eager ones by the wrappers and the
             replays' from the capture (45 decode_attention, 2
             traj_logprob forward and 1 backward per iteration);
   train_hold - one iteration on the card and on the CPU (plain versions)
             from the same parameters and noise: actions, loss, gradients;
   train_profile - one iteration's device idle share, device and host tops;
   trained_fused_step - after the optimizer steps of the two phases
             before it, the fused step's weight cache (filled before them)
             holds the live weights, and the fused step equals its plain
             chain;
   replayed_fused_step - the same after replays of a captured iteration;
             a bare replay (the loop's skipped) must leave the cache
             stale, the fault the loop's replay repairs;
6. hypergrid_train - ``hypergrid_subtb`` at full size (4x8^4, 16 envs, MLP
             2x256) for 50 iterations through ``run_recipe`` (captured, as
             train), with its evals at iterations 0 and 49; launches read
             at every iteration (1 subtb_loss forward and 1 backward each, 2
             traj_logprob forwards at the eval iterations, nothing else);
   hypergrid_hold - one iteration on the card and on the CPU, as
             train_hold;
   hypergrid_profile - one iteration's device idle share and tops;
   hypergrid_converge - SubTB on the 2x8 grid for 2,500 iterations
             (``tests/test_training.py:19-43``), through the captured
             run: empirical TV of 4,000
             samples under 0.12, with the exact-DP TV beside it; and the
             exact DP of the paper's 20^4 grid on the card against the
             CPU's;
7. seqs_train - ``tfbind8_tb`` and ``qm9_tb`` (50 iterations) and
             ``amp_tb`` (10) at full width through ``run_recipe``
             (captured, as train), evals off; it/s, samples/s and the
             launches of every iteration held exactly (decode_attention
             / traj_logprob forward / backward: tfbind8 16 / 2 / 1, qm9
             0 / 2 / 1, amp 183 / 0 / 0);
   seqs_hold - one iteration of each on the card and on the CPU, as
             train_hold;
   seqs_profile - that iteration's device idle share and tops;
   seqs_kv_valid - an AMP rollout's cached queries attend length + 1
             slots (BOS included), ragged across rows;
   seqs_evals - the eval suite of bitseq_tb, tfbind8_tb, qm9_tb and
             amp_tb once at full width (and AMP's top-100 reward and
             diversity): metrics, seconds, launches; every metric finite,
             the correlations in [-1, 1];
8. dag_train, phylo_train - ``dag_mdb`` (d = 5, BGe over 100 samples,
             128 envs, MLP 2x128 with a learned P_B) and ``phylo_fldb``
             (DS1: 27 species x 1,949 sites, 32 envs, the 6-layer slot
             transformer) at full size for 50 iterations through
             ``run_recipe`` (captured, as train), evals off; it/s,
             samples/s and every iteration's launches held exactly
             (dag: none, MDB's loss is the stop-action branch; phylo: 2
             traj_logprob forwards and 2 backwards, P_F at A = 1,378 and
             the learned P_B at 53);
   dag_hold, phylo_hold - one iteration of each on the card and on the
             CPU, as train_hold, at the recipe's own batch; a parameter
             whose CPU gradient is at most 1e-5 everywhere (log Z, unused
             by MDB and FLDB; phylo's bwd_head/b, whose gradient is
             rounding) is held to 1e-5 absolute and listed in
             ``grad_waived``;
   dag_profile, phylo_profile - that iteration's idle share and tops;
   dag_evals, phylo_evals - each evaluator once at full size, timed
             alone: dag's reward correlation, log Z bounds (traj_logprob
             at (256, 11, 26), 2 launches) and the JSD of 4,000 samples
             against the exact posterior over the 29,281 DAGs; phylo's
             correlation over 64 uniform trees;
   ising_train - ``ising_ebgfn`` (EB-GFN: the energy model's J and the
             GFlowNet trained jointly) at full size (n = 9, sigma -0.1,
             2,000 heat-bath PT samples, 256 envs, MLP 4x256 with a learned
             P_B) through ``run_recipe`` for 30 iterations, captured, evals
             off: the dataset's seconds (its heat-bath chains run in a
             spawned process from the script's start, beside the kernel
             checks; the run takes that array), the warm-up's and one replay's
             launches held to 2 traj_logprob forwards and 2 backwards,
             captured it/s over 25 replays and eager it/s over 3
             iterations, a replay's kernels, busy time and idle share, the
             warm-up and capture seconds;
   ising_hold - one ising_ebgfn iteration on the card and on the CPU from
             the same policy, J, data rows and noise: the mix coin and the
             four rollouts' actions (near ties counted apart), the TB loss
             and gradients on the card's batch, log A and the MH test,
             J's gradient and J after the update;
   ising_converge - the JAX package's table8_ising_ebgfn(quick=True)
             configuration (n = 4, sigma 0.2, 500 Wolff samples, MLP
             2x256, 64 envs, 800 iterations) captured: -log RMSE of J
             after 200, 400, 600 and 800 iterations within 0.25 of the JAX
             package's mean over three seeds (``scripts/ising_reference.py``),
             its seconds and MH acceptance;
   box_converge - ``box_tb`` as registered (the continuous Box, 64 envs,
             the squashed-mixture flow policy, epsilon 0.1) for 3,000
             iterations, captured: quad_tv of the recipe's eval (8,192
             rollouts, 16 x 16 grid) after 750, 1,500, 2,250 and 3,000
             iterations within a band of the JAX package's mean over
             three seeds (``scripts/box_reference.py``; the band is the
             larger of 0.05 and three times the seeds' spread), no kernel
             launched, it/s and eval seconds;
   replay_train - the three replay paths of the CLI at full width,
             ``hypergrid_tb --sampler replay --replay-capacity 4096
             --prioritized``, ``tfbind8_tb`` and ``amp_tb --sampler
             backward_replay`` (16 fresh and 16 replayed rows): 50, 50 and
             5 iterations through ``run_recipe``, captured, every
             iteration's launches held exactly (decode_attention /
             traj_logprob forward / backward: hypergrid 0 / 0 / 0, tfbind8
             16 / 2 / 1, amp 183 / 0 / 0); then 3 iterations captured held
             bitwise to eager (actions, losses, parameters, the buffer),
             eager and captured it/s, one replay's launches, kernels, busy
             time and idle share;
   cached_backward - ``backward_rollout(..., with_log_pf=True)`` on
             tfbind8 and AMP with the decode policy over 16 terminals (the
             pop-only cached backward, JAX's default): one decode_attention
             launch per layer and step (16 and 183), held to the uncached
             rollout on the card (actions bitwise, log P_F and log P_B to
             1e-4), both timed;
   replay_converge - ``hypergrid_tb`` with prioritized replay (capacity
             4,096) captured for 1,500 iterations: exact-DP TV after 500,
             1,000 and 1,500 within a band of the JAX package's mean over
             three seeds (``scripts/replay_reference.py``; the band the
             larger of 0.05 and three times the seeds' spread), no kernel;
   cli     - the training CLI, ``repro_torch.run.main``: ``--env tfbind8
             --transform reward_cache --transform reward_exponent:...``
             (beta annealed 1 -> 2 over 40 iterations) ``--cfg
             max_grad_norm=1.0 --cfg weight_decay=1e-4 --eval-every 25
             --metrics-json``, 50 iterations: launches of every iteration
             exact (16 / 2 / 1), the JSON's schema 1, then 3 captured
             iterations of the stack bitwise eager and one replay's device
             kernels with and without the cache; ``hypergrid_subtb
             --transform time_limit:limit=8`` and ``tfbind8_tb --sampler
             backward_replay`` run to 25 with a checkpoint, resumed with
             ``--restore`` to 50: every leaf of the final checkpoint
             (buffer included) bitwise the uninterrupted run's, save and
             restore seconds; a bitseq_tb checkpoint served through
             ``launch.serve --checkpoint``, its samples equal to
             ``forward_rollout`` of the trained policy;
   plan_vmap_seeds - ``run_recipe(plan="vmap_seeds")`` at full width:
             ``hypergrid_subtb`` at S = 8 and ``bitseq_tb`` at S = 4, 30
             captured iterations each, every iteration launching each
             kernel as often as the single plan (1 + 1 subtb; 45 / 2 / 1),
             the folded shapes (subtb (128, 30), traj (64, 15, 3840 /
             15), decode_attention (64, 16, 8, 8)) recorded where ``ops``
             launches; it/s beside the single plan's at the same S x B
             rows; seeds 0 and S - 1 held per iteration against single
             runs of their seeds (JAX's plan tolerances);
   plan_data_parallel - ``bitseq_tb`` and ``hypergrid_tb`` with the
             prioritized replay sampler under ``data_parallel(1)`` over
             NCCL (a group of one), the all-reduce captured in the graph:
             20 iterations' rows, trained leaves and buffer bitwise the
             single plan's, a replay's launches equal; ``auto`` on one
             card resolves to single;
   plan_serve - the serve phase's requests through
             ``Scheduler(plan="data_parallel", devices=[cuda:0] * 2)``:
             two shards of 32 lanes, each with its own decode_step launch;
             samples and log-rewards bitwise the single pool's, samples/s
             both ways;
   replay_hold - one iteration of each replay path on the card against
             the same iteration on the CPU at full size, after 1 that fills
             both buffers: fresh actions (near ties counted apart), the
             replayed rows equal, loss and gradients on the card's batch;
   box_hold - one iteration of box_tb and of box_db on the card and on
             the CPU from the same parameters and hash noise: done and
             exit flags equal (near ties counted apart), observations to
             1e-5, the card's log P_F of its draws against the CPU's
             density, loss and gradients on the card's batch;
   dag_converge - ``tests/test_training.py:46-75`` through the captured
             run: MDB at d = 3 for 2,500 iterations, the JSD of 3,000
             samples against the exact posterior under 0.02;
9. graph_train - each of the eleven on-policy recipes (bitseq_tb,
             tfbind8_tb, qm9_tb, amp_tb, hypergrid_tb / _db / _subtb,
             dag_mdb, phylo_fldb, box_tb, box_db) and ising_ebgfn at full
             width: 3
             iterations through a captured iteration held
             to eager ones (iteration 0's actions bitwise; losses and
             parameters within two eager runs' own difference, bitwise
             where those are), one replay's launches equal to one eager
             iteration's, then eager and captured it/s over the same
             iterations, the warm-up and capture seconds;
   graph_profile - one replay's device idle share, kernels and tops;
10. lm_decode - ``repro_torch.launch.lm_decode.serve`` with Hymba-1.5B at
             full width and depth (32 layers, d_model 1600, bf16, random
             weights from a seeded generator on the card): batch 8, 32
             prompt tokens, 32 generated; tokens/s, steps/s, exactly 32
             rwkv6_scan launches per step (recurrence route) and no
             flash;
   lm_prefill - ``launch.steps.make_prefill_step`` over 2 x 4,096 tokens:
             tokens/s, device time by kernel, finite log-probs, exactly 32
             flash_attention (all on the tensor-core route) and 32
             rwkv6_scan launches (all on the chunk route);
   scan_hold - the same pass with each layer's scan operands captured:
             on Hymba's own decays the chunk route holds to the step
             recurrence, layer by layer; the smallest in-chunk decay
             product each layer saw; the log-prob difference between a
             pass on each route (reported);
   lm_profile - one full-width decode step's idle share and tops;
   lm_hold - a 2-layer full-width fp32 Hymba (window 32) on the card
             (kernels) against the CPU (plain versions): a 512-token
             scoring pass and 40 decode steps, 1e-3, greedy tokens equal,
             the SSM state and the window's K/V after them within 1e-3
             (``lm_family_hold``, as the dense and RWKV6 holds);
11. dense_decode - ``lm_decode.serve`` with qwen2.5-32b whole (64 layers,
             d_model 5,120, bf16, 32.76 B parameters drawn on the card a
             layer at a time): batch 8, 32 + 32 tokens; steps/s, tokens/s,
             peak memory, no kernel launched (single-token attention over
             the cache is plain torch, as in JAX);
   dense_prefill - ``make_prefill_step`` over 2 x 2,048 tokens: exactly 64
             flash launches, all on the tensor cores; finite log-probs <= 0;
   dense_cached - per layer one cached S = 16 call of
             ``attention_sublayer`` onto a 2,048-slot cache holding 1,024
             tokens: 64 flash launches with q_offset 1,024 and kv_len
             1,040 (read from the recorded calls);
   dense_int8 - the dense_decode run on an int8 KV cache: rates, the
             cache's bytes against bf16's, the drift against the bf16
             cache teacher-forced along that run's 32 prompt tokens
             (reported);
   dense_profile - one decode step's idle share and tops;
   command_r - command-r-35b whole (40 layers, d_model 8,192, tied
             embeddings): 8 decode steps and a 2 x 2,048 scoring pass
             with 40 tensor-core flash launches;
   dense_cut - qwen2-72b and command-r-plus-104b at full width and 8
             layers (``reduced``: their bf16 weights do not fit the card
             at full depth): a scoring pass (8 flash launches, GQA groups
             of 8 and 12) and 4 decode steps each;
   rwkv_decode / rwkv_prefill - rwkv6-1.6b whole (24 layers, 32 heads of
             64): decode at batch 8, 32 + 32 tokens, 24 recurrence
             launches a step (with u and the state); a 2 x 4,096 scoring
             pass with 24 chunk launches, all with u; rwkv_profile;
   dense_hold / rwkv_hold - a 2-layer full-width fp32 qwen2.5-32b /
             rwkv6-1.6b, weights drawn on the card and copied to the CPU:
             the card (kernels) against the CPU (plain versions), a
             128-token scoring pass and 16 decode steps within 1e-3, the
             same argmax off near ties; the dense hold then 8 steps on an
             int8 cache, mean |d log p| against the float cache under 0.05
             (top-1 agreement reported);
12. vlm_decode / vlm_prefill - qwen2-vl-72b at full width, 8 of its 80
             layers: ``make_serve_step`` fed embeddings and M-RoPE ids
             (batch 8, a prompt of 8 text tokens and a 4 x 6 image grid,
             then 32 steps on the chosen tokens' embeddings, positions
             after the grid), no kernel; a 2 x 2,048 scoring pass (16 text
             tokens, a 32 x 32 grid, text) with 8 flash launches;
   moe_decode / moe_prefill - qwen3-moe-30b-a3b whole (48 layers, 128
             experts, top-8): decode at batch 8, 32 + 32 tokens (capacity
             1), a 2 x 2,048 pass (8 groups of 512, capacity 40, 48 flash
             launches), each with the share of (token, slot) pairs the
             capacity drops; moe_a27 - qwen2-moe-a2.7b whole (60 -> 64
             experts, top-4, shared experts): 8 decode steps and a pass;
   encdec_decode / encdec_prefill - whisper-medium whole (24 + 24 layers)
             over seeded (8, 1,500, 1,024) bf16 stub frames: the seconds
             of ``build_cross_cache`` (24 causal encoder launches), decode
             at batch 8, 32 + 32 tokens (24 cross-attention launches a
             step, one query over 1,500 keys); a 2 x 448-token pass over
             1,500 frames (72 launches: encoder, self, cross); each phase
             line of this group has its rate, peak memory, flash launches
             by route and the device's idle share;
   vlm_hold / moe_hold / encdec_hold - ``lm_family_hold`` for each: 2
             full-width fp32 layers (Whisper 2 + 2 over 1,500 frames, its
             cross cache compared too), the VLM with distinct t / h / w,
             the MoE's expert selections and kept masks equal on the card
             and the CPU;
13. kernel (flash_attention_bwd, rwkv6_scan_bwd) - the two backward
             kernels against their plain versions (``ref_flash_attention_bwd``,
             ``ref_rwkv6_bwd``) at every shape the training phases launch,
             at a D 128 dense (2, 2,048, 40/8) causal shape and Whisper's
             (2, 448 / 1,500, 16/16, 64) cross-attention; each flash row
             holds the forward kernel's out and lse to the plain ones
             and runs the plain backward on that out and the plain lse;
             the flash rows time ``F.scaled_dot_product_attention``'s
             backward under the same mask as the library call; each row
             names the route it took (``ops.flash_bwd_route``: the
             tensor-core kernels for bf16 at D % 16 == 0, else SIMT;
             ``ops.scan_bwd_route``: the chunk-parallel kernels for bf16
             at T >= 64, else the step recurrence), which must be the
             rule's, and with ``--parent`` the parent's time;
   lm_train_hold - one TB train step of Hymba-1.5B and rwkv6-1.6b cut to
             2 full-width fp32 layers, on the card against the CPU from
             the same parameters and ``synthetic_gfn_batch``: the loss
             and every gradient leaf, then every updated parameter and
             Adam moment against the CPU's chain on the card's gradients,
             each within HOLD_TOL of the leaf's largest entry;
   lm_train - one run of Hymba-1.5B whole (32 layers, bf16, remat full)
             for 4 steps at the CLI's defaults (8 x 128), then 3 on at
             2 x 4,096, then
             rwkv6-1.6b whole for 3 at 2 x 4,096, through
             ``launch.train``'s state and step: steps/s, tokens/s, peak
             memory, every step's loss (finite) and launches (per layer:
             the forwards twice, the backwards once, each backward on the
             tensor-core or chunk route), a step's idle share;
   lm_converge - ``examples/lm_gfn_finetune.py``'s 25M model for 300 TB
             steps through ``launch.train.train_loop``: the loss at steps
             100 / 200 / 299 within max(3 x spread, 10 % of the mean) of
             ``scripts/lm_train_reference.py``'s, and the example's own
             bar (last loss below the first) met or missed as the
             reference meets or misses it;
   lm_checkpoint - a 2-layer full-width Hymba run through ``train_loop``
             stopped after step 2 and resumed to 3, against the
             uninterrupted run: every leaf within HOLD_TOL (and whether
             bitwise), every backward on the tensor-core / chunk route;
   path_shapes - every shape at which the counted phases (serve, the
             training, eval and replay phases, cli, the plan phases, and
             the LM phases above: lm_decode, lm_prefill, dense_*,
             command_r, dense_cut, rwkv_*, vlm_*, moe_*, encdec_*,
             lm_train*, lm_converge, lm_checkpoint)
             launched decode_step, decode_attention, traj_logprob,
             subtb_loss, flash_attention, rwkv6_scan or their backward
             kernels has a row of phase 3 or 13, held
             against the plain version; the line prints each shape's
             launches;

then a ``kernels`` line (the two backwards once per route: the
tensor-core flash and chunk-parallel scan backwards with the training
steps' launches, the SIMT and step-recurrence ones with the fp32 training
hold's), the card's ``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; so does a machine without CUDA, or a directory without the
repository's ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import json
import math
import multiprocessing
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: kernel vs plain version: fp32 with another reduction order
TOL = 1e-4
#: traj_logprob backward vs plain, entry by entry (``bwd_excess``)
BWD_RTOL = 1e-4
BWD_ATOL = 1e-8
#: lanes whose two best Gumbel scores lie this close may pick either
TIE_GAP = 1e-5
#: profiler windows tried before a kernel's device time counts as missing
#: (or before a window that lost some of a kernel's records is used)
PROFILE_TRIES = 3
SERVE_LANES = 64
TRAIN_ITERS = 50
#: bitseq_tb at full width: 3 layers x 15 steps of cached queries, and
#: traj_logprob forward for P_F and P_B, backward for P_F, per iteration
TRAIN_LAUNCHES_PER_ITER = {"decode_attention": 45, "traj_logprob_fwd": 2,
                           "traj_logprob_bwd": 1, "decode_step": 0,
                           "subtb_loss_fwd": 0, "subtb_loss_bwd": 0,
                           "flash_attention": 0, "rwkv6_scan": 0,
                           "flash_attention_bwd": 0, "rwkv6_scan_bwd": 0}
#: hypergrid_subtb at full size: iterations, and evals at 0 and 49
HYPERGRID_ITERS = 50
HYPERGRID_EVAL_EVERY = 49
#: hypergrid_subtb per iteration: the SubTB loss forward and backward; the
#: stop-action path takes no traj_logprob, the LogZBoundsEval two
HYPERGRID_LAUNCHES_PER_ITER = {"decode_attention": 0, "traj_logprob_fwd": 0,
                               "traj_logprob_bwd": 0, "decode_step": 0,
                               "subtb_loss_fwd": 1, "subtb_loss_bwd": 1,
                               "flash_attention": 0, "rwkv6_scan": 0,
                               "flash_attention_bwd": 0,
                               "rwkv6_scan_bwd": 0}
HYPERGRID_EVAL_LAUNCHES = {"traj_logprob_fwd": 2}
#: the sequence-design recipes at full width: iterations of seqs_train,
#: and each iteration's launches (read from the code: a cached exploring
#: rollout queries decode_attention once per layer and step; a loss
#: without a stop action takes two traj_logprob forwards, P_F and P_B, and
#: one backward, P_F's; AMP's stop-action loss takes none)
SEQ_ITERS = {"tfbind8_tb": 50, "qm9_tb": 50, "amp_tb": 10}
SEQ_LAUNCHES_PER_ITER = {
    # 2 layers x 8 steps
    "tfbind8_tb": {"decode_attention": 16, "traj_logprob_fwd": 2,
                   "traj_logprob_bwd": 1},
    # the pooled encoder over 5 blocks: no cache
    "qm9_tb": {"decode_attention": 0, "traj_logprob_fwd": 2,
               "traj_logprob_bwd": 1},
    # 3 layers x 61 steps (60 symbols and the stop)
    "amp_tb": {"decode_attention": 183, "traj_logprob_fwd": 0,
               "traj_logprob_bwd": 0}}
SEQ_RECIPES = {"tfbind8_tb": "TFBind8 (length 8, vocab 4, A=4, A_b=1)",
               "qm9_tb": "QM9 (5 blocks of 11, A=22, A_b=2)",
               "amp_tb": "AMP (max_len 60, vocab 20 + stop, A=21, A_b=2)"}
SEQ_POLICIES = {"tfbind8_tb": "decode arch, 2 layers, dim 64, 8 heads",
                "qm9_tb": "pooled arch, 2 layers, dim 64, 8 heads",
                "amp_tb": "decode arch, 3 layers, dim 64, 8 heads, "
                          "log Z from 150"}
#: the graph environments at full size, with the iterations of their
#: dag_train / phylo_train runs and each iteration's launches (read from
#: the code: MDB's stop-action loss takes no kernel; FLDB's P_F over the
#: 1,378 slot pairs and its learned P_B over the 53 slots one traj_logprob
#: forward and one backward each)
GRAPH_ENV_ITERS = {"dag_mdb": 50, "phylo_fldb": 50}
GRAPH_ENV_LAUNCHES_PER_ITER = {
    "dag_mdb": {},
    "phylo_fldb": {"traj_logprob_fwd": 2, "traj_logprob_bwd": 2}}
#: each graph recipe's phase prefix (dag_train, phylo_hold, ...)
GRAPH_ENV_PHASES = {"dag_mdb": "dag", "phylo_fldb": "phylo"}
GRAPH_ENV_RECIPES = {
    "dag_mdb": "DAG d=5, BGe over 100 samples (A=26, A_b=26, T=11)",
    "phylo_fldb": "phylo DS1, 27 species x 1,949 sites (A=1378, A_b=53, "
                  "T=26)"}
GRAPH_ENV_POLICIES = {
    "dag_mdb": "MLP 2x128, A logits + learned P_B + flow head",
    "phylo_fldb": "slot transformer, 6 layers, dim 32, 8 heads, F 128"}
#: dag_evals: the log Z bounds' P_F and P_B, at (256, 11, 26); the JSD's
#: 4,000 samples (the JAX recipe's make_eval)
DAG_EVAL_LAUNCHES = {"LogZBoundsEval": {"traj_logprob_fwd": 2}}
DAG_JSD_SAMPLES = 4000
#: tests/test_training.py:46-75 on the card
DAG_CONVERGE_ITERS = 2500
DAG_CONVERGE_SAMPLES = 3000
DAG_CONVERGE_JSD = 0.02
#: ising_ebgfn at full size (n = 9, sigma = -0.1, 2,000 data rows, 256
#: envs, MLP 4x256 with a learned P_B): iterations of ising_train's run,
#: the replays and eager iterations timed after it, and each iteration's
#: launches (read from the code: TB on the mixed batch takes P_F at
#: (256, 81, 162) and the learned P_B at (256, 81, 81) through one
#: traj_logprob forward and one backward each; the four rollouts sample
#: with the plain masked log-softmax, as JAX's do)
ISING_ITERS = 30
#: the recipe's dataset at that size: seed, n, sigma, samples
ISING_DATASET = (0, 9, -0.1, 2000)
ISING_RATE_REPLAYS = 25
ISING_EAGER_ITERS = 3
ISING_LAUNCHES_PER_ITER = {"traj_logprob_fwd": 2, "traj_logprob_bwd": 2}
ISING_ENV = ("Ising 9x9 torus, sigma -0.1, 2,000 heat-bath PT samples "
             "(A=162, A_b=81, T=81)")
ISING_POLICY = "MLP 4x256, A logits + learned P_B + flow head"
#: ising_converge: the JAX package's table8_ising_ebgfn(quick=True)
#: configuration (n = 4, sigma = 0.2, 500 Wolff samples from seed 0, MLP
#: 2x256, 64 envs, 800 iterations) and the mean -log RMSE of the JAX
#: package after each checkpoint's iterations over seeds 0, 1 and 2
#: (``scripts/ising_reference.py`` on a CPU); the port's run must lie
#: within ISING_CONVERGE_BAND of each
ISING_CONVERGE_ITERS = 800
ISING_CONVERGE_MEANS = {200: 1.850285013516744, 400: 1.254481037457784,
                        600: 1.0984818538029988, 800: 0.943963905175527}
ISING_CONVERGE_BAND = 0.25
#: ising_hold: the seeded coupling J its iteration starts from, as a scale
#: of a symmetric N(0, 1) draw: energies of hundreds, the size of the
#: untrained policy's log P_T terms, so that the MH test rejects some rows
#: (0.92 accepted in a CPU rehearsal)
ISING_HOLD_J_SCALE = 1.0
#: box_converge: ``box_tb`` as registered (64 envs, MLP 4 -> 128 -> 128 ->
#: 50, K = 4, epsilon 0.1) for BOX_CONVERGE_ITERS iterations, captured, and
#: the JAX package's quad_tv after each checkpoint's iterations: the mean
#: over seeds 0, 1 and 2 and its spread (largest minus smallest),
#: ``scripts/box_reference.py`` on a CPU (8,192 rollouts, 16 x 16 grid).
#: The port's quad_tv must lie within max(BOX_CONVERGE_MIN_BAND, 3 x the
#: spread) of the mean at each checkpoint: one more seed's run, drawn from
#: the hash noise and a torch-seeded policy, at the eval's own noise.
BOX_CONVERGE_ITERS = 3000
BOX_CONVERGE_MEANS = {750: 0.4197889765103658, 1500: 0.3918781081835429,
                      2250: 0.35762255390485126, 3000: 0.32507452368736267}
BOX_CONVERGE_SPREAD = {750: 0.0162314772605896, 1500: 0.013489902019500732,
                       2250: 0.015194505453109741, 3000: 0.05962756276130676}
BOX_CONVERGE_MIN_BAND = 0.05
BOX_RECIPES = ("box_tb", "box_db")
BOX_ENV = "Box 2-D, delta (0.1, 0.25), T=11, 3-mode mixture reward"
BOX_POLICY = "MLP 4 -> 128 -> 128 -> 50, K=4 squashed mixtures + exit + flow"
#: replay_train: the three replay paths of the CLI (recipe -> sampler and
#: its options; the replay batch is the recipe's 16 envs)
REPLAY_PATHS = {
    "hypergrid_tb": ("replay", {"capacity": 4096, "prioritized": True}),
    "tfbind8_tb": ("backward_replay", {}),
    "amp_tb": ("backward_replay", {}),
}
REPLAY_BATCH = 16
#: each replay path's launches per iteration (read from the code): the
#: fresh rollout's cached queries, as on-policy; the replay's backward
#: rollout evaluates no policy (the uniform P_B; a transformer has no
#: learned head); the loss over the 32 rows: tfbind8's traj_logprob P_F and
#: P_B forwards and P_F's backward, the hypergrid's and AMP's stop-action
#: losses none
REPLAY_LAUNCHES_PER_ITER = {
    "hypergrid_tb": {},
    "tfbind8_tb": {"decode_attention": 16, "traj_logprob_fwd": 2,
                   "traj_logprob_bwd": 1},
    "amp_tb": {"decode_attention": 183}}
#: replay_train: iterations through run_recipe, and the (eager, captured)
#: iterations each rate is taken over
REPLAY_RUN_ITERS = {"hypergrid_tb": 50, "tfbind8_tb": 50, "amp_tb": 5}
REPLAY_RATE_ITERS = {"hypergrid_tb": (10, 40), "tfbind8_tb": (10, 40),
                     "amp_tb": (2, 10)}
#: cached_backward: a pop-only cached backward rollout with log P_F over
#: REPLAY_BATCH terminals queries decode_attention once per layer and step:
#: tfbind8 2 layers x 8 steps, AMP 3 x 61
CACHED_BACKWARD_LAUNCHES = {"tfbind8_tb": 16, "amp_tb": 183}
#: replay_hold: iterations that fill both buffers before the held one
REPLAY_HOLD_WARM = 1
#: replay_converge: hypergrid_tb with prioritized replay; the JAX
#: package's exact-DP TV over seeds 0-2 after each checkpoint
#: (scripts/replay_reference.py, its defaults), mean and spread; the band
#: is max(REPLAY_CONVERGE_MIN_BAND, 3 x spread), fixed from the reference
#: before the card's first run
REPLAY_CONVERGE_ITERS = 1500
REPLAY_CONVERGE_MEANS = {500: 0.24564765890439352, 1000: 0.10819897552331288,
                         1500: 0.06821954995393753}
REPLAY_CONVERGE_SPREAD = {500: 0.08219686150550842, 1000: 0.03546851873397827,
                          1500: 0.012679323554039001}
REPLAY_CONVERGE_MIN_BAND = 0.05
#: graph_train: every on-policy recipe and EB-GFN at full width, with the
#: launches of one iteration (eager, and in one replay of its capture
#: alike); the kernels left out launch 0 times
GRAPH_LAUNCHES_PER_ITER = {
    "bitseq_tb": {"decode_attention": 45, "traj_logprob_fwd": 2,
                  "traj_logprob_bwd": 1},
    **SEQ_LAUNCHES_PER_ITER,
    "hypergrid_tb": {}, "hypergrid_db": {},
    "hypergrid_subtb": {"subtb_loss_fwd": 1, "subtb_loss_bwd": 1},
    **GRAPH_ENV_LAUNCHES_PER_ITER,
    "ising_ebgfn": ISING_LAUNCHES_PER_ITER,
    **{name: {} for name in BOX_RECIPES}}
#: graph_train: iterations of each eager and captured run held against each
#: other, and the iterations each of the two is timed over after them
GRAPH_HOLD_ITERS = 3
#: (40, and 10 for amp_tb, phylo_fldb and ising_ebgfn, until the replay
#: phases came)
GRAPH_RATE_ITERS = {"amp_tb": 5, "phylo_fldb": 5, "ising_ebgfn": 5}
GRAPH_RATE_ITERS_DEFAULT = 20
#: cli: the training CLI's own entry point (``repro_torch.run.main``).
#: tfbind8 through the env registry with a cached reward under a beta
#: annealed over 40 iterations, AdamW's clip and decay, evals every 25
#: iterations into a metrics JSON; its launches per iteration as
#: tfbind8_tb's (the cache changes no kernel's count)
CLI_ITERS = 50
CLI_EVAL_EVERY = 25
CLI_BETA = "reward_exponent:beta=1.0,final_beta=2.0,anneal_steps=40"
CLI_TFBIND8 = ["--env", "tfbind8", "--transform", "reward_cache",
               "--transform", CLI_BETA,
               "--cfg", "max_grad_norm=1.0", "--cfg", "weight_decay=1e-4"]
#: the resumes held bitwise to the uninterrupted run: run to CLI_CUT with a
#: checkpoint there, then ``--restore`` to CLI_ITERS.  The hypergrid
#: recipe anneals epsilon over half its iteration budget, so the anneal is
#: pinned with --cfg: both runs then train under one schedule
CLI_CUT = 25
CLI_RESUMES = {
    "hypergrid_subtb": ["--recipe", "hypergrid_subtb", "--transform",
                        "time_limit:limit=8", "--cfg",
                        f"exploration_anneal_steps={CLI_CUT}"],
    "tfbind8_tb": ["--recipe", "tfbind8_tb", "--sampler",
                   "backward_replay"]}
CLI_LAUNCHES_PER_ITER = {
    "tfbind8": SEQ_LAUNCHES_PER_ITER["tfbind8_tb"],
    "hypergrid_subtb": {"subtb_loss_fwd": 1, "subtb_loss_bwd": 1},
    "tfbind8_tb": REPLAY_LAUNCHES_PER_ITER["tfbind8_tb"]}
#: cli: bitseq_tb at full width trained this many iterations into a
#: checkpoint, then served from it through ``launch.serve --checkpoint``
CLI_SERVE_TRAIN_ITERS = 3
CLI_SERVE_SAMPLES = 16
#: tests/test_training.py:19-43 on the card
#: the execution plans (plan_*): the seed plan's recipes at full width
#: with the seeds each trains at once, and its captured iterations; each
#: iteration's launches are the single plan's (one launch a call site for
#: all seeds)
PLAN_SEEDS = {"hypergrid_subtb": 8, "bitseq_tb": 4}
PLAN_ITERS = 30
PLAN_LAUNCHES_PER_ITER = {"hypergrid_subtb": {"subtb_loss_fwd": 1,
                                              "subtb_loss_bwd": 1},
                          "bitseq_tb": {"decode_attention": 45,
                                        "traj_logprob_fwd": 2,
                                        "traj_logprob_bwd": 1}}
#: JAX's plan tolerances (tests/test_plan.py:35-51): (rtol, atol)
PLAN_LOSS_TOL = (2e-3, 1e-4)
PLAN_REWARD_TOL = (1e-5, 1e-6)
#: data_parallel(1) over NCCL against single, bitwise, after this many
#: captured iterations; the runs and their sampler options
PLAN_DP_ITERS = 20
PLAN_DP_RUNS = {"bitseq_tb": {},
                "hypergrid_tb": {"sampler": "replay", "sampler_kwargs": {
                    "capacity": 4096, "replay_batch": REPLAY_BATCH,
                    "prioritized": True}}}
#: the sharded serving pool: shards of the serve phase's lanes, all on
#: the one card
PLAN_SERVE_SHARDS = 2
CONVERGE_ITERS = 2500
CONVERGE_TV = 0.12
#: H100 SXM data sheet: dense bf16 tensor-core peak (the bound of a kernel
#: whose products take bf16 operands)
BF16_FLOP_PER_S = 989e12
#: kernel vs plain version with bf16 outputs, entry by entry: both round
#: the same fp32 value, and may land one bf16 ulp apart, at most 2^-7 of
#: the entry; entries near 0 are allowed 1e-3 of the output's rms
BF16_RTOL = 2.0 ** -7
BF16_ATOL_RMS = 1e-3
#: Hymba-1.5B (src/repro/configs/hymba_1_5b.py): 32 layers, one flash and
#: one scan launch per layer and pass
HYMBA_LAYERS = 32
DECODE_BATCH, DECODE_PROMPT, DECODE_GEN = 8, 32, 32
PREFILL_BATCH, PREFILL_LEN = 2, 4096
#: lm_hold (Hymba through lm_family_hold): a 32-slot window, a scoring
#: pass of HYMBA_HOLD_TOKENS, HYMBA_HOLD_STEPS decode steps past the window
HYMBA_HOLD_TOKENS, HYMBA_HOLD_WINDOW, HYMBA_HOLD_STEPS = 512, 32, 40
HOLD_TOL = 1e-3
#: the dense family (phase 11): qwen2.5-32b whole, the LM entry point's
#: default (src/repro/configs/qwen2_5_32b.py: 64 layers, d_model 5,120,
#: 40 / 8 heads of 128), scored over 2 x 2,048 tokens
DENSE_ARCH = "qwen2.5-32b"
DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN = 2, 2048
#: dense_cached: CACHED_NEW tokens per layer onto a cache of CACHED_SLOTS
#: slots holding CACHED_FILLED
CACHED_SLOTS, CACHED_FILLED, CACHED_NEW = 2048, 1024, 16
#: command_r's decode steps at DECODE_BATCH: prompt + generated
COMMAND_R_PROMPT, COMMAND_R_GEN = 4, 4
#: dense_cut: the two dense models whose bf16 weights do not fit the card
#: at full depth, at CUT_LAYERS layers; CUT_PROMPT + CUT_GEN decode steps
CUT_ARCHS = ("qwen2-72b", "command-r-plus-104b")
CUT_LAYERS, CUT_PROMPT, CUT_GEN = 8, 2, 2
#: rwkv6-1.6b whole (24 layers, d_model 2,048, 32 heads of 64), scored over
#: 2 x RWKV_PREFILL_LEN tokens
RWKV_ARCH = "rwkv6-1.6b"
RWKV_PREFILL_LEN = 4096
#: dense_hold / rwkv_hold: 2 full-width fp32 layers, a scoring pass of
#: LM_HOLD_TOKENS, LM_HOLD_STEPS decode steps, INT8_HOLD_STEPS on an int8
#: cache (dense); the int8 cache's drift bar, tests/test_serving.py:28-43
LM_HOLD_LAYERS, LM_HOLD_TOKENS, LM_HOLD_STEPS, INT8_HOLD_STEPS = 2, 128, 16, 8
INT8_DRIFT = 0.05
#: the VLM (phase 12): qwen2-vl-72b at full width and VLM_LAYERS of its 80
#: layers (146 GB in bf16 whole: qwen2-72b's cut); the decode prompt is
#: VLM_PROMPT_TEXT text tokens and a VLM_PROMPT_GRID (rows, cols) image
#: grid, the scoring pass VLM_SCORE_TEXT tokens, a VLM_SCORE_GRID grid and
#: text to the end; its hold decodes VLM_HOLD_STEPS steps (the CPU reads
#: 17 GB of fp32 weights a step)
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 8
VLM_PROMPT_TEXT, VLM_PROMPT_GRID = 8, (4, 6)
VLM_SCORE_TEXT, VLM_SCORE_GRID = 16, (32, 32)
VLM_HOLD_STEPS = 8
#: the MoEs whole: qwen3-moe-30b-a3b decodes DECODE_PROMPT + DECODE_GEN
#: tokens, qwen2-moe-a2.7b MOE_A27_PROMPT + MOE_A27_GEN; both score 2 x
#: DENSE_PREFILL_LEN tokens; the drop share is read over one instrumented
#: serve call of MOE_DROP_STEPS decode steps and one instrumented pass
MOE_ARCH, MOE_A27_ARCH = "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"
MOE_A27_PROMPT, MOE_A27_GEN = 4, 4
MOE_DROP_STEPS = 4
#: whisper-medium whole over WHISPER_FRAMES stub frames (its 30 s window);
#: scored over 2 x WHISPER_SCORE_LEN tokens
WHISPER_ARCH = "whisper-medium"
WHISPER_FRAMES, WHISPER_SCORE_LEN = 1500, 448
#: in the device-kernel name of both flash routes (``ops.flash_route``:
#: ``flash_attention_kernel``, ``flash_attention_wgmma_kernel``), so the
#: profiler's flash time sums every kernel either route launches
FLASH_MATCH = "flash_attention"
#: in the device-kernel name of every kernel of both scan routes
#: (``ops.scan_route``: ``rwkv6_scan_kernel``; ``rwkv6_chunk_state_kernel``,
#: ``rwkv6_chunk_carry_kernel``, ``rwkv6_chunk_out_kernel``), and of each
#: route's own
SCAN_MATCH = "rwkv6_"
#: the scan rows profile the plain step recurrence over about this many
#: steps (calls of T steps, 1 to 20 of them)
PLAIN_SCAN_STEPS = 1024
SCAN_ROUTE_MATCH = {"recurrence": "rwkv6_scan_kernel",
                    "chunk": "rwkv6_chunk_"}


def wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name; each counts its own
    launches."""
    from repro_torch.kernels import ops
    return {"decode_step": ops.decode_step,
            "decode_attention": ops.decode_attention,
            "traj_logprob_fwd": ops.traj_logprob,
            "traj_logprob_bwd": ops.traj_logprob_backward,
            "subtb_loss_fwd": ops.subtb_loss,
            "subtb_loss_bwd": ops.subtb_loss_backward,
            "flash_attention": ops.flash_attention,
            "flash_attention_bwd": ops.flash_attention_backward,
            "rwkv6_scan": ops.rwkv6_scan,
            "rwkv6_scan_bwd": ops.rwkv6_scan_backward}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0
    from repro_torch.kernels import ops
    ops.flash_attention.route_launches = {r: 0 for r in
                                          ops.flash_attention.route_launches}
    ops.rwkv6_scan.route_launches = {r: 0 for r in
                                     ops.rwkv6_scan.route_launches}
    for w in (ops.flash_attention_backward, ops.rwkv6_scan_backward):
        w.route_launches = {r: 0 for r in w.route_launches}


def bwd_route_launches() -> dict:
    """Launches of each backward route since the last reset, keyed
    ``"<kernel>/<route>"`` (``ops.flash_bwd_route``: wgmma / simt;
    ``ops.scan_bwd_route``: chunk / recurrence)."""
    from repro_torch.kernels import ops
    return {f"{name}/{r}": n for name, w in (
        ("flash_attention_bwd", ops.flash_attention_backward),
        ("rwkv6_scan_bwd", ops.rwkv6_scan_backward))
        for r, n in w.route_launches.items()}


def flash_routes() -> dict:
    """Launches of each flash route since the last reset."""
    from repro_torch.kernels import ops
    return dict(ops.flash_attention.route_launches)


def scan_routes() -> dict:
    """Launches of each scan route since the last reset."""
    from repro_torch.kernels import ops
    return dict(ops.rwkv6_scan.route_launches)


@contextlib.contextmanager
def forced_scan_route(route: str):
    """``ops.scan_route`` held at ``route`` for the block (here only: the
    package reads no setting that picks a route)."""
    from repro_torch.kernels import ops
    real = ops.scan_route
    ops.scan_route = lambda dtype, steps: route
    try:
        yield
    finally:
        ops.scan_route = real


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def run_launches(eager: dict, captured) -> dict:
    """A training run's launches on the card: those the wrappers counted
    (the eager warm-up iteration, evals) and one replay's (what the capture
    recorded) times the replays.  A replay runs no Python, so no wrapper
    counts its launches."""
    return {k: eager[k] + captured.launches[k] * captured.replays
            for k in eager}


#: the shapes the main path handed each kernel, with the launches at each,
#: recorded while ``recording_path_shapes`` is on; each needs a row of its
#: check
PATH_SHAPES = {name: collections.Counter() for name in (
    "decode_step", "decode_attention", "traj_logprob", "subtb_loss",
    "flash_attention", "rwkv6_scan", "flash_attention_bwd",
    "rwkv6_scan_bwd")}


def on_card(t: torch.Tensor) -> bool:
    """Whether a call's operand lies on the card (what the recorders
    record)."""
    return t.is_cuda


def flash_key(B, Sq, Skv, H, KVH, D, dtype, causal, window, q_offset,
              kv_len) -> tuple:
    """A flash call's shape and arguments (``kv_len`` None reads as Skv)."""
    return (B, Sq, Skv, H, KVH, D, str(dtype), bool(causal), int(window),
            int(q_offset), Skv if kv_len is None else int(kv_len))


def scan_key(B, T, H, Dk, Dv, dtype, bonus, state) -> tuple:
    """A scan call's shape, dtype and whether it takes ``u`` and a state."""
    return (B, T, H, Dk, Dv, str(dtype), bool(bonus), bool(state))


@contextlib.contextmanager
def recording_path_shapes():
    """Record the shape of every call the port's modules make, on a CUDA
    tensor, to the decode_step, decode_attention and traj_logprob wrappers
    (the backward's logits are the forward's), and to flash_attention and
    rwkv6_scan where ``models/layers.py`` calls ``ops``.  The modules hold
    each of the first three under an imported name; that name is swapped
    for a recorder that calls the wrapper itself, so launch counts are
    untouched; ``models.layers`` reads the last two from ``ops``, which is
    swapped for a proxy that records and calls them.  The checks call
    ``ops`` and are not recorded."""
    from repro_torch.core import objectives, policies
    from repro_torch.kernels import ops
    from repro_torch.models import layers as model_layers
    from repro_torch.nn import transformer

    def step_shape(w, x_new, cache, *args, **kwargs):
        L, B, C, H, hd = cache["k"].shape
        return x_new, (B, L, C, H * hd, H, w["ff1_w"].shape[-1],
                       args[4].shape[1])

    sites = [(policies, "decode_step", ops.decode_step, step_shape),
             (transformer, "decode_attention", ops.decode_attention,
              lambda q, k, *a, **kw: (q, tuple(k.shape))),
             (objectives, "traj_logprob", ops.traj_logprob,
              lambda logits, *a, **kw: (logits, tuple(logits.shape))),
             (objectives, "subtb_kernel", ops.subtb_loss,
              lambda phi, *a, **kw: (phi, tuple(phi.shape)))]

    def recorder(name, wrapper, shape):
        name = {"subtb_kernel": "subtb_loss"}.get(name, name)

        def call(*args, **kwargs):
            t, key = shape(*args, **kwargs)
            if on_card(t):
                PATH_SHAPES[name][tuple(int(d) for d in key)] += 1
            return wrapper(*args, **kwargs)
        return call

    class RecordingOps:
        """``ops`` as ``models.layers`` sees it, recording each flash and
        scan call's key before the wrapper runs (and counts) as it would."""

        def __getattr__(self, name):
            return getattr(ops, name)

        @staticmethod
        def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                            kv_len=None):
            if on_card(q):
                PATH_SHAPES["flash_attention"][flash_key(
                    q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    k.shape[2], q.shape[3], q.dtype, causal, window,
                    q_offset, kv_len)] += 1
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len)

        @staticmethod
        def rwkv6_scan(r, k, v, w, u=None, state=None):
            if on_card(r):
                PATH_SHAPES["rwkv6_scan"][scan_key(
                    *r.shape, v.shape[-1], r.dtype, u is not None,
                    state is not None)] += 1
            return ops.rwkv6_scan(r, k, v, w, u, state)

    for module, name, wrapper, shape in sites:
        setattr(module, name, recorder(name, wrapper, shape))
    model_layers.ops = RecordingOps()
    try:
        yield
    finally:
        for module, name, wrapper, _ in sites:
            setattr(module, name, wrapper)
        model_layers.ops = ops


def flash_bwd_key(B, Sq, Skv, H, KVH, D, dtype, causal, window) -> tuple:
    """A flash backward call's shape and arguments."""
    return (B, Sq, Skv, H, KVH, D, str(dtype), bool(causal), int(window))


@contextlib.contextmanager
def recording_bwd_shapes():
    """Record the shape of every backward kernel call autograd makes on a
    CUDA tensor: the two autograd Functions' ``backward`` (which call the
    backward wrappers, and count) are wrapped to read the call's shape
    from its cotangents and the metadata ``setup_context`` keeps (never
    ``ctx.saved_tensors``: under ``torch.utils.checkpoint`` those unpack
    once)."""
    from repro_torch.kernels import ops
    real = {cls: cls.backward for cls in (ops._FlashAttention,
                                          ops._Rwkv6Scan)}

    def flash(ctx, dout, dlse):
        if on_card(dout):
            B, Sq, H, D = dout.shape
            PATH_SHAPES["flash_attention_bwd"][flash_bwd_key(
                B, Sq, ctx.kv_shape[0], H, ctx.kv_shape[1], D, dout.dtype,
                ctx.causal, ctx.window)] += 1
        return real[ops._FlashAttention](ctx, dout, dlse)

    def scan(ctx, dout, dstate, dcarry):
        if on_card(dout):
            B, T, H, Dv = dout.shape
            PATH_SHAPES["rwkv6_scan_bwd"][scan_key(
                B, T, H, dstate.shape[2], Dv, dout.dtype, ctx.bonus,
                ctx.has_state)] += 1
        return real[ops._Rwkv6Scan](ctx, dout, dstate, dcarry)

    ops._FlashAttention.backward = staticmethod(flash)
    ops._Rwkv6Scan.backward = staticmethod(scan)
    try:
        yield
    finally:
        for cls, fn in real.items():
            cls.backward = staticmethod(fn)


@contextlib.contextmanager
def recording_folded_shapes():
    """Record the shapes a seed plan launches the kernels at.  Under its
    ``torch.func.vmap`` the call sites see one seed's operands, and the
    wrappers' batching rules fold the seeds into the batch axis before
    the launch; so this records where ``ops`` reaches the launch with the
    folded operands (``_decode_attention``, ``_traj_forward``,
    ``_subtb_forward``; the backward kernels take the forwards' shapes).
    The recorded call then runs, and counts, as it would."""
    from repro_torch.kernels import ops
    sites = {"_decode_attention": ("decode_attention",
                                   lambda q, k, *a: k.shape),
             "_traj_forward": ("traj_logprob", lambda logits, *a:
                               logits.shape),
             "_subtb_forward": ("subtb_loss", lambda phi, *a: phi.shape)}
    real = {attr: getattr(ops, attr) for attr in sites}

    def recorder(attr):
        name, key = sites[attr]

        def call(*args):
            if on_card(args[0]):
                PATH_SHAPES[name][tuple(int(d) for d in key(*args))] += 1
            return real[attr](*args)
        return call

    for attr in sites:
        setattr(ops, attr, recorder(attr))
    try:
        yield
    finally:
        for attr, fn in real.items():
            setattr(ops, attr, fn)


def check_path_shapes(rows, attn, traj, subtb, flash, scan, flash_bwd,
                      scan_bwd) -> None:
    """Every shape the main path launched a kernel at has a row of that
    kernel's check (held against its plain version); fails otherwise.
    Prints each launched shape with its launches."""
    checked = {"decode_step": {tuple(r[k] for k in "BLCDHFA") for r in rows},
               "decode_attention": {(r["B"], r["S"], r["H"], r["hd"])
                                    for r in attn},
               "traj_logprob": {(f["B"], f["T"], f["A"]) for f, _ in traj},
               "subtb_loss": {(f["B"], f["T1"]) for f, _ in subtb},
               "flash_attention": {flash_key(
                   r["B"], r["Sq"], r["Skv"], r["H"], r["KVH"], r["D"],
                   r["dtype"], r["causal"], r["window"], r["q_offset"],
                   r["kv_len"]) for r in flash},
               "rwkv6_scan": {scan_key(r["B"], r["T"], r["H"], r["Dk"],
                                       r["Dv"], r["dtype"], r["bonus"],
                                       r["state"]) for r in scan},
               "flash_attention_bwd": {flash_bwd_key(
                   r["B"], r["Sq"], r["Skv"], r["H"], r["KVH"], r["D"],
                   r["dtype"], r["causal"], r["window"]) for r in flash_bwd},
               "rwkv6_scan_bwd": {scan_key(r["B"], r["T"], r["H"], r["Dk"],
                                           r["Dv"], r["dtype"], r["bonus"],
                                           r["state"]) for r in scan_bwd}}
    unchecked = {k: sorted(set(v) - checked[k])
                 for k, v in PATH_SHAPES.items()}
    emit("path_shapes", launched={k: sorted([list(key), n] for key, n
                                            in v.items())
                                  for k, v in PATH_SHAPES.items()},
         unchecked=unchecked)
    if not all(PATH_SHAPES.values()) or any(unchecked.values()):
        raise AssertionError(f"kernel shapes on the main path with no "
                             f"check row: {unchecked}")


#: the script's start, for each line's ``elapsed_s``
START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_us(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events (L2 warm, as on the serving loop)."""
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
    return start.elapsed_time(end) * 1e3 / iters


def device_rows(prof):
    """(kernel name, device us, count) of the device-side events of a
    ``torch.profiler`` run, largest first (host ops, which carry their
    kernels' time too, are left out so nothing counts twice)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[1])


class ProfilerLost(AssertionError):
    """``torch.profiler`` recorded none of a call's kernels in
    PROFILE_TRIES windows."""


def profiled_rows(fn, iters: int = 50, match: str = "") -> list:
    """``device_rows`` of ``iters`` calls of ``fn`` whose name holds
    ``match``.  Now and then the profiler hands back no kernel records for
    a short window (seen once for a 2.5 us kernel), or only some of them
    (seen as a library call read at a third of the launch floor).  A
    window in which some kernel was not recorded a whole number of times
    per call is profiled again; after PROFILE_TRIES windows the one with
    the most records counts (raises ProfilerLost, naming what the last
    window did record, if none recorded any)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, seen = [], []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = device_rows(prof)
        rows = [r for r in seen if match in r[0]]
        if rows and all(n % iters == 0 for _, _, n in rows):
            return rows
        if sum(n for _, _, n in rows) > sum(n for _, _, n in best):
            best = rows
    if not best:
        raise ProfilerLost(f"torch.profiler recorded no device time of "
                           f"{match!r} in {PROFILE_TRIES} tries; the last "
                           f"window recorded {[r[0][:60] for r in seen[:5]]}")
    return best


def profiled_device_us(fn, iters: int = 50, match: str = "") -> float:
    """Mean device time of the CUDA kernels ``fn`` launches whose name
    holds ``match``, summed from ``torch.profiler``.  Where the profiler
    records none of them (`ProfilerLost`), the time between CUDA events
    over ``iters`` calls instead (the wrapper's own small kernels
    included), with a ``profiler_fallback`` line naming the call."""
    try:
        rows = profiled_rows(fn, iters, match)
    except ProfilerLost as lost:
        us = cuda_time_us(fn, iters=iters, warmup=2)
        emit("profiler_fallback", match=match, iters=iters,
             cuda_event_us=us, reason=str(lost))
        return us
    return sum(t for _, t, _ in rows) / iters


def profiled_kernels(fn, iters: int = 50) -> dict:
    """``fn``'s device time per call from ``torch.profiler`` and every
    device kernel it saw, ``{name: launches per call}``."""
    rows = profiled_rows(fn, iters)
    return {"us": sum(t for _, t, _ in rows) / iters,
            "kernels": {name: n / iters for name, _, n in rows}}


def sdpa_backend(kernels) -> str:
    """The ``scaled_dot_product_attention`` backend named by the device
    kernels it launched."""
    names = " ".join(kernels).lower()
    for key, backend in (("fmha", "efficient"), ("flash", "flash"),
                         ("cudnn", "cudnn")):
        if key in names:
            return backend
    return "math"


def launch_floor_us(device) -> float:
    """The launch floor: profiled device time of a one-element in-place
    ``torch.add_`` (the least a kernel launch costs on the card)."""
    x = torch.zeros(1, device=device)
    return profiled_device_us(lambda: x.add_(1.0))


def named_ptxas(log: str) -> list:
    """ptxas's report with the function named on every line: each
    "Compiling entry function" line as it is, and every register, spill and
    shared-memory line after it prefixed with that function."""
    out, fn = [], "?"
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)'?", ln)
        if m:
            fn = m.group(1)
        if "Compiling entry function" in ln:
            out.append(ln.strip())
        elif "registers" in ln or "spill" in ln or "smem" in ln:
            out.append(f"{fn}: {ln.strip()}")
    return out


def spilling(lines: list) -> list:
    """Functions whose ptxas line reports spill stores or loads."""
    return sorted({ln.split(":")[0] for ln in lines
                   if re.search(r"[1-9]\d* bytes spill", ln)})


#: the kernels' sources rebuilt from a checkout of the parent commit
#: (``--parent``) to time them beside this tree's in the same run
PARENT_SOURCES = ("decode_step.cu", "decode_attention.cu", "traj_logprob.cu",
                  "subtb_loss.cu", "flash_attention_bwd.cu",
                  "rwkv6_scan_bwd.cu")


def parent_library(parent: Path):
    """Build a parent checkout's kernels (``PARENT_SOURCES``) into a library
    of their own (its own namespace); returns it and its named ptxas
    lines."""
    from repro_torch.kernels import build
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "libparent.so"
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(path),
             *(str(csrc / name) for name in PARENT_SOURCES)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"parent build failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        lib = ctypes.CDLL(str(path))
    lib.repro_decode_step.argtypes = [ctypes.POINTER(build.DecodeStepArgs),
                                      ctypes.c_void_p]
    lib.repro_decode_step.restype = ctypes.c_int
    lib.repro_decode_attention.argtypes = [
        ctypes.POINTER(build.DecodeAttentionArgs), ctypes.c_void_p]
    lib.repro_decode_attention.restype = ctypes.c_int
    lib.repro_traj_logprob_bwd.argtypes = [
        ctypes.POINTER(build.TrajLogprobArgs), ctypes.c_void_p]
    lib.repro_traj_logprob_bwd.restype = ctypes.c_int
    # the parent's operand structs are this tree's (its subtb_loss.cu,
    # flash_attention_bwd.cu and rwkv6_scan_bwd.cu take this tree's
    # SubtbArgs, FlashAttentionBwdArgs and Rwkv6ScanBwdArgs field for field)
    for fn in (lib.repro_subtb_fwd, lib.repro_subtb_bwd):
        fn.argtypes = [ctypes.POINTER(build.SubtbArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the parent's backward kernels (both on the fp32 cores, one route
    # each)
    lib.repro_flash_attention_bwd.argtypes = [
        ctypes.POINTER(build.FlashAttentionBwdArgs), ctypes.c_void_p]
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    lib.repro_rwkv6_scan_bwd.argtypes = [
        ctypes.POINTER(build.Rwkv6ScanBwdArgs), ctypes.c_void_p]
    lib.repro_rwkv6_scan_bwd.restype = ctypes.c_int
    return lib, named_ptxas(proc.stdout + proc.stderr)


def parent_call(fn, args, device):
    """A call of a parent kernel on the current stream (no launch
    counted)."""
    def call():
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device)
                 .cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent kernel launch failed: CUDA error "
                               f"{err}")
    return call


# -- phase 3: decode_step against its plain version ---------------------------

def random_step_inputs(B, L, C, D, H, F, A, seed, device):
    """Operands of one fused step, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device)

    w = {"ln1_scale": 1 + rn(L, D, scale=0.1), "ln1_bias": rn(L, D, scale=0.1),
         "q_w": rn(L, D, D, scale=D ** -0.5), "q_b": rn(L, D, scale=0.1),
         "kv_w": rn(L, D, 2 * D, scale=D ** -0.5),
         "kv_b": rn(L, 2 * D, scale=0.1),
         "proj_w": rn(L, D, D, scale=D ** -0.5),
         "proj_b": rn(L, D, scale=0.1),
         "ln2_scale": 1 + rn(L, D, scale=0.1),
         "ln2_bias": rn(L, D, scale=0.1),
         "ff1_w": rn(L, D, F, scale=D ** -0.5), "ff1_b": rn(L, F, scale=0.1),
         "ff2_w": rn(L, F, D, scale=F ** -0.5), "ff2_b": rn(L, D, scale=0.1),
         "ln_f_scale": 1 + rn(D, scale=0.1), "ln_f_bias": rn(D, scale=0.1),
         "q0": rn(D, scale=0.02)}
    lengths = torch.randint(0, C - 1, (B,), generator=g, dtype=torch.int32)
    u = torch.rand((B, A), generator=g).clamp_(1e-12, 1 - 1e-7)
    mask = torch.rand((B, A), generator=g) < 0.5
    mask[:, 0] |= ~mask.any(-1)
    return dict(
        w=w, x_new=rn(B, D, scale=0.5),
        k=rn(L, B, C, H, D // H), v=rn(L, B, C, H, D // H),
        lengths=lengths.to(device),
        slot=lengths.clamp(1, C - 1).to(device),
        gumbel=(-torch.log(-torch.log(u))).to(device),
        mask=mask.to(device),
        w_out=rn(D, A, scale=D ** -0.5), b_out=rn(A, scale=0.1),
        temp=(0.5 + torch.rand(B, generator=g)).to(device))


def step_bound(inp) -> dict:
    """Least time for one fused step on these inputs: each input byte read
    once (the cache only at the slots the masks attend), each output byte
    written once, and the fp32 operations, against the data-sheet rates."""
    w, lengths = inp["w"], inp["lengths"]
    L, B, C, H, hd = inp["k"].shape
    D, A, F = H * hd, inp["mask"].shape[1], w["ff1_w"].shape[-1]
    live = int(torch.clamp(lengths + 1, max=C).sum())
    weights = sum(t.numel() for t in w.values()) + D * A + A
    read = 4 * (weights + B * D + 2 * L * live * D + B * A + 3 * B) + B * A
    written = 4 * (2 * L * B * D + B * D + 2 * B)
    gemv = 2 * B * (L * (D * 2 * D + 2 * D * D + 2 * D * F) + D * A)
    attn = 4 * L * live * D
    flops = gemv + attn
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return {"bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + written, "flops": flops}


def step_args(inp, cache, outs, device):
    """``DecodeStepArgs`` of one call on these operands (as the wrapper
    builds them), for a parent kernel."""
    from repro_torch.kernels import build
    L, B, C, H, hd = cache["k"].shape
    ptrs = {"x_new": inp["x_new"], "k_cache": cache["k"],
            "v_cache": cache["v"], "lengths": inp["lengths"],
            "slot": inp["slot"], "logit_temp": inp["temp"],
            "gumbel": inp["gumbel"], "mask": inp["mask"],
            "w_out": inp["w_out"], "b_out": inp["b_out"], "action": outs[0],
            "log_pf": outs[1], "y": outs[2], **inp["w"]}
    return build.DecodeStepArgs(
        **{k: ptrs[k].data_ptr() for k in build.DECODE_STEP_PTRS},
        num_layers=L, batch=B, capacity=C, dim=H * hd, num_heads=H,
        ff_dim=inp["w"]["ff1_w"].shape[-1], num_actions=inp["mask"].shape[1],
        device=device.index or 0)


def check_decode_step(B, L, C, D, H, F, A, seed, device, floor_us,
                      parent=None) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_decode_step

    inp = random_step_inputs(B, L, C, D, H, F, A, seed, device)
    w = inp["w"]
    args = (inp["lengths"], inp["slot"], inp["gumbel"], inp["mask"],
            inp["w_out"], inp["b_out"], inp["temp"])

    def plain():
        return ref_decode_step(w, inp["x_new"], inp["k"].view(L, B, C, D),
                               inp["v"].view(L, B, C, D), *args,
                               num_heads=H)

    cache = {"k": inp["k"].clone(), "v": inp["v"].clone()}

    def kernel():
        return ops.decode_step(w, inp["x_new"], cache, *args, num_heads=H)

    a_r, lp_r, y_r, k_r, v_r = plain()
    a_k, lp_k, y_k, _ = kernel()
    torch.cuda.synchronize()
    # lanes whose two best scores are within TIE_GAP may pick either action
    logp = torch.log_softmax(torch.where(
        inp["mask"], (y_r @ inp["w_out"] + inp["b_out"])
        * inp["temp"][:, None], torch.finfo(torch.float32).min), -1)
    top2 = torch.topk(logp + inp["gumbel"], 2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < TIE_GAP
    same = a_r == a_k
    mismatched = int((~same & ~tie).sum())
    err = {"log_pf": float((lp_r - lp_k)[same].abs().max()) if same.any()
           else 0.0,
           "y": float((y_r - y_k).abs().max()),
           "cache": max(float((k_r - cache["k"].view(L, B, C, D)).abs().max()),
                        float((v_r - cache["v"].view(L, B, C, D)).abs().max()))}
    # the kernel's own device time, and the wrapper's (host checks and
    # launch included) between CUDA events
    kernel_us = profiled_device_us(kernel)
    wrapper_us = cuda_time_us(kernel)
    plain_us = profiled_device_us(plain, iters=10)
    plain_wall_us = cuda_time_us(plain, iters=20, warmup=3)
    parent_us = None
    if parent is not None:
        pcache = {"k": inp["k"].clone(), "v": inp["v"].clone()}
        pouts = (torch.empty(B, dtype=torch.int32, device=device),
                 torch.empty(B, device=device), torch.empty(B, D, device=device))
        parent_us = profiled_device_us(parent_call(
            parent.repro_decode_step, step_args(inp, pcache, pouts, device),
            device))
    row = {"B": B, "L": L, "C": C, "D": D, "H": H, "F": F, "A": A,
           "actions_equal": int(same.sum()), "near_ties": int(tie.sum()),
           "mismatched_actions": mismatched, "max_abs_err": err,
           "kernel_us": kernel_us, "floor_us": floor_us,
           "parent_kernel_us": parent_us, "wrapper_us": wrapper_us,
           "plain_us": plain_us, "plain_wall_us": plain_wall_us,
           **step_bound(inp)}
    emit("kernel", name="decode_step", **row)
    if mismatched or max(err.values()) > TOL or not all(
            math.isfinite(v) for v in err.values()):
        raise AssertionError(f"decode_step disagrees with its plain version "
                             f"at B={B}: {mismatched} actions, errors {err}")
    return row


def check_decode_step_lanes(device) -> dict:
    """A lane's outputs do not depend on its neighbours or its place in a
    tile: the serving batch (64 lanes) against the same lanes reversed and
    a 5-lane subset, and two calls on the same inputs; actions, log_pf, y
    and the appended cache bitwise equal."""
    from repro_torch.kernels import ops

    B, L, C, D, H, F, A = SERVE_LANES, 3, 16, 64, 8, 256, 3840
    inp = random_step_inputs(B, L, C, D, H, F, A, seed=7, device=device)

    def run(idx):
        cache = {"k": inp["k"][:, idx].clone(), "v": inp["v"][:, idx].clone()}
        a, lp, y, _ = ops.decode_step(
            inp["w"], inp["x_new"][idx], cache, inp["lengths"][idx],
            inp["slot"][idx], inp["gumbel"][idx], inp["mask"][idx],
            inp["w_out"], inp["b_out"], inp["temp"][idx], num_heads=H)
        return a, lp, y, cache["k"], cache["v"]

    every = torch.arange(B, device=device)
    full = run(every)

    def same(idx):
        out = run(idx)
        torch.cuda.synchronize()
        return (all(torch.equal(o, f[idx]) for o, f in zip(out[:3], full))
                and all(torch.equal(o, f[:, idx])
                        for o, f in zip(out[3:], full[3:])))

    checks = {"reversed": same(every.flip(0)),
              "subset_5": same(torch.tensor([3, 17, 40, 41, 63],
                                            device=device)),
              "repeat": same(every)}
    emit("decode_step_lanes", B=B, bitwise_equal=checks)
    if not all(checks.values()):
        raise AssertionError(f"decode_step lanes depend on their tile: "
                             f"{checks}")
    return checks


def timings(kernel, plain, library, match: str = "",
            plain_iters: int = 20, iters: int | None = None) -> dict:
    """Device time per call (``torch.profiler``, the kernels' own time) of
    the kernel, its plain version and the library call, so the three
    compare like for like; and each one's time per call between CUDA
    events over back-to-back calls (``*_wall_us``: host dispatch included,
    which for a chain of small ops is most of it).  ``match`` keeps the
    kernel's own device time apart from the small torch kernels its
    wrapper launches (operand checks); ``iters``, when given, is the
    number of calls of the kernel and of the library call timed each way
    (after 2 warm-up calls between the events)."""
    prof = {} if iters is None else {"iters": iters}
    wall = {} if iters is None else {"iters": iters, "warmup": 2}
    out = {"kernel_us": profiled_device_us(kernel, match=match, **prof),
           "wrapper_us": cuda_time_us(kernel, **wall),
           "plain_us": profiled_device_us(plain, iters=plain_iters),
           "plain_wall_us": cuda_time_us(plain, iters=5 * plain_iters // 2,
                                         warmup=max(1, plain_iters // 4)),
           "library_us": None, "library_wall_us": None}
    if library is not None:
        out["library_us"] = profiled_device_us(library, **prof)
        out["library_wall_us"] = cuda_time_us(library, **wall)
    return out


def bound(nbytes: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    """The larger of the byte time and the operation time at the peak of
    the operands' type (fp32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return {"bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# -- phase 3: decode_attention against its plain version ------------------------

def check_decode_attention(B, S, H, hd, kv_valid, seed, device, floor_us,
                           parent=None) -> dict:
    """The kernel and its plain version on the same inputs; the library
    yardstick is ``F.scaled_dot_product_attention`` with a boolean mask over
    the rows that attend at least one slot (it gives NaN on an empty row)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_decode_attention

    g = torch.Generator().manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g).to(device)
    q, k, v = rn(B, H, hd), rn(B, S, H, hd), rn(B, S, H, hd)
    kv = torch.as_tensor(kv_valid, dtype=torch.int32).to(device)

    def plain():
        return ref_decode_attention(q, k, v, kv)

    def kernel():
        return ops.decode_attention(q, k, v, kv)

    want, got = plain(), kernel()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    empty_exact = bool(torch.all(got[kv <= 0] == 0))
    rows = (kv >= 1).nonzero()[:, 0]
    lq, lk, lv = q[rows][:, :, None], k[rows].transpose(1, 2), \
        v[rows].transpose(1, 2)
    lmask = (torch.arange(S, device=device)[None, :]
             < kv[rows][:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)

    library_err = float((library()[:, :, 0] - want[rows]).abs().max())
    # the yardstick read three times more, each with the kernels the
    # profiler matched and the SDPA backend they name
    readings = [profiled_kernels(library) for _ in range(3)]
    for r in readings:
        r["backend"] = sdpa_backend(r["kernels"])
    live = int(torch.clamp(kv, 0, S).sum())
    nbytes = 4 * (2 * B * H * hd + 2 * live * H * hd + B)
    flops = live * H * (4 * hd + 3) + B * H * hd
    parent_us = None
    if parent is not None:
        from repro_torch.kernels import build
        pout = torch.empty_like(q)
        parent_us = profiled_device_us(parent_call(
            parent.repro_decode_attention, build.DecodeAttentionArgs(
                q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                kv_valid=kv.data_ptr(), out=pout.data_ptr(), batch=B,
                slots=S, num_heads=H, head_dim=hd,
                device=device.index or 0), device))
    row = {"B": B, "S": S, "H": H, "hd": hd, "kv_valid": list(kv_valid),
           "max_abs_err": err, "empty_rows_exact_zero": empty_exact,
           **timings(kernel, plain, library), "floor_us": floor_us,
           "parent_kernel_us": parent_us,
           "library_call": "F.scaled_dot_product_attention(bool mask), "
                           "rows with kv_valid >= 1",
           "library_max_abs_err": library_err,
           "library_readings": readings, **bound(nbytes, flops)}
    emit("kernel", name="decode_attention", **row)
    if not (err <= TOL) or not empty_exact:
        raise AssertionError(f"decode_attention disagrees with its plain "
                             f"version at {(B, S, H, hd)}: error {err}, "
                             f"empty rows exact zero {empty_exact}")
    return row


# -- phase 3: traj_logprob forward and backward against their plain versions -----

def traj_inputs(B, T, A, seed, device):
    """Time-major (T+1, B, A) logits and mask handed over as the (B, T, A)
    transposed views the training loss passes; the taken action is legal,
    and each row has a valid prefix."""
    g = torch.Generator().manual_seed(seed)
    logits = 3 * torch.randn(T + 1, B, A, generator=g)
    mask = torch.rand(T + 1, B, A, generator=g) < 0.6
    actions = torch.randint(0, A, (T, B), generator=g)
    mask[torch.arange(T)[:, None], torch.arange(B)[None, :], actions] = True
    valid = torch.arange(T)[:, None] < torch.randint(1, T + 1, (1, B),
                                                     generator=g)
    return (logits.to(device)[:-1].transpose(0, 1), actions.to(device).T,
            mask.to(device)[:-1].transpose(0, 1), valid.to(device).T,
            torch.randn(B, generator=g).to(device),
            torch.randn(T, B, generator=g).to(device).T)


def bwd_excess(d_k, d_p, actions, valid, g_total, g_step):
    """The backward's largest error over its allowance, entry by entry.
    Most entries are ``coeff * softmax`` terms of ~1e-5, so each is held to
    BWD_RTOL of its own size (plus BWD_ATOL), not only the largest error
    to TOL.  The taken action's entry is ``coeff * (1 - p)``, which cancels
    as p nears 1; it is held to BWD_RTOL of ``|coeff|``."""
    coeff = ((g_total[:, None] + g_step) * valid).abs()
    scale = d_p.abs().scatter(-1, actions.long()[..., None],
                              coeff[..., None])
    return ((d_k - d_p).abs() / (BWD_ATOL + BWD_RTOL * scale)).max()


def check_traj_logprob(B, T, A, seed, device, floor_us, parent=None):
    """Forward and backward kernels against their plain versions; returns
    the two rows.  The forward's per-step log-probs are held to TOL, its
    totals to TOL plus the fp32 summation bound of T terms,
    T * 2^-24 * sum |step| per row.  The forward's library yardstick is one
    ``F.cross_entropy(reduction="none")`` over logits masked beforehand
    (timed alone); the backward has none.  With ``parent`` the parent's
    backward kernel is timed on the same inputs (``parent_kernel_us``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (ref_traj_logprob,
                                         ref_traj_logprob_backward)

    logits, actions, mask, valid, g_total, g_step = traj_inputs(
        B, T, A, seed, device)
    nbt, nbta = B * T, B * T * A
    shape = {"B": B, "T": T, "A": A}

    def fwd_kernel():
        with torch.no_grad():
            return ops.traj_logprob(logits, actions, mask, valid)

    def fwd_plain():
        return ref_traj_logprob(logits, actions, mask, valid)

    (t_k, s_k), (t_p, s_p) = fwd_kernel(), fwd_plain()
    again = fwd_kernel()
    torch.cuda.synchronize()
    err = max(float((t_k - t_p).abs().max()), float((s_k - s_p).abs().max()))
    step_err = float((s_k - s_p).abs().max())
    # a total sums T fp32 terms, in another order on each side: each side
    # is off the exact sum by at most T * 2^-24 * sum |step| (the
    # worst-case summation bound), which at T = 81 and totals of ~450 is
    # above 1e-4 (3 ulps there)
    total_allowed = TOL + T * 2.0 ** -24 * s_p.abs().sum(-1)
    total_excess = float(((t_k - t_p).abs() / total_allowed).max())
    bitwise = bool(torch.equal(again[0], t_k) and torch.equal(again[1], s_k))
    premasked = torch.where(mask, logits, torch.finfo(torch.float32).min
                            ).reshape(nbt, A)
    flat_actions = actions.reshape(nbt)

    def library():
        return F.cross_entropy(premasked, flat_actions, reduction="none")

    library_err = float((-library().reshape(B, T) - s_p)[valid].abs().max())
    fwd = {**shape, "max_abs_err": err, "step_max_abs_err": step_err,
           "total_max_err_over_allowed": total_excess,
           "allowed": f"steps {TOL}; totals {TOL} + T * 2^-24 * sum |step|",
           "repeat_bitwise_equal": bitwise,
           **timings(fwd_kernel, fwd_plain, library,
                     match="traj_logprob_fwd"),
           "library_call": "F.cross_entropy(reduction='none') on logits "
                           "masked beforehand, timed alone",
           "library_max_abs_err": library_err,
           **bound(4 * nbta + nbta + 8 * nbt + nbt + 4 * (B + nbt),
                   5 * nbta)}
    emit("kernel", name="traj_logprob_fwd", **fwd)

    def bwd_kernel():
        return ops.traj_logprob_backward(logits, actions, mask, valid,
                                         g_total, g_step)

    def bwd_plain():
        return ref_traj_logprob_backward(logits, actions, mask, valid,
                                         g_total, g_step)

    d_k, d_p = bwd_kernel(), bwd_plain()
    torch.cuda.synchronize()
    berr = float((d_k - d_p).abs().max())
    b_excess = float(bwd_excess(d_k, d_p, actions, valid, g_total, g_step))
    parent_us = None
    if parent is not None:
        pout = torch.empty(B, T, A, device=device)
        parent_us = profiled_device_us(parent_call(
            parent.repro_traj_logprob_bwd, ops._traj_args(
                logits, actions, mask, valid, g_total=g_total, g_step=g_step,
                dlogits=pout), device), match="traj_logprob")
    bwd = {**shape, "max_abs_err": berr,
           "max_err_over_allowed": b_excess,
           "allowed": f"{BWD_ATOL} + {BWD_RTOL} * |plain| (the taken "
                      f"action's entry: * |coeff|)",
           **timings(bwd_kernel, bwd_plain, None, match="traj_logprob"),
           "floor_us": floor_us, "parent_kernel_us": parent_us,
           **bound(4 * nbta + nbta + 8 * nbt + nbt + 4 * (B + nbt)
                   + 4 * nbta, 9 * nbta)}
    emit("kernel", name="traj_logprob_bwd", **bwd)
    if not (step_err <= TOL and total_excess <= 1 and berr <= TOL
            and b_excess <= 1 and bitwise):
        raise AssertionError(f"traj_logprob disagrees with its plain "
                             f"version at {(B, T, A)}: forward {err} "
                             f"({total_excess} of the totals' allowance), "
                             f"backward {berr} ({b_excess} of the "
                             f"element-wise allowance), repeat bitwise "
                             f"{bitwise}")
    return fwd, bwd


# -- phase 3: subtb_loss forward and backward against their plain versions --------

def subtb_inputs(B, T1, seed, device, kind="normal", offset=0.0):
    """Time-major potentials (T+1, B), N(0, 1) or a random walk along T,
    plus ``offset`` (the level log Z sets), handed over as the (B, T+1)
    view the loss passes; lengths (int64, as the loss gives them) starting
    T, 0, 1 (a single row gets T); a cotangent."""
    g = torch.Generator().manual_seed(seed)
    phi_tm = torch.randn(T1, B, generator=g)
    if kind == "walk":
        phi_tm = phi_tm.cumsum(0)
    phi_tm = phi_tm + offset
    length = torch.randint(0, T1, (B,), generator=g)
    length[:3] = torch.tensor([T1 - 1, 0, 1])[:B]
    return (phi_tm.to(device).T, length.to(device),
            torch.randn(B, generator=g).to(device))


def row_err_over_scale(got, want) -> float:
    """The largest error over the largest entry, trajectory by trajectory
    (a short trajectory's large entries would hide a long one's errors),
    the worst of them; a row whose gradient is all 0 counts as inf unless
    it is exactly 0."""
    scale = want.abs().amax(1)
    err = (got - want).abs().amax(1)
    live = scale > 0
    dead_exact = bool(torch.all(err[~live] == 0))
    worst = float((err[live] / scale[live]).max()) if live.any() else 0.0
    return worst if dead_exact else math.inf


def parent_subtb_us(parent, fn, phi, length, lam, device, **ptrs) -> float:
    """Device time of one of the parent's SubTB kernels on these inputs."""
    from repro_torch.kernels import build
    B, T1 = phi.shape
    length32 = length.to(torch.int32).contiguous()
    args = build.SubtbArgs(
        phi=phi.data_ptr(), length=length32.data_ptr(),
        **{k: v.data_ptr() for k, v in ptrs.items()},
        phi_sb=phi.stride(0), phi_st=phi.stride(1), lam=lam, batch=B,
        states=T1, device=device.index or 0)
    return profiled_device_us(parent_call(fn, args, device), match="subtb")


def check_subtb(B, T1, lam, seed, device, floor_us, kind="normal",
                offset=0.0, parent=None):
    """Forward and backward kernels against their plain versions at one
    shape; returns the two rows.  No single PyTorch call computes the
    SubTB form, so there is no library yardstick.  The kernel's device
    time is its own kernel's (``subtb``); the wrapper's operand checks
    (an ``aminmax`` of the lengths and their int32 copy) are in
    ``wrapper_us``.  The bound counts what the O(T) scan needs: phi read
    once, the lengths, the loss or dphi written once; ~20 FLOP an
    on-trajectory state forward, ~40 backward.  With ``parent`` the
    parent's kernels are timed on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_subtb, ref_subtb_backward

    phi, length, g = subtb_inputs(B, T1, seed, device, kind, offset)
    n = length.long().cpu()
    on_traj = int((n + 1).sum())
    shape = {"B": B, "T1": T1, "lam": lam, "phi": kind, "offset": offset,
             "lengths": n.tolist()[:8]}

    def fwd_kernel():
        with torch.no_grad():
            return ops.subtb_loss(phi, length, lam)

    def fwd_plain():
        return ref_subtb(phi, length, lam)

    got, want = fwd_kernel(), fwd_plain()
    again = fwd_kernel()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    bitwise = bool(torch.equal(again, got))
    zero_exact = bool(torch.all(got[length == 0] == 0))
    parent_fwd = parent_bwd = None
    if parent is not None:
        parent_fwd = parent_subtb_us(
            parent, parent.repro_subtb_fwd, phi, length, lam, device,
            loss=torch.empty(B, device=device))
    fwd = {**shape, "max_abs_err": err, "max_rel_err": rel,
           "repeat_bitwise_equal": bitwise, "empty_rows_exact_zero":
           zero_exact, **timings(fwd_kernel, fwd_plain, None, match="subtb"),
           "floor_us": floor_us, "parent_kernel_us": parent_fwd,
           **bound(4 * on_traj + 8 * B + 4 * B, 20 * on_traj)}
    emit("kernel", name="subtb_loss_fwd", **fwd)

    def bwd_kernel():
        return ops.subtb_loss_backward(phi, length, g, lam)

    def bwd_plain():
        return ref_subtb_backward(phi, length, lam, g)

    d_k, d_p = bwd_kernel(), bwd_plain()
    d_again = bwd_kernel()
    torch.cuda.synchronize()
    berr = float((d_k - d_p).abs().max())
    scale = float(d_p.abs().max())
    b_bitwise = bool(torch.equal(d_again, d_k))
    b_zero_exact = bool(torch.all(d_k[length == 0] == 0))
    if parent is not None:
        parent_bwd = parent_subtb_us(
            parent, parent.repro_subtb_bwd, phi, length, lam, device, g=g,
            dphi=torch.empty(B, T1, device=device))
    bwd = {**shape, "max_abs_err": berr,
           "max_err_over_scale": berr / scale if scale else berr,
           "max_row_err_over_scale": row_err_over_scale(d_k, d_p),
           "repeat_bitwise_equal": b_bitwise,
           "empty_rows_exact_zero": b_zero_exact,
           **timings(bwd_kernel, bwd_plain, None, match="subtb"),
           "floor_us": floor_us, "parent_kernel_us": parent_bwd,
           **bound(4 * on_traj + 8 * B + 4 * B + 4 * B * T1, 40 * on_traj)}
    emit("kernel", name="subtb_loss_bwd", **bwd)
    if not (rel <= TOL and bitwise and zero_exact and b_bitwise
            and b_zero_exact and bwd["max_err_over_scale"] <= TOL
            and bwd["max_row_err_over_scale"] <= TOL):
        raise AssertionError(f"subtb_loss disagrees with its plain version "
                             f"at {(B, T1, lam, kind, offset)}: forward rel "
                             f"{rel}, backward {bwd['max_err_over_scale']} "
                             f"of its scale ({bwd['max_row_err_over_scale']}"
                             f" row by row), repeat bitwise {bitwise} / "
                             f"{b_bitwise}, n = 0 exact zero {zero_exact} / "
                             f"{b_zero_exact}")
    return fwd, bwd


# -- phase 3: flash_attention and rwkv6_scan against their plain versions ---------

def _held(got, want, bf16: bool) -> dict:
    """Hold ``got`` to ``want`` entry by entry, in fp32: |got - want| <=
    rtol |want| + atol rms(want), (rtol, atol) = (BF16_RTOL, BF16_ATOL_RMS)
    for bf16 outputs and (TOL, TOL) for fp32.  ``excess`` is the largest
    ratio of an entry's error to what it is allowed (the check: <= 1); the
    median |want| and rms(want) stand beside it to show the margin."""
    got, want = got.float(), want.float()
    rtol, atol = (BF16_RTOL, BF16_ATOL_RMS) if bf16 else (TOL, TOL)
    diff = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    allowed = rtol * want.abs() + atol * rms
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / allowed)
    return {"max_abs_err": float(diff.max()), "excess": float(ratio.max()),
            "want_median_abs": float(want.abs().median()), "want_rms": rms,
            "tol": f"{rtol:g} |want| + {atol:g} rms(want), entry by entry"}


def check_flash_attention(B, Sq, Skv, H, KVH, D, *, causal, window,
                          bf16, seed, device, q_offset=0,
                          kv_len=None) -> dict:
    """The kernel, its plain version (dense, fp32 scores) and, as the
    library yardstick, ``F.scaled_dot_product_attention`` with the same
    boolean mask on (B, H, S, D) operands (kv heads repeated beforehand)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_mask, ref_flash_attention

    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.randn(shape, generator=g).to(device, dt) for shape in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)

    def plain():
        return ref_flash_attention(q, k, v, **kw)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    want = plain()
    routes = flash_routes()
    got = kernel()
    torch.cuda.synchronize()
    route = [r for r, n in flash_routes().items() if n != routes[r]]
    held = _held(got, want, bf16)
    mask = attention_mask(Sq, Skv, device=device, **kw)
    G = H // KVH
    lq = q.transpose(1, 2).contiguous()
    lk, lv = (x.repeat_interleave(G, 2).transpose(1, 2).contiguous()
              for x in (k, v))

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)

    library_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
    pairs = int(mask.sum()) * B * H             # attended (query, key) pairs
    rows = Skv if kv_len is None else min(Skv, kv_len)  # K / V rows read
    nbytes = q.element_size() * (2 * q.numel() + 2 * B * rows * KVH * D)
    row = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KVH": KVH, "D": D,
           "dtype": str(dt), "causal": causal, "window": window,
           "q_offset": q_offset, "kv_len": kv_len, "route": route, **held,
           **timings(kernel, plain, library, match=FLASH_MATCH),
           "library_call": "F.scaled_dot_product_attention(bool mask), kv "
                           "heads repeated",
           "library_max_abs_err": library_err, "attended_pairs": pairs,
           **bound(nbytes, 4 * D * pairs,
                   BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)}
    emit("kernel", name="flash_attention", **row)
    if not held["excess"] <= 1 or route != [ops.flash_route(dt, D)]:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {(B, Sq, Skv, H, KVH, D)}: {held}, "
                             f"route {route}")
    return row


def scan_inputs(B, T, H, Dk, Dv, *, bonus, state, bf16, decay, seed,
                device):
    """r, k, v ~ N(0, 1) in the working dtype; w fp32 by ``decay``: "mild"
    in [0.35, 0.95] as the JAX tests draw it, "strong" log-uniform in
    [1e-8, 0.3] (0.3^64 < 1e-30: a chunk's product far below the JAX chunk
    form's clamp); u ~ 0.1 N(0, 1); a state ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    rn = lambda *shape: torch.randn(shape, generator=g)
    r, k, v = (rn(*shape).to(device, dt) for shape in (
        (B, T, H, Dk), (B, T, H, Dk), (B, T, H, Dv)))
    if decay == "mild":
        w = 0.35 + 0.6 * torch.sigmoid(rn(B, T, H, Dk))
    else:
        lo, hi = math.log(1e-8), math.log(0.3)
        w = torch.exp(lo + (hi - lo) * torch.rand(B, T, H, Dk, generator=g))
    u = (0.1 * rn(H, Dk)).to(device) if bonus else None
    s0 = rn(B, H, Dk, Dv).to(device) if state else None
    return r, k, v, w.to(device), u, s0


def check_rwkv6_scan(B, T, H, Dk, Dv, *, bonus, state, bf16, seed,
                     device, decay="mild") -> dict:
    """The kernel of the route ``ops.scan_route`` picks against its plain
    version (the step recurrence the CPU branch runs; one torch op chain
    per step, so it is timed over a few calls when T is long), on
    :func:`scan_inputs`.  The output is held as a bf16 or fp32 output, the
    fp32 state as fp32.  A row on the chunk route also runs the recurrence
    kernel on the same inputs (the route forced here), holds it too, and
    times it beside the chunk kernels (and each of their three passes); a
    repeat call must be bitwise equal.  The plain version is profiled
    over about PLAIN_SCAN_STEPS steps in all (at least one call): each
    step is a chain of small launches, and the profiler's records of a
    long one cost seconds to read.
    No library call computes this recurrence."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rwkv6

    dt = torch.bfloat16 if bf16 else torch.float32
    r, k, v, w, u, s0 = scan_inputs(B, T, H, Dk, Dv, bonus=bonus, state=state,
                                    bf16=bf16, decay=decay, seed=seed,
                                    device=device)

    def plain():
        return ref_rwkv6(r, k, v, w, u, s0)

    def kernel():
        return ops.rwkv6_scan(r, k, v, w, u, s0)

    want_o, want_s = plain()
    routes = scan_routes()
    got_o, got_s = kernel()
    torch.cuda.synchronize()
    route = [n for n, c in scan_routes().items() if c != routes[n]]
    held = {"o": _held(got_o, want_o, bf16),
            "state": _held(got_s, want_s, False)}
    again_o, again_s = kernel()
    bitwise = torch.equal(again_o, got_o) and torch.equal(again_s, got_s)
    nbytes = (r.element_size() * (2 * r.numel() + 2 * v.numel())
              + 4 * w.numel() + 4 * B * H * Dk * Dv * (2 if state else 1))
    flops = 4 * Dk * Dv * B * T * H
    row = {"B": B, "T": T, "H": H, "Dk": Dk, "Dv": Dv, "dtype": str(dt),
           "bonus": bonus, "state": state, "decay": decay, "route": route,
           "max_abs_err": {n: h["max_abs_err"] for n, h in held.items()},
           "held": held, "repeat_bitwise_equal": bitwise,
           **timings(kernel, plain, None,
                     match=SCAN_ROUTE_MATCH[ops.scan_route(dt, T)],
                     plain_iters=max(1, min(20, PLAIN_SCAN_STEPS // T))),
           **bound(nbytes, flops)}
    if route == ["chunk"]:
        with forced_scan_route("recurrence"):
            rec_o, rec_s = kernel()
            torch.cuda.synchronize()
            row["recurrence_held"] = {"o": _held(rec_o, want_o, bf16),
                                      "state": _held(rec_s, want_s, False)}
            row["recurrence_us"] = profiled_device_us(
                kernel, match=SCAN_ROUTE_MATCH["recurrence"])
        # the chunk route's three launches, each alone
        row["chunk_pass_us"] = {
            name: profiled_device_us(kernel, match=f"rwkv6_chunk_{name}_")
            for name in ("state", "carry", "out")}
    emit("kernel", name="rwkv6_scan", **row)
    excess = [h["excess"] for h in held.values()] + [
        h["excess"] for h in row.get("recurrence_held", {}).values()]
    if not all(e <= 1 for e in excess) or not bitwise \
            or route != [ops.scan_route(dt, T)]:
        raise AssertionError(f"rwkv6_scan disagrees with its plain version "
                             f"at {(B, T, H, Dk, Dv)} ({decay} decay): "
                             f"{held}, route {route}, repeat bitwise equal "
                             f"{bitwise}, recurrence route "
                             f"{row.get('recurrence_held')}")
    return row


# -- phase 4: the serving path -------------------------------------------------

def serve_phase(device) -> dict:
    """Serve four requests through the scheduler at full width; hold every
    sample against ``forward_rollout``; return the main path's kernel
    launches."""
    import numpy as np

    from repro_torch.core.rollout import forward_rollout
    from repro_torch.serve import SampleRequest, Scheduler

    smi = nvidia_smi()
    t0 = time.perf_counter()
    sched = Scheduler(num_lanes=SERVE_LANES, init_seed=0, device=device)
    # warm-up: builds the engine (n=120, k=8; 3-layer dim-64 policy) and
    # runs its step once, so the timed run below is steady state
    sched.submit(SampleRequest(env="bitseq", num_samples=SERVE_LANES,
                               seed=1000))
    sched.run()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [SampleRequest(env="bitseq", num_samples=16, seed=1),
            SampleRequest(env="bitseq", num_samples=64, seed=2,
                          logit_temp=0.8),
            SampleRequest(env="bitseq", num_samples=7, seed=3,
                          reward_beta=2.0),
            SampleRequest(env="bitseq", num_samples=200, seed=4,
                          logit_temp=0.8, reward_beta=2.0)]
    engine = sched.engine_for(reqs[0])
    steps0, blocks0 = engine.steps_run, engine.blocks_run

    reset_launches()
    t0 = time.perf_counter()
    rids = [sched.submit(r) for r in reqs]
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    env, params, policy = engine.env.env, engine.inner_params, engine.policy
    n_samples = 0
    for req, rid in zip(reqs, rids):
        res = results[rid]
        samples = np.asarray(res.samples)
        ref = forward_rollout(req.seed, env, params, policy, req.num_samples,
                              logit_temp=req.logit_temp)
        ref_tokens = ref.obs[-1].cpu().numpy()
        ref_log_r = (torch.tensor(req.reward_beta, dtype=torch.float32,
                                  device=device)
                     * ref.log_reward).cpu().numpy()
        log_r = np.asarray(res.log_rewards, np.float32)
        if samples.shape != (req.num_samples, env.L):
            raise AssertionError(f"request {rid}: samples of shape "
                                 f"{samples.shape}")
        if not np.array_equal(samples, ref_tokens):
            raise AssertionError(
                f"request {rid}: {int((samples != ref_tokens).any(1).sum())}"
                f" of {req.num_samples} samples differ from forward_rollout")
        if (samples == env.empty).any() or \
                not (np.asarray(res.steps) == env.L).all():
            raise AssertionError(f"request {rid}: a sample is not terminal")
        if not np.isfinite(log_r).all() or \
                np.abs(log_r - ref_log_r).max() > 1e-6:
            raise AssertionError(f"request {rid}: log_r {log_r[:4]} vs "
                                 f"forward_rollout {ref_log_r[:4]}")
        n_samples += req.num_samples
    if launches["decode_step"] == 0:
        raise AssertionError("the serving path never launched decode_step")
    lat = np.asarray([results[r].latency_s for r in rids])
    emit("serve", nvidia_smi=smi, env="bitseq n=120 k=8 (A=3840)",
         policy="decode arch, 3 layers, dim 64, 8 heads, F 256",
         lanes=SERVE_LANES, requests=len(reqs), samples=n_samples,
         wall_s=wall, samples_per_s=n_samples / wall,
         requests_per_s=len(reqs) / wall,
         latency_p50_s=float(np.percentile(lat, 50)),
         latency_p99_s=float(np.percentile(lat, 99)),
         lane_steps=engine.steps_run - steps0,
         blocks=engine.blocks_run - blocks0,
         launches=launches, setup_s=setup_s,
         matches_forward_rollout=True)
    profile_serve(sched, device)
    return launches


def profile_serve(sched, device) -> None:
    """Where a serve run's time goes: one request mix timed plain, then
    under ``torch.profiler`` (device time by kernel; the device's idle
    share of the plain run's wall time), then under ``cProfile`` (host
    functions by own time; cProfile slows Python calls, so read shares,
    not times)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import SampleRequest

    def mix(first_seed):
        for seed in (first_seed, first_seed + 1):
            sched.submit(SampleRequest(env="bitseq", num_samples=128,
                                       seed=seed))
        sched.run()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix(11)
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mix(21)
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    host = cProfile.Profile()
    host.runcall(mix, 31)
    stats = pstats.Stats(host).stats
    total = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    emit("serve_profile", samples=256, wall_us=wall_us, device_busy_us=busy,
         device_idle_share=1 - busy / wall_us,
         device_top=[{"name": k[:70], "device_us": t, "calls": c}
                     for k, t, c in rows[:10]],
         host_top=[{"function": f"{Path(f).name}:{ln}:{fn}",
                    "own_share": v[2] / total, "calls": v[1]}
                   for (f, ln, fn), v in top])


# -- phase 4b: the serving tier ---------------------------------------------------

#: the seven servable envs at the registry's defaults (bitseq n=120, k=8;
#: AMP max_len 60; hypergrid 4x8^4; phylo DS1; dag d=5); a rehearsal on
#: the CPU patches in the smoke overrides
SERVE_TIER_ENVS = {name: {} for name in ("bitseq", "tfbind8", "qm9", "amp",
                                         "hypergrid", "phylo", "dag")}
SERVE_TIER_LANES = 64
#: per env: the held pair's samples per request, then the timed requests
#: (at least the count, samples each; from SERVE_TIER_CLIENTS threads,
#: distinct seeds, so dedup never answers them), sent until the window
#: also spans SERVE_TIER_WINDOW_S: samples/s is read over that window and
#: p50 / p99 over its requests alone.  Every held request asks for 8, 32
#: or 64 samples: its forward_rollout reference launches decode_step at
#: that batch, and each such shape has a kernel row
SERVE_TIER_PAIR = 64
SERVE_TIER_TIMED = (64, 32)
SERVE_TIER_WINDOW_S = 3.0
SERVE_TIER_CLIENTS = 4
#: the autosize buckets of bitseq's pool, each prewarmed: 16, 32, 64
SERVE_TIER_BUCKETS = (16, 64)


def _http(port, method, path, doc=None):
    """One request to the local endpoint; (status, headers, body)."""
    from http.client import HTTPConnection
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = None if doc is None else json.dumps(doc)
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _serving(target):
    """``make_server(target)`` on 127.0.0.1 and a free port, serving on a
    thread; returns (server, thread, port)."""
    import threading

    from repro_torch.serve import make_server
    server = make_server(target, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, server.server_address[1]


def _stop_serving(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)


class _Oracle:
    """Holds a served body against ``forward_rollout`` of its request on
    the objects its engine serves: samples and steps bitwise, log_r within
    1e-6 of beta x the rollout's (relative above 1)."""

    def __init__(self, sched):
        self.sched = sched

    def check(self, doc, body, what) -> float:
        import numpy as np

        from repro_torch.core.rollout import forward_rollout
        from repro_torch.serve import SampleRequest
        req = SampleRequest(**doc)
        eng = self.sched.engine_for(req)
        temp = req.logit_temp if req.logit_temp != 1.0 else None
        if temp is not None and not eng.cached:
            raise AssertionError(f"{what}: a tempered full-obs request is "
                                 "held against a one-lane engine instead")
        ref = forward_rollout(req.seed, eng.env.env, eng.inner_params,
                              eng.policy, req.num_samples, logit_temp=temp)
        want = ref.obs[-1].cpu().numpy()
        got = np.asarray(body["samples"])
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(
                f"{what}: samples differ from forward_rollout "
                f"({got.shape} vs {want.shape})")
        want_r = (torch.tensor(req.reward_beta, dtype=torch.float32,
                               device=ref.log_reward.device)
                  * ref.log_reward).cpu().numpy()
        got_r = np.asarray(body["log_rewards"], np.float32)
        err = float(np.max(np.abs(got_r - want_r)
                           / np.maximum(1.0, np.abs(want_r))))
        if not np.isfinite(got_r).all() or err > 1e-6:
            raise AssertionError(f"{what}: log_r off forward_rollout by "
                                 f"{err}")
        if list(body["steps"]) != ref.valid.sum(0).cpu().tolist():
            raise AssertionError(f"{what}: steps differ")
        return err


def _one_lane(sched, doc):
    """The request alone on a one-lane engine of the same objects (a
    tempered full-observation request's reference)."""
    from repro_torch.serve import SampleRequest, SamplingEngine
    req = SampleRequest(**doc)
    eng = sched.engine_for(req)
    solo = SamplingEngine(eng.env.env, eng.inner_params, eng.policy,
                          num_lanes=1)
    rid = solo.submit(num_samples=req.num_samples, seed=req.seed,
                      logit_temp=req.logit_temp, reward_beta=req.reward_beta)
    return solo.run()[rid]


def _clients(port, docs, threads):
    """``docs`` POSTed from ``threads`` client threads (round robin);
    returns [(doc, status, body, seconds)] in the order answered."""
    import threading
    out, lock = [], threading.Lock()

    def client(mine):
        for doc in mine:
            t0 = time.perf_counter()
            status, _, body = _http(port, "POST", "/sample", doc)
            dt = time.perf_counter() - t0
            with lock:
                out.append((doc, status, body, dt))

    ts = [threading.Thread(target=client, args=(docs[i::threads],))
          for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    if any(t.is_alive() for t in ts):
        raise AssertionError("an HTTP client hung")
    return out


def _timed_clients(port, make_doc, threads, min_requests, min_window_s):
    """``make_doc(i)`` for i = 0, 1, ... POSTed from ``threads`` client
    threads, each taking the next i, until at least ``min_requests`` were
    sent and ``min_window_s`` has passed; returns (answers as
    :func:`_clients` does, the window's seconds)."""
    import itertools
    import threading
    out, lock = [], threading.Lock()
    counter = itertools.count()
    t0 = time.perf_counter()

    def client():
        while True:
            with lock:
                i = next(counter)
                if (i >= min_requests
                        and time.perf_counter() - t0 >= min_window_s):
                    return
            doc = make_doc(i)
            t1 = time.perf_counter()
            status, _, body = _http(port, "POST", "/sample", doc)
            dt = time.perf_counter() - t1
            with lock:
                out.append((doc, status, body, dt))

    ts = [threading.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    if any(t.is_alive() for t in ts):
        raise AssertionError("an HTTP client hung")
    return out, time.perf_counter() - t0


def serve_tier_phase(device) -> dict:
    """The serving tier as users run it: a ``ServeFront`` over a
    ``Scheduler`` on the card behind the HTTP endpoint; every servable env
    at full width (each body held against ``forward_rollout``; launches
    counted one env at a time), concurrent clients, dedup, the idle share
    of a mix, the drain, then the fault paths and autosize with prewarm on
    fronts of their own.  Returns the per-env runs' launches, summed."""
    import numpy as np

    from repro_torch.envs.registry import get_env
    from repro_torch.serve import SampleRequest, Scheduler, ServeFront

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    sched = Scheduler(num_lanes=SERVE_TIER_LANES, device=device)
    front = ServeFront(sched, checkpoint_poll_s=None)
    server, sthread, port = _serving(front)
    oracle = _Oracle(sched)
    total = {k: 0 for k in wrappers()}
    per_env = {}
    seed = 10_000
    for name, ov in SERVE_TIER_ENVS.items():
        kv = get_env(name).serving == "kv-cache"
        t0 = time.perf_counter()
        status, _, body = _http(port, "POST", "/sample",
                                {"env": name, "overrides": ov,
                                 "num_samples": 4, "seed": 1})
        if status != 200:
            raise AssertionError(f"{name}: warm-up answered {status} {body}")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pair = [{"env": name, "overrides": ov, "num_samples": SERVE_TIER_PAIR,
                 "seed": seed, "reward_beta": 2.0},
                {"env": name, "overrides": ov, "num_samples": SERVE_TIER_PAIR,
                 "seed": seed + 1, "logit_temp": 0.8 if kv else 1.0}]
        min_req, n_samp = SERVE_TIER_TIMED
        base = seed + 2
        seed += 100_000
        reset_launches()
        t0 = time.perf_counter()
        answered = _clients(port, pair, 2)
        pair_wall = time.perf_counter() - t0
        answered_timed, wall = _timed_clients(
            port, lambda i, base=base: {"env": name, "overrides": ov,
                                        "num_samples": n_samp,
                                        "seed": base + i},
            SERVE_TIER_CLIENTS, min_req, SERVE_TIER_WINDOW_S)
        n_req = len(answered_timed)
        torch.cuda.synchronize()
        launches = read_launches()
        errs = []
        for doc, status, body, _ in answered + answered_timed:
            if status != 200:
                raise AssertionError(f"{name}: {status} {body}")
            errs.append(oracle.check(doc, body,
                                     f"{name} seed {doc['seed']}"))
        lat = [dt for *_, dt in answered_timed]
        if kv and launches["decode_step"] == 0:
            raise AssertionError(f"{name}: decode_step never launched")
        if not kv and any(launches.values()):
            raise AssertionError(f"{name}: the full-observation tier "
                                 f"launched {launches}")
        for k in total:
            total[k] += launches[k]
        eng = sched.engine_for(SampleRequest(env=name, overrides=ov))
        per_env[name] = launches["decode_step"]
        emit("serve_tier_env", env=name, tier=get_env(name).serving,
             overrides=ov, lanes=eng.num_lanes,
             steps_per_sync=eng.steps_per_sync, build_s=build_s,
             pair_samples=2 * SERVE_TIER_PAIR, pair_wall_s=pair_wall,
             timed_requests=n_req, timed_samples=n_req * n_samp,
             wall_s=wall, samples_per_s=n_req * n_samp / wall,
             latency_p50_s=float(np.percentile(lat, 50)),
             latency_p99_s=float(np.percentile(lat, 99)),
             launches=launches, max_log_r_err=max(errs),
             matches_forward_rollout=True)
    # a tempered full-observation request against the same request alone
    # on one lane (forward_rollout takes no temperature off the fused
    # branch)
    doc = {"env": "hypergrid", "overrides": SERVE_TIER_ENVS["hypergrid"],
           "num_samples": 16, "seed": 77, "logit_temp": 0.8,
           "reward_beta": 2.0}
    status, _, body = _http(port, "POST", "/sample", doc)
    solo = _one_lane(sched, doc)
    if status != 200 or not np.array_equal(np.asarray(body["samples"]),
                                           solo.samples) \
            or not np.array_equal(np.asarray(body["log_rewards"],
                                             np.float32), solo.log_rewards):
        raise AssertionError("tempered hypergrid differs from its one-lane "
                             "engine")

    # concurrency: 8 clients, a mixed batch each, every request once
    names = list(SERVE_TIER_ENVS)
    docs = [{"env": names[(c + j) % len(names)],
             "overrides": SERVE_TIER_ENVS[names[(c + j) % len(names)]],
             "num_samples": 8, "seed": 20_000 + 3 * c + j,
             "reward_beta": 2.0 if j == 1 else 1.0}
            for c in range(8) for j in range(3)]
    t0 = time.perf_counter()
    answered = _clients(port, docs, 8)
    mixed_wall = time.perf_counter() - t0
    if sorted(d["seed"] for d, *_ in answered) != \
            sorted(d["seed"] for d in docs):
        raise AssertionError("a concurrent request was not answered once")
    for doc, status, body, _ in answered:
        if status != 200:
            raise AssertionError(f"concurrent {doc['env']}: {status}")
        oracle.check(doc, body, f"concurrent {doc['env']} {doc['seed']}")
    clat = [dt for *_, dt in answered]

    # dedup: a repeated request moves the engine's dedup counters and is
    # answered with the original's body
    first = {"env": "tfbind8", "overrides": SERVE_TIER_ENVS["tfbind8"],
             "num_samples": 16, "seed": 30_000, "logit_temp": 0.8}
    eng = sched.engine_for(SampleRequest(**first))
    _, _, a = _http(port, "POST", "/sample", first)
    before = dict(eng.counters)
    _, _, b = _http(port, "POST", "/sample", first)
    hits = (eng.counters["dedup_hits"] - before["dedup_hits"]
            + eng.counters["dedup_joins"] - before["dedup_joins"])
    if hits != 1 or not b["deduped"] or b["samples"] != a["samples"] \
            or b["log_rewards"] != a["log_rewards"]:
        raise AssertionError(f"dedup: {hits} hits, deduped={b['deduped']}")
    dedup = {k: eng.counters[k] for k in ("dedup_hits", "dedup_joins",
                                          "dedup_misses")}
    health = _http(port, "GET", "/healthz")[2]
    envs_doc = _http(port, "GET", "/envs")[2]
    stats = _http(port, "GET", "/stats")[2]
    if health["status"] != "ok" or health["runners"] != len(names) \
            or len(envs_doc["envs"]) != 9 or len(stats["engines"]) != \
            len(names):
        raise AssertionError(f"healthz {health}")

    idle = serve_tier_profile(front)

    # drain: requests in flight finish, then nothing is admitted
    futs = [front.submit(SampleRequest(env=n, overrides=SERVE_TIER_ENVS[n],
                                       num_samples=SERVE_TIER_LANES,
                                       seed=40_000 + i))
            for i, n in enumerate(("amp", "phylo", "bitseq"))]
    report = front.shutdown(drain=True, timeout=300)
    if not report["drained"] or not all(
            f.done() and f.exception() is None for f in futs):
        raise AssertionError(f"drain: {report}")
    status, _, body = _http(port, "POST", "/sample", docs[0])
    if status != 503 or body["kind"] != "shutting_down":
        raise AssertionError(f"after the drain: {status} {body}")
    _stop_serving(server, sthread)

    faults = serve_tier_faults(device)
    autosize = serve_tier_autosize(device)
    emit("serve_tier", nvidia_smi=smi, lanes=SERVE_TIER_LANES,
         envs=names, decode_step_by_env=per_env, launches=total,
         concurrent_requests=len(docs), concurrent_wall_s=mixed_wall,
         concurrent_p50_s=float(np.percentile(clat, 50)),
         concurrent_p99_s=float(np.percentile(clat, 99)),
         dedup=dedup, drain=report, profile_idle_share=idle,
         faults=faults, autosize=autosize,
         phase_s=time.perf_counter() - t_phase)
    return total


def serve_tier_profile(front) -> float:
    """A hypergrid and an AMP request at once through the front, timed
    plain, then under ``torch.profiler``; returns the device idle share
    (1 - busy / plain wall)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import SampleRequest

    def mix(seed):
        futs = [front.submit(SampleRequest(
            env=n, overrides=SERVE_TIER_ENVS[n], num_samples=128,
            seed=seed + i)) for i, n in enumerate(("hypergrid", "amp"))]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix(50_000)
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mix(50_100)
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    idle = 1 - busy / wall_us
    emit("serve_tier_profile", mix="hypergrid 128 + amp 128 samples",
         wall_us=wall_us, device_busy_us=busy, device_idle_share=idle,
         device_top=[{"name": k[:70], "device_us": t, "calls": c}
                     for k, t, c in rows[:8]])
    return idle


def serve_tier_faults(device) -> dict:
    """The fault paths on bitseq at full width, each on a front of its
    own: a retried engine_step fault, a lane_state poison (quarantine,
    rebuild, replay), a restore fault over HTTP (a typed 500, then a
    success), a tight deadline (504 with progress; the engine then serves
    bitwise) and a queued one (408).  Every answer is held bitwise."""
    from repro_torch.serve import (DeadlineExceeded, FaultPlan, FaultSpec,
                                   QueueTimeout, SampleRequest, Scheduler,
                                   ServeFront)

    env = {"env": "bitseq", "overrides": SERVE_TIER_ENVS["bitseq"]}
    out = {}

    def front_with(plan=None):
        sched = Scheduler(num_lanes=SERVE_TIER_LANES, device=device,
                          fault_plan=plan, retry_backoff_s=0.001)
        return sched, ServeFront(sched, checkpoint_poll_s=None), \
            _Oracle(sched)

    def held(front, oracle, doc, what):
        res = front.request(SampleRequest(**doc))
        return oracle.check(doc, res.to_dict(), what)

    sched, front, oracle = front_with()
    held(front, oracle, dict(env, num_samples=8, seed=1), "fault warm-up")
    eng = next(iter(sched._engines.values()))
    eng._faults = FaultPlan.single("engine_step", at=(1,))
    held(front, oracle, dict(env, num_samples=32, seed=2), "retried step")
    if eng.counters["step_retries"] != 1 or eng.counters["step_failures"]:
        raise AssertionError(f"retry: {eng.counters}")
    out["retry"] = {"step_retries": eng.counters["step_retries"]}
    front.shutdown(drain=True, timeout=120)

    sched, front, oracle = front_with(FaultPlan.single("lane_state",
                                                       at=(2,)))
    held(front, oracle, dict(env, num_samples=64, seed=3, reward_beta=2.0),
         "poisoned, then replayed")
    c = front.stats()["counters"]
    if c.get("evictions", 0) < 1 or c.get("replays", 0) < 1:
        raise AssertionError(f"quarantine: {c}")
    out["quarantine"] = {k: c[k] for k in ("evictions", "replays")}
    front.shutdown(drain=True, timeout=120)

    sched, front, oracle = front_with(FaultPlan.single("restore", at=(0,)))
    server, sthread, port = _serving(front)
    doc = dict(env, num_samples=8, seed=4)
    s1, _, b1 = _http(port, "POST", "/sample", doc)
    s2, _, b2 = _http(port, "POST", "/sample", doc)
    if s1 != 500 or b1.get("kind") != "engine_failure" or s2 != 200:
        raise AssertionError(f"restore fault: {s1} {b1} then {s2}")
    oracle.check(doc, b2, "after the restore fault")
    out["restore"] = {"first": s1, "kind": b1["kind"], "then": s2}
    _stop_serving(server, sthread)
    front.shutdown(drain=True, timeout=120)

    plan = FaultPlan([FaultSpec("latency", rate=1.0, latency_s=0.05)],
                     seed=7)
    sched, front, oracle = front_with(plan)
    held(front, oracle, dict(env, num_samples=8, seed=5), "latency warm-up")
    try:
        front.request(SampleRequest(**dict(env, num_samples=256, seed=6)),
                      deadline_s=0.3)
        raise AssertionError("the tight deadline did not expire")
    except DeadlineExceeded as e:
        if e.code != 504 or not 0 <= e.extra["collected"] < 256:
            raise AssertionError(f"504: {e.extra}")
        out["deadline_504"] = dict(e.extra)
    held(front, oracle, dict(env, num_samples=32, seed=7), "after the 504")
    try:
        front.request(SampleRequest(**dict(env, num_samples=1, seed=8)),
                      deadline_s=1e-6)
        raise AssertionError("the queued deadline did not expire")
    except QueueTimeout as e:
        out["queue_408"] = e.code
    front.shutdown(drain=True, timeout=120)
    emit("serve_tier_faults", **out)
    return out


def serve_tier_autosize(device) -> dict:
    """A front that autosizes bitseq's pool between power-of-two buckets
    and prewarms each when the engine is built (one block per bucket on
    the card); its answers held bitwise."""
    from repro_torch.serve import SampleRequest, Scheduler, ServeFront
    lo, hi = SERVE_TIER_BUCKETS
    sched = Scheduler(num_lanes=lo, device=device)
    front = ServeFront(sched, checkpoint_poll_s=None, autosize=True,
                       min_lanes=lo, max_lanes=hi, prewarm_lanes=True)
    oracle = _Oracle(sched)
    docs = [{"env": "bitseq", "overrides": SERVE_TIER_ENVS["bitseq"],
             "num_samples": 32, "seed": 60_000 + i} for i in range(4)]
    futs = [front.submit(SampleRequest(**d)) for d in docs]
    for d, f in zip(docs, futs):
        oracle.check(d, f.result(timeout=600).to_dict(), "autosized")
    runner = next(iter(front._runners.values()))
    out = {"buckets": front.autosize_buckets(),
           "lanes_now": runner.engine.num_lanes,
           "resizes": runner.engine.counters["resizes"]}
    front.shutdown(drain=True, timeout=120)
    emit("serve_tier_autosize", **out)
    return out


# -- phase 5: bitseq_tb training --------------------------------------------------

def train_phase(device) -> dict:
    """``bitseq_tb`` at full width for TRAIN_ITERS iterations through the
    user's entry point, with every kernel's launches counted."""
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    # evals off: run_recipe evaluates at iteration 0, which would count
    # the evals' launches and time here (seqs_evals times them)
    out = run_recipe("bitseq_tb", iterations=TRAIN_ITERS, seed=0,
                     device=device, eval_every=0, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eager = read_launches()
    captured = out["loop"].captured
    launches = run_launches(eager, captured)
    hist = out["history"]
    want = {k: n * TRAIN_ITERS for k, n in TRAIN_LAUNCHES_PER_ITER.items()}
    # iteration 0 eagerly, the rest replays of its capture
    if launches != want or eager != TRAIN_LAUNCHES_PER_ITER \
            or captured.launches != TRAIN_LAUNCHES_PER_ITER \
            or captured.replays != TRAIN_ITERS - 1:
        raise AssertionError(f"training launched {launches} (eager "
                             f"{eager}, {captured.replays} replays of "
                             f"{captured.launches}), expected {want}")
    if len(hist) != TRAIN_ITERS or not all(
            math.isfinite(r[k]) for r in hist
            for k in ("loss", "log_z", "mean_log_reward")):
        raise AssertionError(f"training rows not finite: {hist[-3:]}")

    steady = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    first, last = hist[0], hist[-1]
    emit("train", nvidia_smi=smi, recipe="bitseq_tb",
         env="bitseq n=120 k=8 (L=15, A=3840, A_b=15)",
         policy="decode arch, 3 layers, dim 64, 8 heads, F 256",
         num_envs=16, iterations=TRAIN_ITERS, wall_s=wall,
         iterations_per_s=TRAIN_ITERS / wall,
         steady_iterations_per_s=steady,
         samples_per_s=16 * TRAIN_ITERS / wall,
         steady_samples_per_s=16 * steady,
         first={k: first[k] for k in ("it", "loss", "log_z",
                                      "mean_log_reward")},
         last={k: last[k] for k in ("it", "loss", "log_z",
                                    "mean_log_reward")},
         launches=launches, graph_launches=captured.launches,
         replays=captured.replays,
         capture_seconds=captured.capture_seconds,
         launches_per_iteration={k: v / TRAIN_ITERS
                                 for k, v in launches.items()})
    return launches


def _to_cpu(batch):
    import dataclasses
    return type(batch)(**{f.name: getattr(batch, f.name).cpu()
                          for f in dataclasses.fields(batch)})


def _rows_off_a_tie(differ, order, score) -> tuple:
    """``(near ties, mismatches)`` among the rows where ``differ`` (T, B)
    holds: each such row's first difference in sampling ``order`` (time
    indices) is a near tie when the CPU's top two scores there,
    ``score(t, b)``, lie within TIE_GAP."""
    ties = mismatched = 0
    for b in differ.any(0).nonzero()[:, 0].tolist():
        t = next(t for t in order if differ[t, b])
        top2 = torch.topk(score(t, b), 2).values
        if float(top2[0] - top2[1]) < TIE_GAP:
            ties += 1
        else:
            mismatched += 1
    return ties, mismatched


def grad_errors(grads_g: dict, grads_c: dict, grad_atol: float) -> tuple:
    """``(errors, waived)``: each leaf's largest difference between the
    card's and the CPU's gradient over the CPU gradient's largest entry; a
    leaf whose CPU gradient is at most ``grad_atol`` everywhere is held to
    ``grad_atol`` absolute instead (error 0 or inf) and named in
    ``waived``."""
    errors, waived = {}, []
    for k, gc in grads_c.items():
        scale = float(gc.abs().max())
        diff = float((grads_g[k].cpu() - gc).abs().max())
        if scale <= grad_atol:
            waived.append(k)
            errors[k] = 0.0 if diff <= grad_atol else math.inf
        else:
            errors[k] = diff / scale
    return errors, waived


def hold_iteration(phase: str, recipe_name: str, device, env=None,
                   grad_atol: float = 0.0, sampler=None,
                   sampler_kwargs=None, warm: int = 0):
    """One iteration of a recipe, at its own batch, on the card (kernels)
    and on the host's CPU (plain versions) from the same parameters and
    noise.  Actions: the
    card's rollout against the CPU's, except a row whose first difference
    sits at a step where the top two scores lie within TIE_GAP (counted).
    Loss and gradients: both devices teacher-force the card's batch, so a
    tie cannot move them; loss to 1e-5 relative, each gradient to 1e-4 of
    its own tensor's largest entry.  A leaf whose CPU gradient is at most
    ``grad_atol`` everywhere (0 unless given: the graph recipes take 1e-5,
    the CPU tests' absolute bound, for a bias whose gradient is 0 up to
    rounding) is held to ``grad_atol`` absolute instead, and named in
    ``grad_waived``.  With a replay ``sampler`` (a registry name, built
    with ``sampler_kwargs``), ``warm`` iterations first fill both buffers
    (each device on its own batches, loss and update skipped: the
    parameters stay equal); then the held iteration's replayed rows, drawn
    from buffers that hold the same terminals when every fresh row of the
    warm iterations agreed, must equal the CPU's (no near-tie waiver
    there: the uniform P_B's draws do not depend on the policy).  Returns
    the card's policy, loop and state."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop, make_sampler
    from repro_torch.core.trainer import current_eps
    from repro_torch.core.types import (hash_step_noise, masked_logprobs,
                                        train_seed)

    recipe = recipes.get_train(recipe_name)
    cpu = torch.device("cpu")
    env = recipe.make_env(**(env or {}))
    cfg = recipe.make_config(env, recipe.num_envs, recipe.iterations)
    pol_g = recipe.make_policy(env, seed=1, device=device,
                               requires_grad=True)
    pol_c = recipe.make_policy(env, seed=1, device=cpu, requires_grad=True)
    pol_c.load_params({k: v.detach().cpu()
                       for k, v in pol_g.params.flat().items()})
    loops = [TrainLoop(env, env.init(d), pol, cfg, sampler=make_sampler(
        sampler or "on_policy", **(sampler_kwargs or {})))
        for d, pol in ((device, pol_g), (cpu, pol_c))]
    loop_g, loop_c = loops
    st_g, st_c = loop_g.init(seed=5), loop_c.init(seed=5)
    warm_differ = 0
    for _ in range(warm):
        w_g, w_c = loop_g.sample(st_g), loop_c.sample(st_c)
        warm_differ += int((w_g.actions.cpu() != w_c.actions)[
            :, :cfg.num_envs].any(0).sum())
        st_g.counter.add_(1)
        st_c.counter.add_(1)
    step0 = warm
    batch_g = loop_g.sample(st_g)
    batch_c = loop_c.sample(st_c)
    a_g, a_c = batch_g.actions.cpu(), batch_c.actions
    T, B = a_c.shape[0], cfg.num_envs
    differ = (a_g != a_c)
    replayed = differ[:, B:].any(0)
    differ = differ[:, :B]
    if differ.any():
        with torch.no_grad():
            obs = batch_c.obs[:, :B]
            logits = pol_c.apply(obs.reshape(
                ((T + 1) * B,) + obs.shape[2:]))["logits"].reshape(
                T + 1, B, -1)

    def score(t, b):
        noise = hash_step_noise(
            torch.tensor([train_seed(5, step0)]), torch.tensor([b]),
            torch.tensor([t]), env.action_dim)
        mask = batch_c.fwd_mask[t, b] | batch_c.done[t, b]
        if float(noise.explore_u[0]) < current_eps(cfg, step0):
            return torch.where(mask, 0.0, float("-inf")) + noise.gumbel_u[0]
        return masked_logprobs(logits[t, b], mask) + noise.gumbel[0]

    ties, mismatched = _rows_off_a_tie(differ, range(T), score)
    replayed_mismatched = (int(replayed.sum())
                           if not (ties or warm_differ) else 0)
    loss_g = float(loop_g.loss_and_grads(batch_g))
    loss_c = float(loop_c.loss_and_grads(_to_cpu(batch_g)))
    grads_c = {k: p.grad for k, p in pol_c.params.flat().items()}
    grad_err, waived = grad_errors(
        {k: p.grad for k, p in pol_g.params.flat().items()}, grads_c,
        grad_atol)
    worst = max(grad_err, key=grad_err.get)
    rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
    extra = {} if sampler is None else dict(
        sampler=sampler, options=sampler_kwargs or {},
        batch_rows=a_c.shape[1], warm_iterations=warm,
        warm_fresh_rows_differing=warm_differ,
        buffer_size=int(st_g.sampler.size),
        replayed_rows_differing=int(replayed.sum()),
        replayed_mismatched_rows=replayed_mismatched)
    emit(phase, recipe=recipe_name, steps=T, envs=B, **extra,
         actions_equal=int((~differ).sum()),
         rows_differing=int(differ.any(0).sum()), near_tie_rows=ties,
         mismatched_rows=mismatched, loss_cuda=loss_g, loss_cpu=loss_c,
         loss_rel_err=rel, grad_max_err_over_scale=grad_err[worst],
         grad_worst_param=worst, grad_atol=grad_atol, grad_waived=waived)
    if mismatched or replayed_mismatched or not rel <= 1e-5 \
            or not grad_err[worst] <= 1e-4:
        raise AssertionError(
            f"{phase}: {mismatched} rows differ off a tie "
            f"({replayed_mismatched} replayed rows), loss rel "
            f"error {rel}, gradient error {grad_err[worst]} ({worst})")
    return pol_g, loop_g, st_g


def train_hold_phase(device):
    """One bitseq_tb iteration on the card against the CPU's.  No optimizer
    step has run yet, so the fused step's weight cache is filled here, for
    ``trained_fused_step`` to check after the steps of train_profile."""
    pol_g, loop_g, st_g = hold_iteration("train_hold", "bitseq_tb", device,
                                         env={"seed": 0})
    before = {k: v.clone() for k, v in
              pol_g.kernel_weights()["stacked"].items()}
    return loop_g, st_g, before


def train_profile(loop, state, phase: str = "train_profile") -> None:
    """Where one training iteration's time goes (:func:`profile_step`)."""
    profile_step(phase, lambda: loop.step(state))


def profile_step(phase: str, step, **fields) -> None:
    """Emit :func:`profiled_step`'s fields of one call of ``step`` as the
    line of ``phase``."""
    emit(phase, **fields, **profiled_step(step))


def profiled_step(step) -> dict:
    """Where one call of ``step`` (a training iteration, a decode step)
    spends its time: timed plain, then under ``torch.profiler`` (device
    time by kernel; the device's idle share of the plain call's wall time),
    then under ``cProfile`` (host functions by own time; read shares, not
    times)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def one():
        step()
        torch.cuda.synchronize()

    one()                                   # warm: allocator, cuBLAS
    t0 = time.perf_counter()
    one()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    host = cProfile.Profile()
    host.runcall(one)
    stats = pstats.Stats(host).stats
    total = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return dict(iterations=1, wall_us=wall_us, device_busy_us=busy,
                device_idle_share=1 - busy / wall_us,
                device_kernels=sum(r[2] for r in rows),
                device_top=[{"name": k[:70], "device_us": t, "calls": c}
                            for k, t, c in rows[:10]],
                host_top=[{"function": f"{Path(f).name}:{ln}:{fn}",
                           "own_share": v[2] / total, "calls": v[1]}
                          for (f, ln, fn), v in top])


# -- phase 6: hypergrid training -----------------------------------------------

def hypergrid_train_phase(device) -> dict:
    """``hypergrid_subtb`` at full size (4x8^4, 16 envs, MLP 2x256) for
    HYPERGRID_ITERS iterations through ``run_recipe``, with the recipe's
    evals at iterations 0 and 49.  Launches are read at every iteration:
    one SubTB forward and one backward each, two traj_logprob forwards
    (the log Z bounds) at the eval iterations only, no other kernel."""
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    reset_launches()
    last = read_launches()
    per_it = []

    def log(line):
        if line.startswith("it "):
            now = read_launches()
            per_it.append({k: now[k] - last[k] for k in now})
            last.update(now)

    t0 = time.perf_counter()
    out = run_recipe("hypergrid_subtb", iterations=HYPERGRID_ITERS, seed=0,
                     device=device, eval_every=HYPERGRID_EVAL_EVERY,
                     log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captured = out["loop"].captured
    launches = run_launches(read_launches(), captured)
    # iterations 1.. replay the capture of iteration 1 (0 runs eagerly)
    per_it = [got if it == 0 else {k: v + captured.launches[k]
                                   for k, v in got.items()}
              for it, got in enumerate(per_it)]
    hist, rows = out["history"], out["rows"]
    eval_its = list(range(0, HYPERGRID_ITERS, HYPERGRID_EVAL_EVERY))
    for it, got in enumerate(per_it):
        want = dict(HYPERGRID_LAUNCHES_PER_ITER)
        if it in eval_its:
            want.update(HYPERGRID_EVAL_LAUNCHES)
        if got != want:
            raise AssertionError(f"hypergrid iteration {it} launched {got}, "
                                 f"expected {want}")
    if len(per_it) != HYPERGRID_ITERS or [r["step"] for r in rows] \
            != eval_its:
        raise AssertionError(f"hypergrid: {len(per_it)} iterations, eval "
                             f"rows at {[r['step'] for r in rows]}")
    if not all(math.isfinite(r[k]) for r in hist
               for k in ("loss", "log_z", "mean_log_reward")) or not all(
            math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"hypergrid rows not finite: {hist[-2:]}, "
                             f"{rows}")
    # iterations 1..48 run no eval
    steady = (HYPERGRID_ITERS - 2) / (hist[-2]["wall_s"] - hist[0]["wall_s"])
    last_it_s = hist[-1]["wall_s"] - hist[-2]["wall_s"]
    emit("hypergrid_train", nvidia_smi=smi, recipe="hypergrid_subtb",
         env="hypergrid 4x8^4 (4,096 states, T+1 = 30, A = 5)",
         policy="MLP 2x256, A logits + flow head", num_envs=16,
         iterations=HYPERGRID_ITERS, wall_s=wall,
         iterations_per_s=HYPERGRID_ITERS / wall,
         steady_iterations_per_s=steady,
         steady_samples_per_s=16 * steady,
         eval_seconds=last_it_s - 1 / steady,
         first={k: hist[0][k] for k in ("loss", "log_z", "mean_log_reward")},
         last={k: hist[-1][k] for k in ("loss", "log_z",
                                        "mean_log_reward")},
         evals=rows, launches=launches, graph_launches=captured.launches,
         replays=captured.replays,
         capture_seconds=captured.capture_seconds,
         launches_per_iteration={k: v / HYPERGRID_ITERS
                                 for k, v in launches.items()})
    return launches


def hypergrid_converge(device) -> None:
    """``tests/test_training.py:19-43`` on the card: SubTB on the 2x8 grid
    with an MLP (64, 64), epsilon 0.05 annealed over 1,250 iterations, 2,500
    iterations; the empirical TV of 4,000 samples must be under 0.12.  The
    exact-DP TV stands beside it.  Then one exact DP on the paper's 20^4
    grid (160,000 states) on the card, held to the CPU's."""
    from repro_torch.algo import TrainLoop
    from repro_torch.core.policies import MLPPolicy
    from repro_torch.core.rollout import forward_rollout
    from repro_torch.core.trainer import GFNConfig
    from repro_torch.evals import ExactDistributionEval, make_hypergrid_dp
    from repro_torch.metrics.distributions import (empirical_distribution,
                                                   total_variation)
    from repro_torch.recipes.hypergrid import (hypergrid_env,
                                               hypergrid_policy,
                                               terminal_index_fn)

    smi = nvidia_smi()
    env = hypergrid_env(dim=2, side=8)
    params = env.init(device)
    policy = MLPPolicy(env.obs_dim, env.action_dim, env.backward_action_dim,
                       hidden=(64, 64), seed=1, device=device,
                       requires_grad=True)
    cfg = GFNConfig(objective="subtb", num_envs=16, lr=1e-3, log_z_lr=1e-1,
                    stop_action=env.dim, exploration_eps=0.05,
                    exploration_anneal_steps=CONVERGE_ITERS // 2)
    reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(env, params, policy, cfg)
    _, hist = loop.run(
        1, CONVERGE_ITERS, callback=lambda it, st, m, b: float(m["loss"])
        if it % 500 == 0 or it == CONVERGE_ITERS - 1 else None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = run_launches(read_launches(), loop.captured)
    true = env.true_distribution(params)
    batch = forward_rollout(2, env, params, policy, 4000)
    emp = empirical_distribution(terminal_index_fn(env)(batch),
                                 env.num_terminal_states)
    tv = float(total_variation(emp, true))
    exact = {k: float(v) for k, v in
             ExactDistributionEval(env, params, policy)(0).items()}

    env20 = hypergrid_env(dim=4, side=20)
    pol_g = hypergrid_policy(env20, seed=3, device=device)
    pol_c = hypergrid_policy(env20, seed=3, device=torch.device("cpu"))
    pol_c.load_params({k: v.detach().cpu()
                       for k, v in pol_g.params.flat().items()})
    t0 = time.perf_counter()
    dp_g = make_hypergrid_dp(env20, env20.init(device), pol_g)()
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    dp_c = make_hypergrid_dp(env20, env20.init("cpu"), pol_c)()
    dp_err = float((dp_g.cpu() - dp_c).abs().max())
    dp_tv = float(total_variation(dp_g.cpu(), dp_c))
    emit("hypergrid_converge", nvidia_smi=smi, objective="subtb",
         env="hypergrid 2x8 (64 states)", policy="MLP 64x64",
         iterations=CONVERGE_ITERS, train_seconds=train_s,
         iterations_per_s=CONVERGE_ITERS / train_s,
         losses=[h for h in hist if h is not None],
         sample_tv_4000=tv, bar=CONVERGE_TV, exact_tv=exact["exact_tv"],
         exact_jsd=exact["exact_jsd"],
         launches={k: v for k, v in launches.items() if v},
         replays=loop.captured.replays,
         dp_20x4={"states": env20.num_terminal_states,
                  "cuda_seconds": dp_s, "max_abs_err_vs_cpu": dp_err,
                  "tv_vs_cpu": dp_tv, "sum": float(dp_g.sum())})
    want = {"subtb_loss_fwd": CONVERGE_ITERS,
            "subtb_loss_bwd": CONVERGE_ITERS}
    if not tv < CONVERGE_TV or {k: v for k, v in launches.items() if v} \
            != want or not dp_err <= 1e-6 or not dp_tv <= 1e-5:
        raise AssertionError(
            f"hypergrid_converge: TV {tv} (bar {CONVERGE_TV}), launches "
            f"{launches}, 20^4 DP error {dp_err}, TV to the CPU {dp_tv}")


def trained_fused_step(loop, state, before: dict, device,
                       phase: str = "trained_fused_step", **fields) -> None:
    """After the optimizer steps of train_hold and train_profile (torch's
    Adam on the card), the fused step's weight cache, filled before them,
    must hold the live weights, and the fused step (the serving kernel)
    must equal the plain ``apply_cached`` + ``sample_masked`` chain on the
    same noise, one step from the initial state."""
    from repro_torch import recipes
    from repro_torch.core.types import hash_gumbel, sample_masked
    from repro_torch.nn.transformer import decoder_stacked_weights

    policy, optimizer = loop.policy, state.optimizer
    live = decoder_stacked_weights(policy.params["decoder"])
    cached = policy.kernel_weights()["stacked"]
    moved = all(not torch.equal(before[k], live[k]) for k in
                ("q_w", "ff1_w", "ff2_w"))
    fresh = all(torch.equal(cached[k], live[k]) for k in live)
    env = recipes.get_train("bitseq_tb").make_env(seed=0)
    params = env.init(device)
    B = 16
    _, state = env.reset(B, params)
    prev = torch.zeros(B, dtype=torch.int64, device=device)
    token, pos, length = env.observe_last(state, params, prev)
    ids = torch.arange(B, dtype=torch.int64, device=device)
    gumbel = hash_gumbel(torch.full_like(ids, 99), ids, torch.zeros_like(ids),
                         env.action_dim)
    mask = env.forward_mask(state, params)
    with torch.no_grad():
        out_p, _ = policy.apply_cached(policy.cache_init(B), token, pos,
                                       length, step=0)
        a_p, lp_p = sample_masked(out_p["logits"], mask, gumbel)
        a_f, lp_f, _, _ = policy.sample_cached(policy.cache_init(B), token,
                                               pos, length, gumbel, mask,
                                               step=0)
    torch.cuda.synchronize()
    same = bool(torch.equal(a_f.long(), a_p))
    err = float((lp_f - lp_p).abs().max())
    emit(phase, optimizer=type(optimizer).__name__,
         foreach=optimizer.defaults.get("foreach"),
         fused=optimizer.defaults.get("fused"),
         capturable=optimizer.defaults.get("capturable"),
         weights_moved=moved, cache_equals_live_weights=fresh,
         actions_equal=same, log_pf_err=err, **fields)
    if not (moved and fresh and same and err <= TOL):
        raise AssertionError(
            f"{phase}: weights moved {moved}, cache equals live "
            f"weights {fresh}, actions equal {same}, log_pf error {err}")


def replayed_fused_step(loop, state, device) -> None:
    """The fused step after replays of a captured iteration.  A replay's
    Adam step writes the parameters without moving their version
    counters, so a bare replay leaves the fused step's weight cache
    (filled just before it) stale: shown here, and required, as the fault
    the loop's replay repairs.  Then two replays through the loop, which
    drop the cache after each, and ``trained_fused_step``'s checks."""
    from repro_torch.nn.transformer import decoder_stacked_weights

    policy = loop.policy
    captured = loop.capture(state)
    before = {k: v.clone() for k, v in
              policy.kernel_weights()["stacked"].items()}
    captured.graph.replay()                 # the loop's replay skipped
    torch.cuda.synchronize()
    live = decoder_stacked_weights(policy.params["decoder"])
    cached = policy.kernel_weights()["stacked"]
    # the stacked matrices are copies (ln_f and q0 alias the parameters)
    stale = all(torch.equal(cached[k], before[k])
                and not torch.equal(cached[k], live[k])
                for k in ("q_w", "ff1_w", "ff2_w"))
    if not stale:
        raise AssertionError("a bare replay did not leave the fused "
                             "step's weight cache stale; the check that "
                             "the loop repairs it cannot fail")
    captured()
    captured()
    trained_fused_step(loop, state, before, device,
                       phase="replayed_fused_step",
                       stale_after_bare_replay=stale,
                       replays=captured.replays + 1)


# -- phase 7: the sequence-design recipes -------------------------------------

def counted_run(name: str, iters: int, per_iter: dict, device,
                **run_kwargs):
    """``run_recipe(name)`` at full width for ``iters`` iterations, evals
    off, captured as train: every iteration's launches read (the eager
    warm-up's from the wrappers, a replay's from the capture) and held to
    ``per_iter`` exactly (a kernel it leaves out: 0), every row finite.
    ``run_kwargs`` go to ``run_recipe`` (a sampler and its options).
    Returns ``(fields of the phase's line, the run's launches)``."""
    from repro_torch.run import run_recipe

    reset_launches()
    last = read_launches()
    per_it = []

    def log(line):
        if line.startswith("it "):
            now = read_launches()
            per_it.append({k: now[k] - last[k] for k in now})
            last.update(now)

    t0 = time.perf_counter()
    out = run_recipe(name, iterations=iters, seed=0, device=device,
                     eval_every=0, log=log, **run_kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captured = out["loop"].captured
    launches = run_launches(read_launches(), captured)
    per_it = [got if it == 0 else {k: v + captured.launches[k]
                                   for k, v in got.items()}
              for it, got in enumerate(per_it)]
    want = _only(launches, **per_iter)
    bad = [(it, got) for it, got in enumerate(per_it) if got != want]
    if len(per_it) != iters or bad:
        raise AssertionError(f"{name}: {len(per_it)} iterations; "
                             f"iterations launching other than {want}:"
                             f" {bad[:3]}")
    hist = out["history"]
    if not all(math.isfinite(r[k]) for r in hist
               for k in ("loss", "log_z", "mean_log_reward")):
        raise AssertionError(f"{name}: rows not finite: {hist[-2:]}")
    steady = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    B = out["loop"].num_envs
    return dict(
        num_envs=B, iterations=iters, wall_s=wall,
        iterations_per_s=iters / wall, steady_iterations_per_s=steady,
        samples_per_s=B * iters / wall, steady_samples_per_s=B * steady,
        first={k: hist[0][k] for k in ("loss", "log_z", "mean_log_reward")},
        last={k: hist[-1][k] for k in ("loss", "log_z", "mean_log_reward")},
        launches=launches, launches_per_iteration=want,
        graph_launches=captured.launches, replays=captured.replays,
        capture_seconds=captured.capture_seconds), launches


def seqs_train_phase(device) -> dict:
    """``tfbind8_tb``, ``qm9_tb`` and ``amp_tb`` at full width through
    ``run_recipe`` (evals off; seqs_evals times them), launches read at
    every iteration and held to SEQ_LAUNCHES_PER_ITER exactly
    (:func:`counted_run`).  Returns the launches of all three runs."""
    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, iters in SEQ_ITERS.items():
        fields, launches = counted_run(name, iters,
                                       SEQ_LAUNCHES_PER_ITER[name], device)
        emit("seqs_train", nvidia_smi=smi, recipe=name,
             env=SEQ_RECIPES[name], policy=SEQ_POLICIES[name], **fields)
        for k, v in launches.items():
            total[k] += v
    return total


def seqs_evals_phase(device) -> dict:
    """Each sequence recipe's eval suite once at full width (bitseq_tb's
    too: n=120, k=8), on a policy from a seeded generator, the sampling
    evals over 2,000 samples; and AMP's top-100 reward and diversity over
    256 samples.  Every metric finite, the correlations in [-1, 1].
    Returns the launches of the four suites (their non-exploring rollouts
    take the fused step; the log Z bounds' losses traj_logprob)."""
    from repro_torch import recipes
    from repro_torch.evals import EvalSuite
    from repro_torch.recipes.seqs import amp_eval

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name in ("bitseq_tb", "tfbind8_tb", "qm9_tb", "amp_tb"):
        rec = recipes.get_train(name)
        env = rec.make_env()
        params = env.init(device)
        policy = rec.make_policy(env, seed=0, device=device)
        t0 = time.perf_counter()
        suite = EvalSuite(rec.make_evals(env, params, policy, seed=0,
                                         eval_batch=2000), every=1, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        suite.run(0)                 # warm: cuBLAS, the allocator
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        row = suite.run(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        extra = {}
        if name == "amp_tb":
            t1 = time.perf_counter()
            extra = amp_eval(env, params, policy)(7)
            torch.cuda.synchronize()
            extra["top100_seconds"] = time.perf_counter() - t1
        emit("seqs_evals", nvidia_smi=smi, recipe=name,
             evaluators=[type(e).__name__ for e in suite.evaluators],
             metrics=row, seconds=seconds, build_seconds=build_s,
             launches=launches, **extra)
        values = [v for k, v in row.items() if k != "step"] + [
            v for k, v in extra.items() if k != "top100_seconds"]
        corr = [row[k] for k in ("pearson", "spearman")]
        if not all(math.isfinite(v) for v in values) or not all(
                -1 <= c <= 1 for c in corr):
            raise AssertionError(f"{name} evals: {row} {extra}")
        for k, v in launches.items():
            total[k] += v
    return total


def seqs_profile(device) -> None:
    """One iteration of each sequence recipe, card against CPU
    (``hold_iteration``, phase seqs_hold), then that iteration's device
    idle share and tops on the card (phase seqs_profile); for AMP, the
    lengths decode_attention saw (seqs_kv_valid)."""
    for name in SEQ_ITERS:
        _, loop, state = hold_iteration("seqs_hold", name, device)
        if name == "amp_tb":
            # before any optimizer step: log Z starts at 150, far above
            # log R, and a few TB steps teach the policy not to stop
            amp_kv_valid(loop, state)
        profile_step("seqs_profile", lambda: loop.step(state), recipe=name)


def amp_kv_valid(loop, state) -> None:
    """An AMP rollout's cached queries on the card: at step t every layer's
    decode_attention must attend ``kv_valid = length_t + 1`` slots (the
    row's symbols so far and BOS), read back from the batch's
    observations, and the lengths must be ragged (rows stop at different
    steps)."""
    from repro_torch.nn import transformer

    seen = []
    real = transformer.decode_attention

    def spy(q, k, v, kv_valid):
        seen.append(kv_valid.clone())
        return real(q, k, v, kv_valid)

    transformer.decode_attention = spy
    try:
        batch = loop.sample(state)
    finally:
        transformer.decode_attention = real
    T = batch.actions.shape[0]
    layers = len(seen) // T
    want = (batch.obs[:-1] != loop.env.pad).sum(-1).to(torch.int32) + 1
    got = torch.stack(seen).reshape(T, layers, -1)
    same = bool(torch.equal(got, want[:, None, :].expand_as(got)))
    ragged = int(sum(len(set(row.tolist())) > 1 for row in want))
    emit("seqs_kv_valid", recipe="amp_tb", steps=T, layers=layers,
         launches=len(seen), kv_valid_equal_length_plus_1=same,
         ragged_steps=ragged, max_kv_valid=int(want.max()),
         stop_steps=sorted(set(batch.valid.sum(0).tolist())))
    if not same or layers != 3 or not ragged:
        raise AssertionError(f"AMP's decode_attention lengths: equal "
                             f"{same}, layers {layers}, ragged steps "
                             f"{ragged}")


# -- phase 8: the graph environments: dag_mdb and phylo_fldb -------------------

def graph_env_train_phase(device) -> dict:
    """``dag_mdb`` and ``phylo_fldb`` at full size through ``run_recipe``
    (:func:`counted_run`: captured, evals off), phases dag_train and
    phylo_train.  Returns the launches of both runs."""
    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, iters in GRAPH_ENV_ITERS.items():
        fields, launches = counted_run(
            name, iters, GRAPH_ENV_LAUNCHES_PER_ITER[name], device)
        emit(f"{GRAPH_ENV_PHASES[name]}_train", nvidia_smi=smi, recipe=name,
             env=GRAPH_ENV_RECIPES[name], policy=GRAPH_ENV_POLICIES[name],
             **fields)
        for k, v in launches.items():
            total[k] += v
    return total


def graph_env_profile(device) -> None:
    """One iteration of each graph recipe at its own batch (128 / 32
    envs), card against CPU (``hold_iteration``: dag_hold, phylo_hold),
    then that iteration's idle share and tops on the card (dag_profile,
    phylo_profile)."""
    for name, phase in GRAPH_ENV_PHASES.items():
        _, loop, state = hold_iteration(f"{phase}_hold", name, device,
                                        grad_atol=1e-5)
        profile_step(f"{phase}_profile", lambda: loop.step(state),
                     recipe=name)


def graph_evals_phase(device) -> dict:
    """Each graph recipe's evaluators once at full size, each timed alone
    after a warm-up call: dag_mdb's reward correlation (128 probe DAGs, 8
    MC samples), log Z bounds (256 samples: traj_logprob at (256, 11, 26))
    and the JSD of DAG_JSD_SAMPLES samples against the exact posterior over
    the 29,281 DAGs on 5 nodes; phylo_fldb's correlation (64 probe trees,
    8 MC samples under the learned P_B).  Policies from a seeded
    generator.  Every metric finite, correlations in [-1, 1], the JSD in
    [0, log 2]; launches per evaluator exactly (DAG_EVAL_LAUNCHES).
    Returns the launches of both suites."""
    from repro_torch import recipes
    from repro_torch.core.types import eval_seed
    from repro_torch.recipes.dag import PosteriorJSDEval

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, phase in GRAPH_ENV_PHASES.items():
        rec = recipes.get_train(name)
        env = rec.make_env()
        params = env.init(device)
        policy = rec.make_policy(env, seed=0, device=device)
        t0 = time.perf_counter()
        evaluators = rec.make_evals(env, params, policy, seed=0,
                                    eval_batch=2000)
        if name == "dag_mdb":
            evaluators.append(PosteriorJSDEval(env, params, policy,
                                               num_samples=DAG_JSD_SAMPLES))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        metrics, seconds, launches = {}, {}, {}
        for i, ev in enumerate(evaluators):
            kind = type(ev).__name__
            ev(eval_seed(0, 0, i))            # warm: cuBLAS, the allocator
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = ev(eval_seed(0, 1, i))
            torch.cuda.synchronize()
            seconds[kind] = time.perf_counter() - t0
            launches[kind] = {k: v for k, v in read_launches().items() if v}
            metrics.update({k: float(v) for k, v in out.items()})
            for k, v in read_launches().items():
                total[k] += v
        emit(f"{phase}_evals", nvidia_smi=smi, recipe=name,
             evaluators=list(seconds), metrics=metrics, seconds=seconds,
             build_seconds=build_s, launches=launches)
        corr = [metrics[k] for k in ("pearson", "spearman")]
        want = {kind: (DAG_EVAL_LAUNCHES.get(kind, {})
                       if name == "dag_mdb" else {}) for kind in launches}
        if not all(math.isfinite(v) for v in metrics.values()) or not all(
                -1 <= c <= 1 for c in corr) or launches != want or not (
                0 <= metrics.get("jsd", 0) <= math.log(2)):
            raise AssertionError(f"{name} evals: {metrics}, launches "
                                 f"{launches} (expected {want})")
    return total


def dag_converge(device) -> None:
    """``tests/test_training.py:46-75`` on the card, through the captured
    run: MDB on d = 3 (BGe over 50 samples, data seed 1), the recipe's
    MLP 2x128 with a learned P_B, 64 envs, lr 1e-3, epsilon 0.1 annealed
    over 1,500 iterations, DAG_CONVERGE_ITERS iterations; the JSD of
    DAG_CONVERGE_SAMPLES samples against the exact posterior over the 25
    DAGs must be under DAG_CONVERGE_JSD.  No kernel launches (MDB's loss
    is the stop-action branch)."""
    from repro_torch.algo import TrainLoop
    from repro_torch.core.trainer import GFNConfig
    from repro_torch.recipes.dag import PosteriorJSDEval, dag_env, dag_policy

    smi = nvidia_smi()
    env = dag_env(d=3, num_samples=50, seed=1)
    params = env.init(device)
    policy = dag_policy(env, seed=0, device=device, requires_grad=True)
    cfg = GFNConfig(objective="mdb", num_envs=64, lr=1e-3,
                    stop_action=env.stop_action, exploration_eps=0.1,
                    exploration_anneal_steps=1500)
    reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(env, params, policy, cfg)
    _, hist = loop.run(
        0, DAG_CONVERGE_ITERS, callback=lambda it, st, m, b: float(
            m["loss"]) if it % 500 == 0 or it == DAG_CONVERGE_ITERS - 1
        else None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = run_launches(read_launches(), loop.captured)
    t0 = time.perf_counter()
    jsd = float(PosteriorJSDEval(env, params, policy,
                                 num_samples=DAG_CONVERGE_SAMPLES)(9)["jsd"])
    jsd_s = time.perf_counter() - t0
    emit("dag_converge", nvidia_smi=smi, objective="mdb",
         env="DAG d=3, BGe over 50 samples (25 DAGs)",
         policy="MLP 2x128, learned P_B", num_envs=64,
         iterations=DAG_CONVERGE_ITERS, train_seconds=train_s,
         iterations_per_s=DAG_CONVERGE_ITERS / train_s,
         losses=[h for h in hist if h is not None],
         jsd=jsd, samples=DAG_CONVERGE_SAMPLES, bar=DAG_CONVERGE_JSD,
         jsd_seconds=jsd_s, replays=loop.captured.replays,
         launches={k: v for k, v in launches.items() if v})
    if not jsd < DAG_CONVERGE_JSD or any(launches.values()):
        raise AssertionError(f"dag_converge: JSD {jsd} (bar "
                             f"{DAG_CONVERGE_JSD}), launches {launches}")


# -- phase 8b: EB-GFN on the Ising model -------------------------------------

def timed_ising_dataset(args) -> tuple:
    """``(generate_ising_dataset(*args), its seconds)``.  The heat-bath
    chains are Python on one host core (~25 s at ISING_DATASET), so
    ``main`` runs this in a spawned process beside the kernel checks."""
    from repro_torch.envs.ising import generate_ising_dataset
    t0 = time.perf_counter()
    data = generate_ising_dataset(*args)
    return data, time.perf_counter() - t0


@contextlib.contextmanager
def dataset_made_by(future):
    """For the block, the recipe's dataset at ISING_DATASET's arguments is
    the array ``future`` (:func:`timed_ising_dataset`'s) returns: the same
    function on the same arguments, run in another process; any other
    arguments generate as usual."""
    from repro_torch.recipes import ising
    real = ising.generate_ising_dataset

    def made(seed, n, sigma, num_samples):
        if (seed, n, sigma, num_samples) == ISING_DATASET:
            return future.result()[0]
        return real(seed, n, sigma, num_samples)

    ising.generate_ising_dataset = made
    try:
        yield
    finally:
        ising.generate_ising_dataset = real


def ising_train_phase(device, dataset) -> dict:
    """``ising_ebgfn`` at full size through ``run_recipe`` for ISING_ITERS
    iterations (iteration 0 eager, the rest replays of its capture), evals
    off: the warm-up's launches and one replay's, each held to
    ISING_LAUNCHES_PER_ITER exactly; then ISING_RATE_REPLAYS replays and
    ISING_EAGER_ITERS eager iterations timed (the data table wraps past
    the run's rows), one replay profiled (kernels, busy time, idle share,
    tops), and -log RMSE and the metrics after them, finite.  ``dataset``
    is the future of the recipe's dataset (:func:`timed_ising_dataset`),
    which the run takes (:func:`dataset_made_by`); its host seconds are
    reported.  Returns the run's launches."""
    from repro_torch.core.ebgfn import neg_log_rmse
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    reset_launches()
    want = _only(read_launches(), **ISING_LAUNCHES_PER_ITER)
    t0 = time.perf_counter()
    with dataset_made_by(dataset):
        out = run_recipe("ising_ebgfn", iterations=ISING_ITERS,
                         seed=ISING_DATASET[0], device=device, eval_every=0,
                         log=lambda line: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop, state = out["loop"], out["state"]
    captured = loop.captured
    warm = read_launches()
    launches = run_launches(warm, captured)
    if warm != want or captured.launches != want:
        raise AssertionError(f"ising_train: the warm-up launched {warm}, "
                             f"one replay {captured.launches}; each "
                             f"iteration should {want}")
    t0 = time.perf_counter()
    for _ in range(ISING_RATE_REPLAYS):
        metrics, _ = captured()
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ISING_EAGER_ITERS):
        loop.step(state)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    profile = profiled_step(captured)
    metrics, _ = captured()
    J_true = loop.env.init(device).reward_params["J"]
    last = {"gfn_loss": float(metrics["gfn_loss"]),
            "mh_accept": float(metrics["mh_accept"]),
            "neg_log_rmse": float(neg_log_rmse(state.J.detach(), J_true))}
    emit("ising_train", nvidia_smi=smi, recipe="ising_ebgfn", env=ISING_ENV,
         policy=ISING_POLICY, num_envs=loop.num_envs, iterations=ISING_ITERS,
         dataset_seconds=dataset.result()[1],
         dataset_made="in a spawned process beside the kernel checks",
         dataset_wait_s=out["dataset_seconds"], run_wall_s=wall,
         warmup_seconds=captured.warmup_seconds,
         capture_seconds=captured.capture_seconds,
         launches_per_iteration=want, warmup_launches=warm,
         graph_launches=captured.launches, replays=captured.replays,
         launches=launches, timed_replays=ISING_RATE_REPLAYS,
         captured_iterations_per_s=ISING_RATE_REPLAYS / graph_s,
         eager_iterations=ISING_EAGER_ITERS,
         eager_iterations_per_s=ISING_EAGER_ITERS / eager_s,
         speedup=(eager_s / ISING_EAGER_ITERS) / (graph_s
                                                  / ISING_RATE_REPLAYS),
         replay_profile=profile, last=last, iterations_done=state.step)
    if not all(math.isfinite(v) for v in last.values()) \
            or not 0 <= last["mh_accept"] <= 1:
        raise AssertionError(f"ising_train: metrics {last}")
    return launches


def ising_hold(device) -> None:
    """One ``ising_ebgfn`` iteration at full size on the card (kernels)
    against the host's CPU (plain versions), from the same policy (drawn
    from seed 1), J (ISING_HOLD_J_SCALE of a seeded symmetric draw), data
    rows and noise (loop seed 5).

    - The GFN update, the CPU's iteration from the same parameters: the
      mix coin bitwise; the forward and the collecting backward rollout's
      actions, card against CPU, a row whose first difference in its
      sampling order sits at a near tie counted apart (as
      ``hold_iteration`` does), any other difference a failure.  The CPU
      teacher-forces the card's mixed batch: the TB loss to 1e-4
      relative, each policy gradient to 1e-4 of its tensor's largest entry
      (a leaf whose CPU gradient is at most 1e-5, to 1e-5 absolute).
    - The MH test (``EBGFNLoop.mh_test``), rerun collecting on each device
      from the card's updated policy (Adam's first step sends a gradient
      entry near its epsilon anywhere in [-lr, lr], so the two devices'
      own updates part there): the card's rerun bitwise its iteration's;
      the negatives' and the MH rollout's actions as above; on the rows
      where both agree, log A to 1e-4 of its terms' magnitude (both
      energies, the MH rollout's log P_F and log P_B, the negatives'
      log P_F steps), the outcome equal where |log u - log A| > 1e-3.
    - The energy update: the CPU's ``cd_step`` from the same J and a fresh
      Adam on the card's data rows, negatives and outcome; J's gradient
      and J after to 1e-4 of their largest entries."""
    from repro_torch.algo.loop import loss_and_grads
    from repro_torch.core.objectives import evaluate_trajectory, tb_parts
    from repro_torch.core.types import masked_logprobs, train_seed
    from repro_torch.recipes.ising import ising_env, ising_loop, ising_policy

    cpu = torch.device("cpu")
    env = ising_env()
    T, A, Ab = env.max_steps, env.action_dim, env.backward_action_dim
    pol_g = ising_policy(env, seed=1, device=device, requires_grad=True)
    init = {k: v.detach().cpu().clone() for k, v in
            pol_g.params.flat().items()}
    pol_c, pol_init = (ising_policy(env, device=cpu, requires_grad=True)
                       for _ in range(2))
    pol_c.load_params(init)
    pol_init.load_params(init)
    loop_g = ising_loop(env, pol_g, seed=0, iterations=ISING_ITERS)
    loop_c = ising_loop(env, pol_c, seed=0, iterations=ISING_ITERS)
    B = loop_c.num_envs
    g = torch.Generator().manual_seed(7)
    J0 = torch.randn(env.D, env.D, generator=g)
    J0 = ISING_HOLD_J_SCALE * (J0 + J0.T)

    def state(loop):
        st = loop.init(seed=5)
        with torch.no_grad():
            st.J.copy_(J0)
        return st

    st_g, st_c, st_cd = state(loop_g), state(loop_c), state(loop_c)
    m_g, batch_g, tr_g = loop_g.iteration_trace(st_g)
    grads_g = {k: p.grad.cpu() for k, p in pol_g.params.flat().items()}
    batch_gc = _to_cpu(batch_g)
    # the CPU from the same parameters: TB on the card's batch, then its
    # own iteration
    loss_tf = float(loss_and_grads(pol_c.params, *tb_parts(
        evaluate_trajectory(pol_c, batch_gc), batch_gc,
        pol_c.params["log_z"])))
    grads_c = {k: p.grad.clone() for k, p in pol_c.params.flat().items()}
    m_c, _, tr_c = loop_c.iteration_trace(st_c)
    # the MH test from the card's updated policy, on both devices
    pol_c.load_params({k: v.detach().cpu() for k, v in
                       pol_g.params.flat().items()})
    seed = train_seed(5, 0)
    test_g = loop_g.mh_test(torch.tensor(seed, device=device), tr_g.reward,
                            tr_g.data, collect=True)
    test_c = loop_c.mh_test(torch.tensor(seed), tr_c.reward, tr_c.data,
                            collect=True)
    rerun_bitwise = all(torch.equal(getattr(test_g, f), getattr(tr_g.test, f))
                        for f in ("log_a", "accept")) \
        and torch.equal(test_g.neg.actions, tr_g.test.neg.actions)
    take_equal = torch.equal(tr_g.take_fwd.cpu(), tr_c.take_fwd)
    # the actions of the four rollouts, card against CPU
    seeds = torch.tensor([seed])
    noise = loop_c.noise

    def row_noise(src, b, t, n):
        return src(seeds, torch.tensor([b]), torch.tensor([t]), n)[0]

    def heads(pol, batch):
        with torch.no_grad():
            out = pol.apply(batch.obs.reshape((T + 1) * B, -1))
        return {k: out[k].reshape(T + 1, B, -1) for k in ("logits",
                                                          "logits_b")}

    def forward_score(pol, batch, src):
        logits = heads(pol, batch)["logits"]
        return lambda t, b: masked_logprobs(
            logits[t, b], batch.fwd_mask[t, b] | batch.done[t, b]) \
            + row_noise(src, b, t, A)

    def backward_score(pol, batch, src):
        # forward index t was drawn at backward step T - 1 - t, from the
        # state at forward time t + 1
        logits = heads(pol, batch)["logits_b"]
        return lambda t, b: masked_logprobs(
            logits[t + 1, b], batch.bwd_mask[t + 1, b]) \
            + row_noise(src, b, T - 1 - t, Ab)

    backward = range(T - 1, -1, -1)
    checks = {
        "fwd": (tr_g.fwd.actions, tr_c.fwd.actions, range(T),
                forward_score(pol_init, tr_c.fwd, noise.fwd)),
        "bwd": (tr_g.bwd.bwd_actions, tr_c.bwd.bwd_actions, backward,
                backward_score(pol_init, tr_c.bwd, noise.bwd)),
        "neg": (test_g.neg.actions, test_c.neg.actions, range(T),
                forward_score(pol_c, test_c.neg, noise.neg)),
        "mh": (test_g.mh.batch.bwd_actions, test_c.mh.batch.bwd_actions,
               backward, backward_score(pol_c, test_c.mh.batch,
                                        noise.mh_bwd))}
    rows = {}
    for name, (a_g, a_c, order, score) in checks.items():
        differ = a_g.cpu() != a_c
        ties, bad = _rows_off_a_tie(differ, order, score)
        rows[name] = {"differing": int(differ.any(0).sum()),
                      "near_ties": ties, "mismatched": bad,
                      "equal": ~differ.any(0)}
    bwd_fwd_equal = torch.equal(tr_g.bwd.actions.cpu()[:, rows["bwd"][
        "equal"]], tr_c.bwd.actions[:, rows["bwd"]["equal"]])
    # the TB loss and gradients on the card's batch
    loss_g = float(m_g["gfn_loss"])
    loss_rel = abs(loss_g - loss_tf) / max(abs(loss_tf), 1e-30)
    grad_err, waived = grad_errors(grads_g, grads_c, 1e-5)
    worst = max(grad_err, key=grad_err.get)
    # the MH test on rows whose negatives and MH trajectories agree
    same = rows["neg"]["equal"] & rows["mh"]["equal"]
    J = tr_c.reward.reward_params["J"]
    x, x_neg = tr_c.data.float(), test_c.neg.obs[-1]
    terms = (((x @ J) * x).sum(-1).abs() + ((x_neg @ J) * x_neg).sum(-1).abs()
             + test_c.mh.log_pf.abs() + test_c.mh.log_pb.abs()
             + test_c.neg.log_pf_beh.abs().sum(0))
    log_a_excess = float(((test_g.log_a.cpu() - test_c.log_a).abs()
                          / (1e-4 * terms))[same].max())
    clear = same & ((test_c.log_u - test_c.log_a).abs() > 1e-3)
    accept_equal = torch.equal(test_g.accept.cpu()[clear],
                               test_c.accept[clear])
    # the energy update from the card's MH outcome
    loop_c.cd_step(st_cd, tr_g.data.cpu().float(),
                   tr_g.test.neg.obs[-1].cpu(), tr_g.test.accept.cpu())
    J_err = {}
    for k, got, want in (("J_grad", st_g.J.grad, st_cd.J.grad),
                         ("J", st_g.J.detach(), st_cd.J.detach())):
        J_err[k] = float((got.cpu() - want).abs().max()) \
            / float(want.abs().max())
    mismatched = sum(r["mismatched"] for r in rows.values())
    emit("ising_hold", recipe="ising_ebgfn", steps=T, envs=B,
         j_scale=ISING_HOLD_J_SCALE,
         forward_rows=int(tr_c.take_fwd.sum()), take_fwd_equal=take_equal,
         rollouts={k: {f: v for f, v in r.items() if f != "equal"}
                   for k, r in rows.items()},
         bwd_forward_actions_equal=bwd_fwd_equal,
         mh_rerun_bitwise=rerun_bitwise,
         gfn_loss_cuda=loss_g, gfn_loss_cpu_on_card_batch=loss_tf,
         gfn_loss_cpu_iteration=float(m_c["gfn_loss"]),
         loss_rel_err=loss_rel, grad_max_err_over_scale=grad_err[worst],
         grad_worst_param=worst, grad_waived=waived,
         mh_rows_compared=int(same.sum()),
         log_a_max_err_over_allowed=log_a_excess,
         accept_rows_compared=int(clear.sum()), accept_equal=accept_equal,
         mh_accept_cuda=float(test_g.accept.float().mean()),
         mh_accept_cpu=float(test_c.accept.float().mean()),
         J_grad_max_err_over_scale=J_err["J_grad"],
         J_max_err_over_scale=J_err["J"])
    if not (take_equal and rerun_bitwise and not mismatched and bwd_fwd_equal
            and loss_rel <= 1e-4 and grad_err[worst] <= 1e-4
            and log_a_excess <= 1 and accept_equal
            and max(J_err.values()) <= 1e-4):
        raise AssertionError(
            f"ising_hold: mix coin equal {take_equal}, MH rerun bitwise "
            f"{rerun_bitwise}, {mismatched} rows differ off a tie, loss rel "
            f"error {loss_rel}, gradient error {grad_err[worst]} ({worst}), "
            f"log A {log_a_excess} of its allowance, accept equal "
            f"{accept_equal}, J {J_err}")


def ising_converge(device) -> dict:
    """The JAX package's ``table8_ising_ebgfn(quick=True)`` configuration
    on the card, captured: n = 4, sigma = 0.2, 500 Wolff samples from
    seed 0, MLP 2x256 with a learned P_B (drawn from seed 0), 64 envs,
    loop seed 0, ISING_CONVERGE_ITERS iterations; -log RMSE of J after
    each checkpoint's iterations within ISING_CONVERGE_BAND of the JAX
    package's mean there (ISING_CONVERGE_MEANS), the MH acceptance read at
    each, and every iteration's launches held to ISING_LAUNCHES_PER_ITER.
    Returns the run's launches."""
    from repro_torch.core.ebgfn import EBGFNLoop, neg_log_rmse
    from repro_torch.core.policies import MLPPolicy
    from repro_torch.recipes.ising import ising_dataset, ising_env

    smi = nvidia_smi()
    env = ising_env(n=4, sigma=0.2)
    data = torch.as_tensor(ising_dataset(0, 4, 0.2, 500), device=device)
    policy = MLPPolicy(env.D, env.action_dim, env.backward_action_dim,
                       hidden=(256, 256), learn_backward=True, seed=0,
                       device=device, requires_grad=True)
    loop = EBGFNLoop(env, policy, data, iterations=ISING_CONVERGE_ITERS,
                     num_envs=64)
    J_true = env.init(device).reward_params["J"]

    def checkpoint(it, state, metrics, batch):
        if it + 1 in ISING_CONVERGE_MEANS:
            return (it + 1, float(neg_log_rmse(state.J.detach(), J_true)),
                    float(metrics["mh_accept"]))
        return None

    reset_launches()
    t0 = time.perf_counter()
    _, hist = loop.run(0, ISING_CONVERGE_ITERS, callback=checkpoint)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = run_launches(read_launches(), loop.captured)
    want = {k: v * ISING_CONVERGE_ITERS for k, v in _only(
        launches, **ISING_LAUNCHES_PER_ITER).items()}
    score = {c: v for c, v, _ in filter(None, hist)}
    off = {c: score[c] - m for c, m in ISING_CONVERGE_MEANS.items()}
    emit("ising_converge", nvidia_smi=smi,
         env="Ising 4x4 torus, sigma 0.2, 500 Wolff samples (A=32, A_b=16, "
             "T=16)", policy="MLP 2x256, learned P_B", num_envs=64,
         iterations=ISING_CONVERGE_ITERS, seconds=seconds,
         iterations_per_s=ISING_CONVERGE_ITERS / seconds,
         neg_log_rmse=score, jax_mean=ISING_CONVERGE_MEANS,
         off_jax_mean=off, band=ISING_CONVERGE_BAND,
         mh_accept={c: a for c, _, a in filter(None, hist)},
         replays=loop.captured.replays,
         launches={k: v for k, v in launches.items() if v})
    if launches != want or any(abs(d) > ISING_CONVERGE_BAND
                               for d in off.values()):
        raise AssertionError(f"ising_converge: -log RMSE {score} off JAX's "
                             f"means by {off} (band {ISING_CONVERGE_BAND});"
                             f" launches {launches}, want {want}")
    return launches


def box_hold(device) -> None:
    """One iteration of ``box_tb`` and of ``box_db`` at full width on the
    card and on the CPU from the same parameters (the recipe's policy
    drawn from seed 1) and the same hash noise (loop seed 5).  The
    rollouts: done flags and exit flags equal, except a row whose first
    difference sits at a near tie (the exit coin within TIE_GAP of the
    exit probability, or a coordinate within TIE_GAP of the room test's
    1 - delta_min + 1e-6), counted; on the other rows the observations
    within 1e-5 (sums of increments that ``exp`` and ``sigmoid`` may round
    an ulp apart on the two devices).  Loss and gradients: both devices
    teacher-force the card's batch, loss to 1e-5 relative, each gradient
    to 1e-4 of its largest entry; the card's log P_F of its own draws to
    1e-5 of the CPU's density at them, relative to max(1, |log P_F|)."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.core.types import hash_flow_noise, train_seed
    from repro_torch.nn.flows import _exit_logprobs

    cpu = torch.device("cpu")
    smi = nvidia_smi()
    for name in BOX_RECIPES:
        rec = recipes.get_train(name)
        env = rec.make_env()
        cfg = rec.make_config(env, rec.num_envs, rec.iterations)
        pol_g = rec.make_policy(env, seed=1, device=device,
                                requires_grad=True)
        pol_c = rec.make_policy(env, seed=1, device=cpu, requires_grad=True)
        pol_c.load_params({k: v.detach().cpu()
                           for k, v in pol_g.params.flat().items()})
        loop_g = TrainLoop(env, env.init(device), pol_g, cfg)
        loop_c = TrainLoop(env, env.init(cpu), pol_c, cfg)
        st_g, st_c = loop_g.init(seed=5), loop_c.init(seed=5)
        batch_g = loop_g.sample(st_g)
        batch_c = loop_c.sample(st_c)
        gb = _to_cpu(batch_g)
        T, B = batch_c.valid.shape
        differ = ((gb.done[1:] != batch_c.done[1:])
                  | (gb.actions[..., 2] != batch_c.actions[..., 2])
                  | (gb.fwd_mask[:-1] != batch_c.fwd_mask[:-1]).any(-1))
        seed = torch.full((1,), train_seed(5, 0), dtype=torch.int64)

        def gap(t, b):
            obs = batch_c.obs[t, b][None]
            pos, steps, term = env.obs_fields(obs)
            can_inc, can_exit = env.forward_arms(pos, steps, term)
            with torch.no_grad():
                logit = pol_c._heads(pol_c.torso(obs))[2]
            log_pe, _ = _exit_logprobs(logit, can_inc, can_exit)
            u = hash_flow_noise(seed, torch.tensor([b]), torch.tensor([t]),
                                pol_c.noise_dims).exit_u
            return min(float((u - torch.exp(log_pe)).abs()),
                       float((pos - env._room).abs().min()))

        ties = mismatched = 0
        for b in differ.any(0).nonzero()[:, 0].tolist():
            t = next(t for t in range(T) if differ[t, b])
            if gap(t, b) < TIE_GAP:
                ties += 1
            else:
                mismatched += 1
        off = ~differ.any(0)
        pos_err = float((gb.obs - batch_c.obs).abs()[:, off].max())
        with torch.no_grad():
            lp_c = pol_c.log_prob(gb.obs[:-1], gb.actions)
        lp_err = float(((gb.log_pf_beh - torch.where(gb.valid, lp_c, 0.0))
                        .abs() / torch.clamp(lp_c.abs(), min=1.0)).max())
        loss_g = float(loop_g.loss_and_grads(batch_g))
        loss_c = float(loop_c.loss_and_grads(gb))
        grad_err, waived = grad_errors(
            {k: p.grad for k, p in pol_g.params.flat().items()},
            {k: p.grad for k, p in pol_c.params.flat().items()}, 0.0)
        worst = max(grad_err, key=grad_err.get)
        rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
        emit("box_hold", nvidia_smi=smi, recipe=name, env=BOX_ENV,
             policy=BOX_POLICY, steps=T, envs=B,
             rows_differing=int(differ.any(0).sum()), near_tie_rows=ties,
             mismatched_rows=mismatched, obs_max_abs_err=pos_err,
             log_pf_max_err_over_scale=lp_err,
             exits=int((gb.actions[..., 2] * gb.valid).sum()),
             mean_length=float(gb.valid.sum(0).float().mean()),
             loss_cuda=loss_g, loss_cpu=loss_c, loss_rel_err=rel,
             grad_max_err_over_scale=grad_err[worst],
             grad_worst_param=worst)
        if (mismatched or not pos_err <= 1e-5 or not lp_err <= 1e-5
                or not rel <= 1e-5 or not grad_err[worst] <= 1e-4):
            raise AssertionError(
                f"box_hold {name}: {mismatched} rows differ off a tie, obs "
                f"error {pos_err}, log P_F error {lp_err}, loss rel error "
                f"{rel}, gradient error {grad_err[worst]} ({worst})")


def box_converge(device) -> dict:
    """``box_tb`` as registered on the card, captured, for
    BOX_CONVERGE_ITERS iterations (policy drawn from seed 0, loop seed
    0): the recipe's quadrature eval (8,192 non-exploring rollouts on the
    16 x 16 grid) after each checkpoint's iterations, its quad_tv within
    the band of the JAX package's mean there (BOX_CONVERGE_MEANS); no
    kernel launched (the density path takes none).  Returns the run's
    launches."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.core.types import eval_seed

    smi = nvidia_smi()
    rec = recipes.get_train("box_tb")
    env = rec.make_env()
    params = env.init(device)
    policy = rec.make_policy(env, seed=0, device=device, requires_grad=True)
    loop = TrainLoop(env, params, policy,
                     rec.make_config(env, rec.num_envs, rec.iterations))
    ev, = rec.make_evals(env, params, policy, seed=0)
    eval_s = []

    def checkpoint(it, state, metrics, batch):
        if it + 1 not in BOX_CONVERGE_MEANS:
            return None
        torch.cuda.synchronize()        # the replays queued before it
        t0 = time.perf_counter()
        out = ev(eval_seed(0, it + 1, 0))
        row = (it + 1, float(out["quad_tv"]), float(out["quad_jsd"]),
               float(metrics["loss"]))
        eval_s.append(time.perf_counter() - t0)
        return row

    reset_launches()
    t0 = time.perf_counter()
    _, hist = loop.run(0, BOX_CONVERGE_ITERS, callback=checkpoint)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = run_launches(read_launches(), loop.captured)
    rows = [r for r in hist if r is not None]
    tv = {c: v for c, v, _, _ in rows}
    band = {c: max(BOX_CONVERGE_MIN_BAND, 3 * s)
            for c, s in BOX_CONVERGE_SPREAD.items()}
    off = {c: tv[c] - m for c, m in BOX_CONVERGE_MEANS.items()}
    train_s = seconds - sum(eval_s)
    emit("box_converge", nvidia_smi=smi, recipe="box_tb", env=BOX_ENV,
         policy=BOX_POLICY, num_envs=rec.num_envs,
         iterations=BOX_CONVERGE_ITERS, seconds=seconds,
         eval_seconds=eval_s, training_seconds=train_s,
         iterations_per_s=BOX_CONVERGE_ITERS / train_s,
         quad_tv=tv, quad_jsd={c: j for c, _, j, _ in rows},
         loss={c: lo for c, _, _, lo in rows},
         jax_mean=BOX_CONVERGE_MEANS, off_jax_mean=off, band=band,
         replays=loop.captured.replays, graph_launches=loop.captured.launches,
         launches={k: v for k, v in launches.items() if v})
    if any(launches.values()) or any(abs(off[c]) > band[c] for c in off):
        raise AssertionError(f"box_converge: quad_tv {tv} off JAX's means "
                             f"by {off} (bands {band}); launches {launches}")
    return launches


# -- phase 8c: replay training --------------------------------------------------

def _sampler_loop(rec, env, env_params, device, sampler, kwargs, seed=1):
    """A fresh TrainLoop of recipe ``rec`` over ``sampler`` (its policy
    drawn from ``seed``)."""
    from repro_torch.algo import TrainLoop, make_sampler
    policy = rec.make_policy(env, seed=seed, device=device,
                             requires_grad=True)
    return TrainLoop(env, env_params, policy,
                     rec.make_config(env, rec.num_envs, rec.iterations),
                     sampler=make_sampler(sampler, **kwargs))


def _buffers_bitwise(a, b) -> bool:
    return (torch.equal(a.insert_pos, b.insert_pos)
            and torch.equal(a.size, b.size)
            and all(torch.equal(a.data[k], b.data[k]) for k in a.data))


def replay_train_phase(device) -> dict:
    """The three replay paths of the CLI (REPLAY_PATHS) at full width,
    each: REPLAY_RUN_ITERS iterations through ``run_recipe`` with the
    sampler (captured; every iteration's launches held to
    REPLAY_LAUNCHES_PER_ITER exactly); then from one fresh state (policy
    seed 1, loop seed 5) two eager runs and a captured run of
    GRAPH_HOLD_ITERS iterations, the captured one held bitwise to the
    eager one (actions of every iteration, losses, parameters, and the
    buffer: slots, insert position, fill level), where the two eager runs
    are bitwise; eager and captured it/s over REPLAY_RATE_ITERS; one
    replay's kernels, busy time and idle share (replay_profile).  Then the
    pop-only cached backward (cached_backward).  Returns the launches."""
    from repro_torch import recipes

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, (sampler, kwargs) in REPLAY_PATHS.items():
        rec = recipes.get_train(name)
        fields, launches = counted_run(
            name, REPLAY_RUN_ITERS[name], REPLAY_LAUNCHES_PER_ITER[name],
            device, sampler=sampler, sampler_kwargs=kwargs)
        for k, v in launches.items():
            total[k] += v
        env = rec.make_env()
        env_params = env.init(device)

        def fresh():
            loop = _sampler_loop(rec, env, env_params, device, sampler,
                                 kwargs)
            return loop, loop.init(seed=5)

        loop_a, state_a = fresh()
        reset_launches()
        a = _hold_run(loop_a, state_a, captured=False)
        eager = read_launches()
        loop_b, state_b = fresh()
        b = _hold_run(loop_b, state_b, captured=False)
        loop_c, state_c = fresh()
        c = _hold_run(loop_c, state_c, captured=True)
        graph = c["graph"]
        want = _only(eager, **REPLAY_LAUNCHES_PER_ITER[name])
        eager_bitwise = _bitwise(a, b) and _buffers_bitwise(
            state_a.sampler, state_b.sampler)
        actions_all = all(torch.equal(x, y) for x, y in
                          zip(c["actions"], a["actions"]))
        bitwise = _bitwise(c, a) and actions_all
        buffer_bitwise = _buffers_bitwise(state_c.sampler, state_a.sampler)
        n_eager, n_graph = REPLAY_RATE_ITERS[name]
        t0 = time.perf_counter()
        for _ in range(n_eager):
            loop_a.step(state_a)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_graph):
            graph()
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        prof = profiled_step(graph)
        emit("replay_train", nvidia_smi=smi, recipe=name, sampler=sampler,
             options=kwargs, num_envs=rec.num_envs,
             replay_batch=loop_c.num_envs - rec.num_envs,
             batch_rows=loop_c.num_envs, run=fields,
             hold_iterations=GRAPH_HOLD_ITERS,
             eager_runs_bitwise=eager_bitwise,
             captured_bitwise_eager=bitwise,
             captured_buffer_bitwise_eager=buffer_bitwise,
             buffer_size=int(state_c.sampler.size),
             captured_vs_eager_max_abs=_max_abs(c, a),
             launches_per_iteration={k: v // GRAPH_HOLD_ITERS
                                     for k, v in eager.items()},
             graph_launches=graph.launches,
             warmup_seconds=graph.warmup_seconds,
             capture_seconds=graph.capture_seconds,
             eager_iterations=n_eager, captured_iterations=n_graph,
             eager_iterations_per_s=n_eager / eager_s,
             captured_iterations_per_s=n_graph / graph_s,
             speedup=(eager_s / n_eager) / (graph_s / n_graph),
             replay_kernels=prof["device_kernels"],
             replay_busy_us=prof["device_busy_us"],
             replay_wall_us=prof["wall_us"],
             replay_idle_share=prof["device_idle_share"],
             replay_device_top=prof["device_top"][:5])
        want_hold = {k: v * GRAPH_HOLD_ITERS for k, v in want.items()}
        if not (bitwise and buffer_bitwise) and eager_bitwise:
            raise AssertionError(
                f"replay_train {name}: captured run not bitwise eager "
                f"(buffer {buffer_bitwise}, {_max_abs(c, a)} off)")
        if eager != want_hold or graph.launches != want:
            raise AssertionError(
                f"replay_train {name}: eager launched {eager} in "
                f"{GRAPH_HOLD_ITERS} iterations, one replay "
                f"{graph.launches}; each iteration should {want}")
    cached = cached_backward_phase(device)
    for k, v in cached.items():
        total[k] += v
    return total


# -- the training CLI: env registry, transforms, --cfg, checkpoints -------------

def cli_run(argv, per_iter: dict) -> dict:
    """``repro_torch.run.main(argv)`` (the CLI a user calls; output
    swallowed), with its run read: every iteration's launches (the eager
    warm-up's from the wrappers, a replay's from the capture; the evals'
    launches, between iterations, counted apart) held to ``per_iter``
    exactly, every row finite.  Returns the run's ``out`` and its
    fields."""
    import io

    from repro_torch import run as cli
    from repro_torch.evals import EvalSuite

    real_run, real_record = cli.run_recipe, EvalSuite.maybe_record
    seen, per_it = {}, []
    evals = {k: 0 for k in wrappers()}
    reset_launches()
    last = read_launches()

    def log(line):
        if line.startswith("it "):
            now = read_launches()
            per_it.append({k: now[k] - last[k] for k in now})
            last.update(now)

    def record(suite, iteration):
        before = read_launches()
        row = real_record(suite, iteration)
        for k, v in read_launches().items():
            evals[k] += v - before[k]
            last[k] += v - before[k]
        return row

    def spy(*args, **kwargs):
        seen["out"] = real_run(*args, **dict(kwargs, log=log))
        return seen["out"]

    cli.run_recipe, EvalSuite.maybe_record = spy, record
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
    finally:
        cli.run_recipe, EvalSuite.maybe_record = real_run, real_record
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = seen["out"]
    captured = out["loop"].captured
    launches = run_launches(read_launches(), captured)
    want = _only(launches, **per_iter)
    per_it = [got if it == 0 else {k: v + captured.launches[k]
                                   for k, v in got.items()}
              for it, got in enumerate(per_it)]
    bad = [(it, got) for it, got in enumerate(per_it) if got != want]
    if rc != 0 or bad or captured.launches != want:
        raise AssertionError(f"cli {argv}: rc {rc}; one replay launched "
                             f"{captured.launches}; iterations launching "
                             f"other than {want}: {bad[:3]}")
    hist = out["history"]
    if not all(math.isfinite(r[k]) for r in hist
               for k in ("loss", "log_z", "mean_log_reward")):
        raise AssertionError(f"cli {argv}: rows not finite: {hist[-2:]}")
    steady = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"]) \
        if len(hist) > 1 else None
    return dict(out=out, launches=launches, fields=dict(
        argv=argv, iterations=len(hist), wall_s=wall,
        steady_iterations_per_s=steady, launches=launches,
        launches_per_iteration=want, eval_launches=evals,
        graph_launches=captured.launches, replays=captured.replays,
        warmup_seconds=captured.warmup_seconds,
        capture_seconds=captured.capture_seconds))


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] += v


def checkpoint_seconds(loop, state, tmp: Path) -> dict:
    """One blocking save of the run's full state (the tree the loop writes,
    its host copy and the files) and one restore of it into the state (the
    files read, the tensors copied in place), timed on the host; the files
    are warm in the page cache."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(tmp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = loop.checkpoint_tree(state)
    mgr.save(1, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop.restore_state(state, mgr, 1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    return dict(save_seconds=save_s, restore_seconds=restore_s,
                state_leaves=len(tree),
                state_bytes=sum(t.numel() * t.element_size()
                          for t in tree.values()))


def cli_phase(device) -> dict:
    """The training CLI on the card (``repro_torch.run.main``):

    - CLI_TFBIND8: tfbind8 from the env registry with ``reward_cache`` and
      a scheduled ``reward_exponent``, ``--cfg`` clip and weight decay,
      CLI_ITERS iterations, evals every CLI_EVAL_EVERY into
      ``--metrics-json``: every iteration's launches exact (16 / 2 / 1),
      the JSON's schema 1 and its rows at 0 and 25; then from one fresh state (policy seed 1, loop seed 5) two
      eager runs and a captured run of GRAPH_HOLD_ITERS iterations of the
      same stack, the captured one bitwise eager (the beta moves every
      iteration); one replay's device kernels beside a replay of the stack
      without the cache;
    - each CLI_RESUMES run: CLI_ITERS iterations with a checkpoint every
      CLI_CUT, then CLI_CUT iterations into another directory and
      ``--restore`` to CLI_ITERS: every leaf of the two final checkpoints
      bitwise equal (params, Adam's moments and step, the counter, the
      replay buffer), the resumed rows equal to the uninterrupted ones;
      save and restore seconds of the full state;
    - bitseq_tb at full width trained CLI_SERVE_TRAIN_ITERS iterations into
      a checkpoint, served through ``python -m repro_torch.launch.serve
      --checkpoint``: the samples equal ``forward_rollout`` of the trained
      policy, decode_step launches counted.

    Returns the launches of every run and of the serving."""
    import io

    import numpy as np

    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.rollout import forward_rollout
    from repro_torch.envs.transforms import apply_transforms, transform_stack
    from repro_torch.launch import serve as serve_cli
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- registry, transforms, --cfg, --metrics-json -----------------
        path = tmp / "tfbind8.json"
        got = cli_run(CLI_TFBIND8 + [
            "--iterations", str(CLI_ITERS), "--eval-every",
            str(CLI_EVAL_EVERY), "--metrics-json", str(path)],
            CLI_LAUNCHES_PER_ITER["tfbind8"])
        _add(total, got["launches"])
        out = got["out"]
        doc = json.loads(path.read_text())
        stack = transform_stack(out["loop"].env)
        cfg = out["loop"].cfg
        if (doc["schema_version"] != 1 or doc["recipe"] != "tfbind8_tb"
                or [r["step"] for r in doc["rows"]]
                != list(range(0, CLI_ITERS, CLI_EVAL_EVERY))
                or not all(math.isfinite(r[k]) for r in doc["rows"]
                           for k in doc["metric_names"])
                or stack != ("reward_exponent", "reward_cache")
                or (cfg.max_grad_norm, cfg.weight_decay) != (1.0, 1e-4)):
            raise AssertionError(f"cli tfbind8: stack {stack}, cfg {cfg}, "
                                 f"metrics JSON {doc}")
        rec = recipes.get_train("tfbind8_tb")
        specs = {"cached": ["reward_cache", CLI_BETA],
                 "uncached": [CLI_BETA]}

        def fresh(kind):
            env = apply_transforms(rec.make_env(), specs[kind])
            loop = TrainLoop(env, env.init(device),
                             rec.make_policy(env, seed=1, device=device,
                                             requires_grad=True), cfg)
            return loop, loop.init(seed=5)

        loop_a, state_a = fresh("cached")
        a = _hold_run(loop_a, state_a, captured=False)
        loop_b, state_b = fresh("cached")
        b = _hold_run(loop_b, state_b, captured=False)
        loop_c, state_c = fresh("cached")
        c = _hold_run(loop_c, state_c, captured=True)
        eager_bitwise = _bitwise(a, b)
        bitwise = _bitwise(c, a) and all(
            torch.equal(x, y) for x, y in zip(c["actions"], a["actions"]))
        beta = [float(loop_c.env.update_params(loop_c.env_params,
                                               torch.tensor(i)).extra["beta"])
                for i in range(GRAPH_HOLD_ITERS)]
        cached_prof = profiled_step(c["graph"])
        loop_u, state_u = fresh("uncached")
        u = _hold_run(loop_u, state_u, captured=True)
        uncached_prof = profiled_step(u["graph"])
        emit("cli", nvidia_smi=smi, run="tfbind8 registry + transforms",
             **got["fields"], transform_stack=list(stack),
             metrics_json={k: doc[k] for k in ("schema_version", "recipe",
                                               "iterations", "eval_every",
                                               "eval_batch",
                                               "metric_names")},
             metric_rows=doc["rows"], hold_iterations=GRAPH_HOLD_ITERS,
             hold_beta=beta, eager_runs_bitwise=eager_bitwise,
             captured_bitwise_eager=bitwise,
             captured_vs_eager_max_abs=_max_abs(c, a),
             replay_kernels={"reward_cache": cached_prof["device_kernels"],
                             "no_cache": uncached_prof["device_kernels"]},
             replay_busy_us={"reward_cache": cached_prof["device_busy_us"],
                             "no_cache": uncached_prof["device_busy_us"]},
             replay_wall_us={"reward_cache": cached_prof["wall_us"],
                             "no_cache": uncached_prof["wall_us"]})
        if not (eager_bitwise and bitwise):
            raise AssertionError(
                f"cli tfbind8: captured run {_max_abs(c, a)} from eager, "
                f"eager runs {_max_abs(a, b)} apart; both should be bitwise")
        # -- checkpoints: a cut run resumed is the uninterrupted run ------
        for name, flags in CLI_RESUMES.items():
            per_iter = CLI_LAUNCHES_PER_ITER[name]
            whole, cut = tmp / f"{name}_whole", tmp / f"{name}_cut"
            common = flags + ["--eval-every", "0", "--checkpoint-every",
                              str(CLI_CUT)]
            w = cli_run(common + ["--iterations", str(CLI_ITERS),
                                  "--checkpoint-dir", str(whole)], per_iter)
            first = cli_run(common + ["--iterations", str(CLI_CUT),
                                      "--checkpoint-dir", str(cut)],
                            per_iter)
            r = cli_run(common + ["--iterations", str(CLI_ITERS),
                                  "--checkpoint-dir", str(cut),
                                  "--restore"], per_iter)
            for run in (w, first, r):
                _add(total, run["launches"])
            want = CheckpointManager(whole).load(CLI_ITERS)
            have = CheckpointManager(cut).load(CLI_ITERS)
            differ = sorted(k for k in want
                            if k not in have or not torch.equal(want[k],
                                                                have[k]))
            rows_equal = [
                {k: v for k, v in x.items() if k != "wall_s"} ==
                {k: v for k, v in y.items() if k != "wall_s"}
                for x, y in zip(w["out"]["history"][CLI_CUT:],
                                r["out"]["history"])]
            seconds = checkpoint_seconds(w["out"]["loop"], w["out"]["state"],
                                         tmp / f"{name}_timing")
            emit("cli", nvidia_smi=smi, run=f"{name} resume",
                 uninterrupted=w["fields"], cut=first["fields"],
                 resumed=r["fields"], checkpoint_leaves=len(want),
                 buffer=".sampler/.size" in want,
                 leaves_differing=differ,
                 resumed_rows_equal=all(rows_equal) and len(rows_equal)
                 == CLI_ITERS - CLI_CUT, **seconds)
            if differ or not all(rows_equal) or \
                    len(rows_equal) != CLI_ITERS - CLI_CUT:
                raise AssertionError(f"cli {name}: the resumed run is not "
                                     f"the uninterrupted one: {differ[:5]}")
        # -- serving from a checkpoint ------------------------------------
        ckpt = tmp / "bitseq_tb"
        reset_launches()
        trained = run_recipe("bitseq_tb", iterations=CLI_SERVE_TRAIN_ITERS,
                             eval_every=0, device=device,
                             checkpoint_dir=str(ckpt), checkpoint_every=1,
                             log=lambda line: None)
        _add(total, run_launches(read_launches(),
                                 trained["loop"].captured))
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = serve_cli.main(["--env", "bitseq", "--checkpoint",
                                 str(ckpt), "--num-samples",
                                 str(CLI_SERVE_SAMPLES), "--seed", "7",
                                 "--json"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        served = read_launches()
        _add(total, served)
        doc = json.loads(text.getvalue())
        env = recipes.get("bitseq").make_env()
        with torch.no_grad():
            ref = forward_rollout(7, env, env.init(device),
                                  trained["policy"], CLI_SERVE_SAMPLES)
        equal = np.array_equal(np.array(doc["samples"]),
                               ref.obs[-1].cpu().numpy())
        emit("cli", nvidia_smi=smi, run="serve bitseq_tb checkpoint",
             train_iterations=CLI_SERVE_TRAIN_ITERS,
             checkpoint_steps=CheckpointManager(ckpt).all_steps(),
             samples=len(doc["samples"]), serve_seconds=serve_s,
             launches=served, samples_equal_forward_rollout=equal)
        if rc != 0 or not equal or served["decode_step"] == 0:
            raise AssertionError(f"cli serve: rc {rc}, samples equal "
                                 f"{equal}, launches {served}")
    return total


def cached_backward_phase(device) -> dict:
    """``backward_rollout(..., with_log_pf=True)`` on tfbind8 and AMP with
    the recipes' decode policies (policy seed 1) from REPLAY_BATCH terminals
    of a forward rollout, JAX's default ``use_cache="auto"``: the pop-only
    cached backward, one decode_attention launch per layer and step
    (CACHED_BACKWARD_LAUNCHES), held against the uncached rollout on the
    card (``use_cache=False``: full passes, no kernel) on the same noise:
    actions bitwise, log P_F and log P_B to 1e-4.  Both timed.  Returns
    the cached rollouts' launches."""
    from repro_torch import recipes
    from repro_torch.core.rollout import backward_rollout, forward_rollout

    total = {k: 0 for k in wrappers()}
    for name, per_rollout in CACHED_BACKWARD_LAUNCHES.items():
        rec = recipes.get_train(name)
        env = rec.make_env()
        params = env.init(device)
        policy = rec.make_policy(env, seed=1, device=device)
        _, term = forward_rollout(3, env, params, policy, REPLAY_BATCH,
                                  exploration_eps=0.5,
                                  return_final_state=True)
        out, seconds, launches = {}, {}, {}
        for use_cache in ("auto", False):
            backward_rollout(4, env, params, policy, term,
                             use_cache=use_cache)          # warm
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out[use_cache] = backward_rollout(
                4, env, params, policy, term, collect=True,
                use_cache=use_cache)
            torch.cuda.synchronize()
            seconds[use_cache] = time.perf_counter() - t0
            launches[use_cache] = {k: v for k, v in read_launches().items()
                                   if v}
        ca, un = out["auto"], out[False]
        actions = torch.equal(ca.batch.actions, un.batch.actions)
        pf_err = float((ca.log_pf - un.log_pf).abs().max())
        pb_err = float((ca.log_pb - un.log_pb).abs().max())
        finite = bool(torch.isfinite(ca.log_pf).all())
        emit("cached_backward", recipe=name, rows=REPLAY_BATCH,
             steps=env.max_steps, actions_bitwise=actions,
             log_pf_max_abs=pf_err, log_pb_max_abs=pb_err,
             log_pf_finite=finite, launches=launches["auto"],
             uncached_launches=launches[False],
             cached_seconds=seconds["auto"],
             uncached_seconds=seconds[False])
        want = {"decode_attention": per_rollout}
        if not (actions and pf_err <= 1e-4 and pb_err <= 1e-4 and finite) \
                or launches["auto"] != want or launches[False]:
            raise AssertionError(
                f"cached_backward {name}: actions {actions}, log P_F "
                f"{pf_err}, log P_B {pb_err}, launches {launches}")
        total["decode_attention"] += per_rollout
    return total


def replay_hold(device) -> None:
    """One iteration of each replay path on the card against the same
    iteration on the CPU, at full size (``hold_iteration`` with the
    sampler), after REPLAY_HOLD_WARM iterations that fill both buffers."""
    for name, (sampler, kwargs) in REPLAY_PATHS.items():
        hold_iteration("replay_hold", name, device, sampler=sampler,
                       sampler_kwargs=kwargs, warm=REPLAY_HOLD_WARM)


def replay_converge(device) -> dict:
    """``hypergrid_tb`` with reward-prioritized replay (capacity 4,096, the
    README's command) at full size, captured, for REPLAY_CONVERGE_ITERS
    iterations (policy drawn from seed 0, loop seed 0; epsilon annealed
    over half the run, as ``--iterations`` sets it): exact-DP TV after each
    checkpoint within the band of the JAX package's mean there
    (REPLAY_CONVERGE_MEANS, ``scripts/replay_reference.py``; the band the
    larger of REPLAY_CONVERGE_MIN_BAND and three times the seeds' spread,
    fixed before the card's first run).  Returns the run's launches."""
    from repro_torch import recipes
    from repro_torch.algo import ReplaySampler, TrainLoop
    from repro_torch.evals import ExactDistributionEval

    smi = nvidia_smi()
    rec = recipes.get_train("hypergrid_tb")
    env = rec.make_env()
    params = env.init(device)
    policy = rec.make_policy(env, seed=0, device=device, requires_grad=True)
    loop = TrainLoop(env, params, policy,
                     rec.make_config(env, rec.num_envs,
                                     REPLAY_CONVERGE_ITERS),
                     sampler=ReplaySampler(capacity=4096, prioritized=True))
    ev = ExactDistributionEval(env, params, policy)
    eval_s = []

    def checkpoint(it, state, metrics, batch):
        if it + 1 not in REPLAY_CONVERGE_MEANS:
            return None
        torch.cuda.synchronize()        # the replays queued before it
        t0 = time.perf_counter()
        out = ev(0)
        row = (it + 1, float(out["exact_tv"]), float(out["exact_jsd"]),
               float(metrics["loss"]))
        eval_s.append(time.perf_counter() - t0)
        return row

    reset_launches()
    t0 = time.perf_counter()
    state, hist = loop.run(0, REPLAY_CONVERGE_ITERS, callback=checkpoint)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = run_launches(read_launches(), loop.captured)
    rows = [r for r in hist if r is not None]
    tv = {c: v for c, v, _, _ in rows}
    band = {c: max(REPLAY_CONVERGE_MIN_BAND, 3 * s)
            for c, s in REPLAY_CONVERGE_SPREAD.items()}
    off = {c: tv[c] - m for c, m in REPLAY_CONVERGE_MEANS.items()}
    train_s = seconds - sum(eval_s)
    emit("replay_converge", nvidia_smi=smi, recipe="hypergrid_tb",
         sampler="replay", options={"capacity": 4096, "prioritized": True},
         num_envs=rec.num_envs, batch_rows=loop.num_envs,
         iterations=REPLAY_CONVERGE_ITERS, seconds=seconds,
         eval_seconds=eval_s, training_seconds=train_s,
         iterations_per_s=REPLAY_CONVERGE_ITERS / train_s,
         exact_tv=tv, exact_jsd={c: j for c, _, j, _ in rows},
         loss={c: lo for c, _, _, lo in rows},
         jax_mean=REPLAY_CONVERGE_MEANS, off_jax_mean=off, band=band,
         buffer_size=int(state.sampler.size),
         replays=loop.captured.replays, graph_launches=loop.captured.launches,
         launches={k: v for k, v in launches.items() if v})
    if any(launches.values()) or any(abs(off[c]) > band[c] for c in off):
        raise AssertionError(
            f"replay_converge: exact_tv {tv} off JAX's means by {off} "
            f"(bands {band}); launches {launches}")
    return launches


# -- phase 9: captured training iterations -------------------------------------

def _hold_run(loop, state, captured: bool):
    """GRAPH_HOLD_ITERS iterations of a fresh loop, eagerly or through a
    captured iteration (iteration 0 eager, then replays): every
    iteration's actions and loss (the loop's first metric), and the
    tensors it trains after them (``loop.trained``: the policy's
    parameters, and EB-GFN's J)."""
    actions, losses, graph = [], [], None
    for it in range(GRAPH_HOLD_ITERS):
        if not captured:
            _, metrics, batch = loop.step(state)
        elif graph is None:
            graph = loop.capture(state)
            metrics, batch = graph.warmup
        else:
            metrics, batch = graph()
        actions.append(batch.actions.clone())
        losses.append(metrics[loop.METRICS[0]].clone())
    torch.cuda.synchronize()
    return {"actions": actions, "loss": torch.stack(losses),
            "params": {k: v.detach().clone()
                       for k, v in loop.trained(state).items()},
            "graph": graph}


def _max_abs(a: dict, b: dict) -> float:
    return max([float((a["loss"] - b["loss"]).abs().max())]
               + [float((a["params"][k] - b["params"][k]).abs().max())
                  for k in a["params"]])


def _bitwise(a: dict, b: dict) -> bool:
    return torch.equal(a["loss"], b["loss"]) and all(
        torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def graph_train_phase(device) -> None:
    """Each on-policy recipe and EB-GFN's ``ising_ebgfn`` at full width
    (GRAPH_LAUNCHES_PER_ITER), from one fresh state (the recipe's policy
    drawn from seed 1, loop seed 5):
    two eager runs of GRAPH_HOLD_ITERS iterations (``loop.step``) measure
    how closely the card repeats itself, and a captured run (iteration 0
    eager, then replays) is held to that: iteration 0's actions bitwise,
    the losses and parameters within the eager runs' own difference
    (bitwise where they are bitwise).  One iteration's launches, eager and
    in one replay, equal the recipe's.  Then both runs go on for the same
    iterations, timed (it/s captured against eager), and one replay is
    profiled (graph_profile: the device's idle share and the kernels of
    an iteration)."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.recipes.ising import ising_loop

    smi = nvidia_smi()
    for name, per_iter in GRAPH_LAUNCHES_PER_ITER.items():
        rec = recipes.get_train(name)
        env = rec.make_env()
        env_params = env.init(device)
        iters = GRAPH_RATE_ITERS.get(name, GRAPH_RATE_ITERS_DEFAULT)

        def fresh():
            policy = rec.make_policy(env, seed=1, device=device,
                                     requires_grad=True)
            if rec.run_override is None:
                loop = TrainLoop(env, env_params, policy, rec.make_config(
                    env, rec.num_envs, rec.iterations))
            else:               # EB-GFN, the recipe that runs its own loop
                loop = ising_loop(env, policy, seed=0,
                                  iterations=GRAPH_HOLD_ITERS + iters)
            return loop, loop.init(seed=5)

        loop_a, state_a = fresh()
        reset_launches()
        a = _hold_run(loop_a, state_a, captured=False)
        eager = read_launches()
        b = _hold_run(*fresh(), captured=False)
        loop_c, state_c = fresh()
        reset_launches()
        c = _hold_run(loop_c, state_c, captured=True)
        warm = read_launches()
        graph = c["graph"]
        want = _only(eager, **per_iter)
        tol = _max_abs(a, b)
        eager_bitwise = _bitwise(a, b)
        err = _max_abs(c, a)
        actions0 = torch.equal(c["actions"][0], a["actions"][0])
        actions_all = all(torch.equal(x, y) for x, y in
                          zip(c["actions"], a["actions"]))

        t0 = time.perf_counter()
        for _ in range(iters):
            loop_a.step(state_a)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            graph()
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        emit("graph_train", nvidia_smi=smi, recipe=name,
             num_envs=rec.num_envs,
             hold_iterations=GRAPH_HOLD_ITERS,
             eager_vs_eager_max_abs=tol, eager_runs_bitwise=eager_bitwise,
             captured_vs_eager_max_abs=err,
             captured_bitwise=_bitwise(c, a),
             actions_equal_iteration_0=actions0,
             actions_equal_every_iteration=actions_all,
             losses=c["loss"].tolist(),
             launches_per_iteration={k: v // GRAPH_HOLD_ITERS
                                     for k, v in eager.items()},
             graph_launches=graph.launches,
             warmup_seconds=graph.warmup_seconds,
             capture_seconds=graph.capture_seconds,
             timed_iterations=iters,
             eager_iterations_per_s=iters / eager_s,
             captured_iterations_per_s=iters / graph_s,
             speedup=eager_s / graph_s)
        want_hold = {k: v * GRAPH_HOLD_ITERS for k, v in want.items()}
        if not (actions0 and err <= tol and (_bitwise(c, a)
                                              or not eager_bitwise)):
            raise AssertionError(
                f"graph_train {name}: captured run {err} from eager (eager "
                f"runs {tol} apart), iteration 0's actions equal {actions0}")
        if eager != want_hold or graph.launches != want or warm != want:
            raise AssertionError(
                f"graph_train {name}: eager launched {eager} in "
                f"{GRAPH_HOLD_ITERS} iterations, the warm-up {warm}, one "
                f"replay {graph.launches}; each iteration should {want}")
        profile_step("graph_profile", graph, recipe=name,
                     graph_launches=graph.launches)


# -- phase 10: Hymba-1.5B serving: decode and prompt scoring -----------------------

def lm_config(arch: str, **changes):
    """An architecture's full config from the port's registry, with
    ``changes`` (a cut depth, another dtype or cache)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), **changes)


def lm_params(cfg, device, seed: int = 0):
    """Random full-width weights from a seeded generator on the card
    (1.39 B normal draws for Hymba, 32.76 B for qwen2.5-32b; on a host CPU
    that takes many seconds)."""
    from repro_torch.models import lm as LM
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return LM.init_params(cfg, generator=g, device=device)


def _only(launches: dict, **want) -> dict:
    return {k: want.get(k, 0) for k in launches}


def prefill_batch(cfg, device, batch: int = PREFILL_BATCH,
                  seq_len: int = PREFILL_LEN, params=None):
    """A scoring pass's random tokens (seeded; Hymba's 2 x 4,096 unless
    given) and targets.  The VLM reads embeddings and M-RoPE ids in place
    of the tokens (:func:`vlm_inputs`: VLM_SCORE_TEXT text tokens, a
    VLM_SCORE_GRID image grid, text after; ``params``' embedding rows);
    Whisper WHISPER_FRAMES stub frames too."""
    g = torch.Generator(device=device)
    g.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=g,
                         device=device)
    out = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        out = dict(vlm_inputs(params, toks, VLM_SCORE_TEXT, VLM_SCORE_GRID,
                              g), targets=out["targets"])
    elif cfg.family == "encdec":
        out["frames"] = stub_frames(cfg, device, batch)
    return out


def grid_position_ids(text: int, grid, after: int, device) -> torch.Tensor:
    """(3, S) M-RoPE ids, as qwen2-vl numbers them: ``text`` tokens at t =
    h = w = 0, 1, ...; an image of ``grid`` = (rows, cols) patches at t =
    the next index and h / w that index plus the patch's row / column;
    ``after`` text tokens from the largest id so far + 1."""
    rows, cols = grid
    n = rows * cols
    r = torch.arange(n) // cols
    ids = [torch.cat([torch.arange(text), text + b])
           for b in (torch.zeros(n, dtype=torch.int64), r, torch.arange(n)
                     - r * cols)]
    start = int(max(int(i.max()) for i in ids)) + 1
    return torch.stack([torch.cat([i, start + torch.arange(after)])
                        for i in ids]).to(device)


def vlm_inputs(params, toks, text: int, grid, g) -> dict:
    """The VLM's ``embeds`` and ``position_ids`` for ``toks`` (B, S): text
    positions take the tokens' embedding rows, the image grid's patches
    seeded standard normal draws (the stub frontend), in the rows' dtype;
    (3, B, S) ids from :func:`grid_position_ids`, the rest of S text."""
    B, S = toks.shape
    rows, cols = grid
    emb = params["embed"][toks]
    emb[:, text:text + rows * cols] = torch.randn(
        (B, rows * cols, emb.shape[-1]), generator=g,
        device=g.device).to(emb.dtype).to(emb.device)
    pos = grid_position_ids(text, grid, S - text - rows * cols, toks.device)
    return {"embeds": emb, "position_ids": pos[:, None].expand(3, B, S)}


def stub_frames(cfg, device, batch: int, frames: int = WHISPER_FRAMES):
    """Whisper's stub frame embeddings: seeded standard normal (batch,
    frames, d_model) in the config's dtype (its 30 s window by default)."""
    g = torch.Generator(device=device)
    g.manual_seed(6)
    x = torch.randn((batch, frames, cfg.d_model), generator=g, device=device)
    return x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def free_card(device) -> None:
    """Hand the memory of the models dropped so far back to the card
    before the next model is drawn."""
    import gc
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def model_fields(cfg, params) -> dict:
    """A model's line fields: its config, parameters and weight bytes."""
    return {"model": cfg.name, "family": cfg.family,
            "config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                       "heads": [cfg.num_heads, cfg.num_kv_heads],
                       "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                       "vocab": cfg.vocab_size, "qkv_bias": cfg.qkv_bias,
                       "tie_embeddings": cfg.tie_embeddings,
                       "ssm_state": cfg.ssm_state,
                       "window": cfg.sliding_window, "dtype": cfg.dtype,
                       "kv_cache_dtype": cfg.kv_cache_dtype},
            "params": sum(p.numel() for p in params.parameters()),
            "param_count_analytic": cfg.param_count(),
            "weight_gb": sum(p.numel() * p.element_size()
                             for p in params.parameters()) / 1e9}


def lm_prompt(cfg, device, batch: int, prompt_len: int) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                         device=device)


def served(cfg, params, device, prompt, gen: int, **serve_kw):
    """``lm_decode.serve`` over ``prompt`` (prefilled a decode step at a
    time) and ``gen`` sampled tokens, after a short warm call (cuBLAS):
    the tokens and the line's fields (rates, peak memory since the warm
    call, launches and routes).  ``serve_kw`` (Whisper's ``frames``) goes
    to both calls."""
    from repro_torch.launch import lm_decode

    batch, prompt_len = prompt.shape
    lm_decode.serve(cfg, batch=batch, prompt_len=2, gen=2, seed=1,
                    device=device, params=params, **serve_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    toks, tps = lm_decode.serve(cfg, batch=batch, prompt_len=prompt_len,
                                gen=gen, seed=0, device=device, params=params,
                                prompt=prompt, **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = prompt_len + gen
    return toks, {"batch": batch, "prompt_len": prompt_len, "gen": gen,
                  "decode_steps": steps, "wall_s": wall,
                  "gen_tokens_per_s": tps, "gen_steps_per_s": tps / batch,
                  "steps_per_s": steps / wall,
                  "peak_memory_gb":
                      torch.cuda.max_memory_allocated(device) / 1e9,
                  "launches": read_launches(), "flash_routes": flash_routes(),
                  "scan_routes": scan_routes(),
                  "first_tokens": toks[0, :8].tolist()}


def scored(cfg, params, device, batch: int, seq_len: int):
    """``make_prefill_step`` over ``batch`` x ``seq_len`` seeded tokens: a
    warm pass, a timed one (its launches and routes) and a profiled one
    (device time by kernel).  Returns the log-probs and the fields."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_prefill_step

    step = make_prefill_step(cfg)
    args = ({"model": params}, prefill_batch(cfg, device, batch, seq_len,
                                             params))
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    lp = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fields = {"launches": read_launches(), "flash_routes": flash_routes(),
              "scan_routes": scan_routes()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    flash_us = sum(t for n, t, _ in rows if FLASH_MATCH in n)
    scan_us = sum(t for n, t, _ in rows if SCAN_MATCH in n)
    tokens = batch * seq_len
    # 2 FLOP a parameter and token: the MoEs' active parameters (the top-k
    # experts' share, not every expert's), Whisper's encoder parameters
    # over its frames
    enc = (sum(p.numel() for p in params["encoder"].parameters())
           if "encoder" in params else 0)
    model_flop = 2 * ((cfg.active_param_count() - enc) * tokens
                      + enc * math.prod(args[1]["frames"].shape[:2])
                      if enc else cfg.active_param_count() * tokens)
    fields.update(
        batch=batch, seq_len=seq_len, wall_s=wall, tokens_per_s=tokens / wall,
        peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        device_busy_us=busy, device_idle_share=1 - busy / (wall * 1e6),
        flash_us=flash_us, scan_us=scan_us,
        flash_share_of_busy=flash_us / busy, scan_share_of_busy=scan_us / busy,
        model_tflop=model_flop / 1e12,
        model_tflop_per_s_busy=model_flop / (busy * 1e-6) / 1e12,
        device_top=[{"name": k[:70], "device_us": t, "calls": c}
                    for k, t, c in rows[:8]],
        logprob_shape=list(lp.shape), finite=bool(torch.isfinite(lp).all()),
        mean_logprob=float(lp.mean()), max_logprob=float(lp.max()),
        uniform_logprob=-math.log(cfg.vocab_size))
    return lp, fields


def scored_ok(fields, batch: int, seq_len: int) -> bool:
    return (fields["logprob_shape"] == [batch, seq_len] and fields["finite"]
            and fields["max_logprob"] <= 0.0)


def lm_decode_phase(cfg, params, device):
    """``repro_torch.launch.lm_decode.serve`` at full width and depth:
    batch 8, 32 prompt tokens prefilled one decode step at a time, then 32
    sampled tokens; one rwkv6_scan launch per layer and step, all on the
    route ``ops.scan_route`` gives at T = 1, no flash (decode attends the
    window cache in plain torch, as JAX does).  Returns the launches and
    the scan's launches by route."""
    from repro_torch.kernels import ops

    smi = nvidia_smi()
    prompt = lm_prompt(cfg, device, DECODE_BATCH, DECODE_PROMPT)
    toks, run = served(cfg, params, device, prompt, DECODE_GEN)
    launches, routes = run["launches"], run["scan_routes"]
    n = HYMBA_LAYERS * run["decode_steps"]
    want = _only(launches, rwkv6_scan=n)
    want_routes = {r: n * (r == ops.scan_route(torch.bfloat16, 1))
                   for r in routes}
    emit("lm_decode", nvidia_smi=smi, **model_fields(cfg, params), **run)
    if launches != want or routes != want_routes:
        raise AssertionError(f"lm_decode launched {launches}, expected "
                             f"{want}; scan routes {routes}, expected "
                             f"{want_routes}")
    if tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_decode tokens {tuple(toks.shape)} out of "
                             "range")
    return launches, routes


def lm_prefill_phase(cfg, params, device):
    """``repro_torch.launch.steps.make_prefill_step`` at full width: 2 x
    4,096 tokens scored in one pass (past the 2,048 window, and 64 scan
    chunks of 64); exactly one flash launch (tensor-core route) and one
    scan launch (chunk route) per layer.  Returns the launches and the
    scan's launches by route."""
    smi = nvidia_smi()
    lp, f = scored(cfg, params, device, PREFILL_BATCH, PREFILL_LEN)
    emit("lm_prefill", nvidia_smi=smi, model=cfg.name,
         window=cfg.sliding_window, **f)
    launches, routes, s_routes = (f["launches"], f["flash_routes"],
                                  f["scan_routes"])
    want = _only(launches, flash_attention=HYMBA_LAYERS,
                 rwkv6_scan=HYMBA_LAYERS)
    # Hymba's bf16 heads of 64 take the tensor-core route, its bf16 SSM
    # scans over 4,096 steps the chunk route
    want_routes = {"wgmma": HYMBA_LAYERS, "simt": 0}
    want_scan = {"chunk": HYMBA_LAYERS, "recurrence": 0}
    if launches != want or routes != want_routes or s_routes != want_scan \
            or not f["flash_us"] > 0 or not f["scan_us"] > 0 \
            or not scored_ok(f, PREFILL_BATCH, PREFILL_LEN):
        raise AssertionError(f"lm_prefill: launches {launches} (expected "
                             f"{want}), routes {routes} (expected "
                             f"{want_routes}), scan routes {s_routes} "
                             f"(expected {want_scan}), flash device time "
                             f"{f['flash_us']} us, scan {f['scan_us']} us, "
                             f"log-probs {f['logprob_shape']}, finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return launches, s_routes


def scan_hold_phase(cfg, params, device) -> None:
    """Hymba's real decays through the chunk route.  During one full-width
    bf16 scoring pass (the ``lm_prefill`` batch), each layer's scan
    operands are captured by wrapping ``ops.rwkv6_scan`` as the model's
    layers see it (here only); on each
    layer's operands the chunk route is held against the step recurrence
    (``ref_rwkv6``), o as bf16 and the state as fp32 (``_held``, excess <=
    1), beside the smallest in-chunk decay product the layer saw (below
    1e-30 the JAX chunk form's clamp engages).  Then the same pass with
    ``ops.scan_route`` held at "recurrence": the mean |difference| of the
    two passes' log-probs is reported, not gated."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rwkv6
    from repro_torch.launch.steps import make_prefill_step

    from repro_torch.models import layers as model_layers

    step = make_prefill_step(cfg)
    args = ({"model": params}, prefill_batch(cfg, device))
    captured = []

    class CapturingOps:
        """``ops`` as the model's layers see it, with ``rwkv6_scan``
        wrapped: each call's operands are copied, then the wrapper runs
        (and counts its launch) as it would."""

        def __getattr__(self, name):
            return getattr(ops, name)

        @staticmethod
        def rwkv6_scan(r, k, v, w, u=None, state=None):
            captured.append(tuple(None if x is None else x.clone()
                                  for x in (r, k, v, w, u, state)))
            return ops.rwkv6_scan(r, k, v, w, u, state)

    reset_launches()
    model_layers.ops = CapturingOps()
    try:
        lp_chunk = step(*args)
    finally:
        model_layers.ops = ops
    routes = scan_routes()
    layers = []
    for r, k, v, w, u, s0 in captured:
        want_o, want_s = ref_rwkv6(r, k, v, w, u, s0)
        with forced_scan_route("chunk"):
            got_o, got_s = ops.rwkv6_scan(r, k, v, w, u, s0)
        logw = w.float().clamp(1e-8, 1.0).log()
        T = w.shape[1]
        pad = -T % ops.SCAN_CHUNK
        logw = torch.nn.functional.pad(logw, (0, 0, 0, 0, 0, pad))
        per_chunk = logw.reshape(w.shape[0], -1, ops.SCAN_CHUNK,
                                 *w.shape[2:]).sum(2)
        layers.append({
            "T": T, "dtype": str(r.dtype),
            "o_excess": _held(got_o, want_o, True)["excess"],
            "state_excess": _held(got_s, want_s, False)["excess"],
            "min_log10_chunk_decay": float(per_chunk.min()) / math.log(10)})
    del captured
    with forced_scan_route("recurrence"):
        lp_rec = step(*args)
    diff = (lp_chunk.float() - lp_rec.float()).abs()
    emit("scan_hold", model=cfg.name, layers=layers, scan_routes=routes,
         below_jax_clamp=sum(l["min_log10_chunk_decay"] < -30
                             for l in layers),
         logprob_mean_abs_diff_chunk_vs_recurrence=float(diff.mean()),
         logprob_max_abs_diff_chunk_vs_recurrence=float(diff.max()),
         tol=f"{BF16_RTOL:g} |want| + {BF16_ATOL_RMS:g} rms(want) (o), "
             f"{TOL:g} |want| + {TOL:g} rms(want) (state), entry by entry")
    bad = [i for i, l in enumerate(layers)
           if not (l["o_excess"] <= 1 and l["state_excess"] <= 1)]
    if len(layers) != HYMBA_LAYERS or bad \
            or routes != {"chunk": HYMBA_LAYERS, "recurrence": 0}:
        raise AssertionError(f"scan_hold: {len(layers)} layers captured, "
                             f"routes {routes}, layers over the check {bad}")


def decoding(cfg, params, device, cross=None, extra=None):
    """``(step, out)``: ``step()`` runs one full-width decode step at batch
    8 on a cache of DECODE_PROMPT + DECODE_GEN + 1 slots, 3 steps in
    already, and leaves its logits in ``out["logits"]``; Whisper's cache
    holds ``cross``, the VLM's steps are fed ``extra``."""
    from repro_torch.models import lm as LM

    cache = LM.init_cache(cfg, DECODE_BATCH, DECODE_PROMPT + DECODE_GEN + 1,
                          device=device)
    if cross is not None:
        cache["cross"] = cross
    tok = torch.zeros(DECODE_BATCH, 1, dtype=torch.int64, device=device)
    out = {}

    def step():
        with torch.no_grad():
            out["logits"], _ = LM.decode_step(params, cfg, tok, cache,
                                              **(extra or {}))

    for _ in range(3):
        step()
    return step, out


def lm_profile(cfg, params, device, phase: str = "lm_profile") -> None:
    """One full-width decode step at batch 8 (:func:`profile_step`), after
    a few steps into the cache (:func:`decoding`)."""
    step, out = decoding(cfg, params, device)
    profile_step(phase, step, model=cfg.name, batch=DECODE_BATCH)
    if not bool(torch.isfinite(out["logits"]).all()):
        raise AssertionError(f"{phase}: decode logits not finite")


# -- phase 11: the dense and RWKV6 families ---------------------------------------

def dense_decode_phase(cfg, params, device) -> tuple:
    """qwen2.5-32b whole (64 layers, bf16, 32.76 B seeded parameters) through
    ``lm_decode.serve``: batch 8, 32 prompt tokens prefilled a decode step
    at a time, 32 sampled; no kernel (single-token attention over the cache
    is ``_decode_attention``'s einsums, as in JAX).  Returns the launches
    and the run's whole token sequence (prompt and generated)."""
    smi = nvidia_smi()
    prompt = lm_prompt(cfg, device, DECODE_BATCH, DECODE_PROMPT)
    toks, run = served(cfg, params, device, prompt, DECODE_GEN)
    fields = model_fields(cfg, params)
    emit("dense_decode", nvidia_smi=smi, **fields, **run,
         step_bound_ms=fields["weight_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3)
    if run["launches"] != _only(run["launches"]):
        raise AssertionError(f"dense_decode launched {run['launches']}, "
                             "expected no kernel")
    if tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"dense_decode tokens {tuple(toks.shape)} out "
                             "of range")
    return run["launches"], torch.cat([prompt, toks], dim=1)


def cache_bytes(cache) -> int:
    """Bytes of a cache's K/V and int8 scales (not the stored positions)."""
    return sum(t.numel() * t.element_size()
               for name, t in cache["kv"].items() if name != "pos")


def teacher_forced_logprobs(cfg, params, seq) -> torch.Tensor:
    """Decode-step log-probs (B, S, V) along ``seq`` (B, S)."""
    from repro_torch.models import lm as LM

    cache = LM.init_cache(cfg, seq.shape[0], seq.shape[1] + 1,
                          device=seq.device)
    out = []
    with torch.no_grad():
        for t in range(seq.shape[1]):
            logits, cache = LM.decode_step(params, cfg, seq[:, t:t + 1],
                                           cache)
            out.append(torch.log_softmax(logits, -1))
    return torch.stack(out, 1)


def int8_drift(cfg, params, seq, steps: int) -> dict:
    """The int8 cache against the float one, teacher-forced along ``seq``'s
    first ``steps`` tokens: mean |d log p| and top-1 agreement (the bars of
    ``tests/test_serving.py:28-43``)."""
    import dataclasses

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ref = teacher_forced_logprobs(cfg, params, seq[:, :steps])
    quant = teacher_forced_logprobs(cfg8, params, seq[:, :steps])
    return {"mean_abs_dlogp": float((ref - quant).abs().mean()),
            "top1_agreement": float((ref.argmax(-1) == quant.argmax(-1))
                                    .float().mean()),
            "rows": int(ref.shape[0] * ref.shape[1])}


def dense_int8_phase(cfg, params, device, seq) -> dict:
    """The ``dense_decode`` run on an int8 KV cache
    (``kv_cache_dtype="int8"``): rates, the cache's bytes against bf16's,
    and the drift against the bf16 cache teacher-forced along the
    dense_decode run's 32 prompt tokens (reported, not gated: at full
    depth with random weights the top-1 margins are thin; the dense hold
    gates it)."""
    import dataclasses

    from repro_torch.models import lm as LM

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompt = seq[:, :DECODE_PROMPT]
    toks, run = served(cfg8, params, device, prompt, DECODE_GEN)
    max_len = DECODE_PROMPT + DECODE_GEN + 1
    nbytes = {c.kv_cache_dtype: cache_bytes(LM.init_cache(c, DECODE_BATCH,
                                                          max_len, device))
              for c in (cfg, cfg8)}
    drift = int8_drift(cfg, params, seq, DECODE_PROMPT)
    emit("dense_int8", nvidia_smi=nvidia_smi(), model=cfg.name, **run,
         cache_bytes=nbytes, cache_bytes_ratio=nbytes["int8"]
         / nbytes["bfloat16"], drift_vs_bf16_cache=drift, drift_gated=False,
         tokens_equal_bf16_run=bool(torch.equal(toks, seq[:, DECODE_PROMPT:])))
    if run["launches"] != _only(run["launches"]) \
            or tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN):
        raise AssertionError(f"dense_int8 launched {run['launches']}, "
                             f"expected no kernel; tokens {tuple(toks.shape)}")
    return run["launches"]


def dense_prefill_phase(cfg, params, device) -> dict:
    """qwen2.5-32b whole, ``make_prefill_step`` over 2 x 2,048 tokens:
    exactly one flash launch a layer (64), all on the tensor cores at head
    dim 128, causal, groups of 5; finite log-probs <= 0."""
    lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                   DENSE_PREFILL_LEN)
    L = cfg.num_layers
    emit("dense_prefill", nvidia_smi=nvidia_smi(), model=cfg.name, **f)
    if f["launches"] != _only(f["launches"], flash_attention=L) \
            or f["flash_routes"] != {"wgmma": L, "simt": 0} \
            or not f["flash_us"] > 0 \
            or not scored_ok(f, DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN):
        raise AssertionError(f"dense_prefill: launches {f['launches']}, "
                             f"routes {f['flash_routes']} (expected {L} on "
                             f"wgmma), log-probs {f['logprob_shape']}, finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return f["launches"]


def dense_cached_phase(cfg, params, device) -> dict:
    """The cached S > 1 branch of ``attention_sublayer`` at full width: per
    layer, 16 new tokens onto a 2,048-slot cache holding 1,024 (seeded K/V,
    positions 0-1,023), one flash launch each with ``q_offset`` 1,024 and
    ``kv_len`` 1,040 (read from the recorded call); the K/V and positions
    written to slots 1,024-1,039."""
    from repro_torch.models import lm as LM

    L, B, C = cfg.num_layers, DENSE_PREFILL_BATCH, CACHED_SLOTS
    N, S = CACHED_FILLED, CACHED_NEW
    dt = LM._dtype(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(5)
    cache = LM.init_cache(cfg, B, C, device=device)["kv"]
    for name in ("k", "v"):
        cache[name][:, :, :N] = torch.randn(cache[name][:, :, :N].shape,
                                            generator=g, device=device).to(dt)
    cache["pos"][:, :, :N] = torch.arange(N, dtype=torch.int32, device=device)
    h = torch.randn(B, S, cfg.d_model, generator=g, device=device).to(dt)
    positions = (N + torch.arange(S, device=device))[None].expand(B, S)
    before = collections.Counter(PATH_SHAPES["flash_attention"])
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.no_grad():
        for i in range(L):
            out, _ = LM.attention_sublayer(
                LM._layer(params["layers"], i)["attn"], h, cfg, positions,
                cache={k: t[i] for k, t in cache.items()}, cache_index=N)
    end.record()
    torch.cuda.synchronize()
    launches, routes = read_launches(), flash_routes()
    keys = PATH_SHAPES["flash_attention"] - before
    want_key = flash_key(B, S, C, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim, dt, True, 0, N, N + S)
    written = bool((cache["pos"][:, :, N:N + S] == positions[None]
                    .to(torch.int32)).all()
                   and (cache["pos"][:, :, N + S:] == -1).all()
                   and cache["k"][:, :, N:N + S].abs().sum() > 0)
    emit("dense_cached", model=cfg.name, batch=B, slots=C, filled=N,
         new_tokens=S, q_offset=N, kv_len=N + S, layers=L,
         kernel_keys={json.dumps(list(k)): n for k, n in keys.items()},
         launches=launches, flash_routes=routes,
         wall_ms_all_layers=start.elapsed_time(end),
         peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
         out_finite=bool(torch.isfinite(out).all()), cache_written=written)
    if launches != _only(launches, flash_attention=L) \
            or routes != {"wgmma": L, "simt": 0} \
            or dict(keys) != {want_key: L} or not written \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"dense_cached: launches {launches}, routes "
                             f"{routes}, flash keys {dict(keys)} (expected "
                             f"{want_key} x {L}), cache written {written}")
    return launches


def command_r_phase(device) -> dict:
    """command-r-35b whole (40 layers, d_model 8,192, tied embeddings, no
    QKV bias, GQA groups of 8): 8 decode steps at batch 8 (no kernel) and
    one 2 x 2,048 scoring pass with one tensor-core flash launch a layer
    (40).  The weights are freed after."""
    cfg = lm_config("command-r-35b")
    params = lm_params(cfg, device, seed=1)
    prompt = lm_prompt(cfg, device, DECODE_BATCH, COMMAND_R_PROMPT)
    toks, run = served(cfg, params, device, prompt, COMMAND_R_GEN)
    lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                   DENSE_PREFILL_LEN)
    L = cfg.num_layers
    emit("command_r", nvidia_smi=nvidia_smi(), **model_fields(cfg, params),
         decode=run, scoring=f)
    del params, lp
    free_card(device)
    if run["launches"] != _only(run["launches"]) \
            or f["launches"] != _only(f["launches"], flash_attention=L) \
            or f["flash_routes"] != {"wgmma": L, "simt": 0} \
            or not scored_ok(f, DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN):
        raise AssertionError(f"command_r: decode launched {run['launches']}, "
                             f"scoring {f['launches']}, routes "
                             f"{f['flash_routes']}, log-probs finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return f["launches"]


def dense_cut_phase(device) -> dict:
    """qwen2-72b and command-r-plus-104b at full width and 8 layers (their
    bf16 weights at full depth, 145 and 208 GB, do not fit the card): one
    2 x 2,048 scoring pass (one flash launch a layer, GQA groups of 8 and
    12 at d_model 8,192 and 12,288) and 4 decode steps each.  Returns the
    scoring passes' launches, summed."""
    total = {k: 0 for k in wrappers()}
    for arch in CUT_ARCHS:
        full = lm_config(arch)
        cfg = lm_config(arch, num_layers=CUT_LAYERS)
        params = lm_params(cfg, device, seed=2)
        prompt = lm_prompt(cfg, device, DECODE_BATCH, CUT_PROMPT)
        toks, run = served(cfg, params, device, prompt, CUT_GEN)
        lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                       DENSE_PREFILL_LEN)
        emit("dense_cut", nvidia_smi=nvidia_smi(),
             **model_fields(cfg, params),
             reduced=f"{CUT_LAYERS} of {full.num_layers} layers (full depth "
                     f"{full.param_count() / 1e9:.1f} B parameters, "
                     f"{2 * full.param_count() / 1e9:.0f} GB in bf16)",
             decode=run, scoring=f)
        del params, lp
        free_card(device)
        if run["launches"] != _only(run["launches"]) \
                or f["launches"] != _only(f["launches"],
                                          flash_attention=CUT_LAYERS) \
                or f["flash_routes"] != {"wgmma": CUT_LAYERS, "simt": 0} \
                or not scored_ok(f, DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN):
            raise AssertionError(f"dense_cut {arch}: decode launched "
                                 f"{run['launches']}, scoring "
                                 f"{f['launches']}, routes "
                                 f"{f['flash_routes']}")
        _add(total, f["launches"])
    return total


def rwkv_decode_phase(cfg, params, device) -> tuple:
    """rwkv6-1.6b whole (24 layers, d_model 2,048, 32 heads of 64) through
    ``lm_decode.serve``: batch 8, 32 + 32 tokens; exactly one scan launch a
    layer and step (24), all on the recurrence route, with the bonus ``u``
    and the carried state; no flash."""
    smi = nvidia_smi()
    prompt = lm_prompt(cfg, device, DECODE_BATCH, DECODE_PROMPT)
    before = collections.Counter(PATH_SHAPES["rwkv6_scan"])
    toks, run = served(cfg, params, device, prompt, DECODE_GEN)
    keys = set(PATH_SHAPES["rwkv6_scan"] - before)
    n = cfg.num_layers * run["decode_steps"]
    emit("rwkv_decode", nvidia_smi=smi, **model_fields(cfg, params), **run,
         kernel_keys=sorted(keys))
    H, D = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    want_key = scan_key(DECODE_BATCH, 1, H, D, D, torch.bfloat16, True, True)
    if run["launches"] != _only(run["launches"], rwkv6_scan=n) \
            or run["scan_routes"] != {"chunk": 0, "recurrence": n} \
            or keys != {want_key} \
            or tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN):
        raise AssertionError(f"rwkv_decode launched {run['launches']}, "
                             f"routes {run['scan_routes']} (expected {n} "
                             f"recurrence), scan keys {keys}")
    return run["launches"], run["scan_routes"]


def rwkv_prefill_phase(cfg, params, device) -> tuple:
    """rwkv6-1.6b whole, ``make_prefill_step`` over 2 x 4,096 tokens:
    exactly one scan launch a layer (24), all on the chunk route and all
    with ``u``; finite log-probs <= 0."""
    before = collections.Counter(PATH_SHAPES["rwkv6_scan"])
    lp, f = scored(cfg, params, device, PREFILL_BATCH, RWKV_PREFILL_LEN)
    keys = set(PATH_SHAPES["rwkv6_scan"] - before)
    L = cfg.num_layers
    emit("rwkv_prefill", nvidia_smi=nvidia_smi(), model=cfg.name, **f,
         kernel_keys=sorted(keys))
    H, D = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    want_key = scan_key(PREFILL_BATCH, RWKV_PREFILL_LEN, H, D, D,
                        torch.bfloat16, True, False)
    if f["launches"] != _only(f["launches"], rwkv6_scan=L) \
            or f["scan_routes"] != {"chunk": L, "recurrence": 0} \
            or keys != {want_key} or not f["scan_us"] > 0 \
            or not scored_ok(f, PREFILL_BATCH, RWKV_PREFILL_LEN):
        raise AssertionError(f"rwkv_prefill: launches {f['launches']}, "
                             f"routes {f['scan_routes']} (expected {L} "
                             f"chunk), scan keys {keys}, log-probs finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return f["launches"], f["scan_routes"]


# -- phase 12: the VLM, MoE and Whisper families -----------------------------

def decode_idle(cfg, params, device, cross=None, extra=None) -> dict:
    """One full-width decode step at batch 8 a few steps into the cache
    (:func:`decoding`, :func:`profiled_step`): the phase line's fields of
    its wall, device busy, idle share, kernels and host top."""
    f = profiled_step(decoding(cfg, params, device, cross, extra)[0])
    return {"device_idle_share": f["device_idle_share"],
            "step_wall_us": f["wall_us"], "step_busy_us": f["device_busy_us"],
            "step_kernels": f["device_kernels"],
            "step_host_top": f["host_top"][:6]}


def vlm_decode_phase(cfg, params, device) -> dict:
    """qwen2-vl-72b at full width (VLM_LAYERS layers) through
    ``make_serve_step`` with its extras: batch 8, a prompt of
    VLM_PROMPT_TEXT text tokens and a VLM_PROMPT_GRID image grid (32
    positions, t / h / w apart), then DECODE_GEN greedy steps, each fed
    the chosen token's embedding row and the next position after the grid
    (t = h = w); no kernel (single-token attention in plain torch).  The
    cache's stored positions are the temporal ids."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm as LM

    smi = nvidia_smi()
    g = torch.Generator(device=device)
    g.manual_seed(7)
    B, G = DECODE_BATCH, DECODE_GEN
    P = VLM_PROMPT_TEXT + VLM_PROMPT_GRID[0] * VLM_PROMPT_GRID[1]
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                         device=device)
    prompt = vlm_inputs(params, toks, VLM_PROMPT_TEXT, VLM_PROMPT_GRID, g)
    start = int(prompt["position_ids"].max()) + 1
    pos = torch.cat([prompt["position_ids"],
                     (start + torch.arange(G, device=device))[None, None]
                     .expand(3, B, G)], dim=2)
    step = make_serve_step(cfg)

    def run(n_prompt, n_gen):
        cache = LM.init_cache(cfg, B, n_prompt + n_gen + 8, device=device)
        out = []
        for t in range(n_prompt + n_gen):
            if t < n_prompt:
                tok, emb = toks[:, t:t + 1], prompt["embeds"][:, t:t + 1]
            else:
                tok = nxt[:, None].long()
                out.append(tok)
                emb = params["embed"][tok]
            nxt, logits, cache = step({"model": params}, tok, cache, {
                "embeds": emb, "position_ids": pos[:, :, t:t + 1]})
        return torch.cat(out, dim=1), logits, cache

    run(2, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    gen, logits, cache = run(P, G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    fields = model_fields(cfg, params)
    stored = cache["kv"]["pos"][:, :, :P + G]
    pos_ok = bool((stored == pos[0].to(torch.int32)[None]).all())
    idle = decode_idle(cfg, params, device, extra={
        "embeds": params["embed"][gen[:, -1:]],
        "position_ids": pos[:, :, -1:]})
    emit("vlm_decode", nvidia_smi=smi, **fields,
         reduced=f"{VLM_LAYERS} of 80 layers (full depth "
                 f"{lm_config(VLM_ARCH).param_count() / 1e9:.1f} B "
                 "parameters, 146 GB in bf16)",
         batch=B, prompt=P, prompt_grid=list(VLM_PROMPT_GRID), gen=G,
         decode_steps=P + G, wall_s=wall, steps_per_s=(P + G) / wall,
         gen_tokens_per_s=B * G / wall,
         peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
         launches=launches, flash_routes=flash_routes(),
         cache_positions_temporal=pos_ok, first_tokens=gen[0, :8].tolist(),
         step_bound_ms=fields["weight_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3,
         **idle)
    if launches != _only(launches) or not pos_ok \
            or tuple(gen.shape) != (B, G) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"vlm_decode launched {launches} (expected no "
                             f"kernel), cache positions temporal {pos_ok}, "
                             f"tokens {tuple(gen.shape)}")
    return launches


def vlm_prefill_phase(cfg, params, device) -> dict:
    """The VLM's 2 x 2,048 scoring pass from embeddings: VLM_SCORE_TEXT
    text tokens, a VLM_SCORE_GRID image grid, text; one tensor-core flash
    launch a layer (64/8 heads of 128, causal)."""
    lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                   DENSE_PREFILL_LEN)
    L = cfg.num_layers
    emit("vlm_prefill", nvidia_smi=nvidia_smi(), model=cfg.name,
         grid=list(VLM_SCORE_GRID), text_before=VLM_SCORE_TEXT, **f)
    if f["launches"] != _only(f["launches"], flash_attention=L) \
            or f["flash_routes"] != {"wgmma": L, "simt": 0} \
            or not scored_ok(f, DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN):
        raise AssertionError(f"vlm_prefill: launches {f['launches']}, "
                             f"routes {f['flash_routes']}, log-probs finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return f["launches"]


@contextlib.contextmanager
def recorded_routes(routes: dict):
    """``models.moe.moe_route`` wrapped for the block (here only): each
    call's expert selections and kept mask, copied to the CPU (a host
    read a call), and its groups and capacity, appended to ``routes``
    under the device type of its input."""
    from repro_torch.models import moe

    real = moe.moe_route

    def recording(p, x, cfg, group_size):
        r = real(p, x, cfg, group_size)
        routes.setdefault(x.device.type, []).append(
            {"experts": r["experts"].cpu(), "keep": r["keep"].cpu(),
             "groups": r["groups"], "capacity": r["capacity"]})
        return r

    moe.moe_route = recording
    try:
        yield
    finally:
        moe.moe_route = real


def moe_drops(fn) -> dict:
    """Run ``fn`` with its routes recorded (:func:`recorded_routes`; on the
    card, apart from any timed run): the (token, slot) pairs routed and
    those kept within the capacity over every call, the (groups,
    capacity) of the calls, and with one layer's pairs per call at most
    64 calls, each call's dropped share (a scoring pass: by layer)."""
    routes: dict = {}
    with recorded_routes(routes):
        fn()
    calls = [r for device_calls in routes.values() for r in device_calls]
    pairs = sum(r["keep"].numel() for r in calls)
    kept = sum(int(r["keep"].sum()) for r in calls)
    shapes = collections.Counter((r["groups"], r["capacity"],
                                  r["keep"].numel()) for r in calls)
    out = {"pairs": pairs, "kept": kept, "dropped_share": 1 - kept / pairs,
           "calls": [{"groups": g, "capacity": c, "pairs": n, "calls": m}
                     for (g, c, n), m in sorted(shapes.items())]}
    if len(calls) <= 64:
        out["dropped_share_by_call"] = [
            round(1 - int(r["keep"].sum()) / r["keep"].numel(), 4)
            for r in calls]
    return out


def moe_phases(arch: str, device, prompt_len: int, gen: int, seed: int,
               phases: tuple) -> dict:
    """An MoE model whole: ``lm_decode.serve`` at batch 8 over
    ``prompt_len`` + ``gen`` tokens (capacity 1 a layer and step: no
    kernel) and a 2 x 2,048 scoring pass (groups of 512, one tensor-core
    flash launch a layer); the share of (token, slot) pairs the capacity
    drops in MOE_DROP_STEPS decode steps and in a pass, each instrumented
    apart from the timed runs; one decode step's idle share.  ``phases``:
    the decode and scoring lines' names, or one name for a line holding
    both.  The weights are freed after.  Returns the scoring launches."""
    from repro_torch.launch import lm_decode
    from repro_torch.launch.steps import make_prefill_step

    smi = nvidia_smi()
    cfg = lm_config(arch)
    params = lm_params(cfg, device, seed=seed)
    fields = dict(model_fields(cfg, params),
                  experts=[cfg.num_experts, cfg.padded_experts],
                  top_k=cfg.num_experts_per_tok, moe_d_ff=cfg.moe_d_ff,
                  shared_d_ff=cfg.shared_d_ff,
                  active_params=cfg.active_param_count())
    prompt = lm_prompt(cfg, device, DECODE_BATCH, prompt_len)
    toks, run = served(cfg, params, device, prompt, gen)
    run["drops"] = moe_drops(lambda: lm_decode.serve(
        cfg, batch=DECODE_BATCH, prompt_len=MOE_DROP_STEPS // 2,
        gen=MOE_DROP_STEPS // 2, seed=1, device=device, params=params))
    run.update(decode_idle(cfg, params, device),
               step_bound_ms=fields["weight_gb"] * 1e9 / HBM_BYTES_PER_S
               * 1e3)
    lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                   DENSE_PREFILL_LEN)
    f["drops"] = moe_drops(lambda: make_prefill_step(cfg)(
        {"model": params}, prefill_batch(cfg, device, DENSE_PREFILL_BATCH,
                                         DENSE_PREFILL_LEN)))
    del params, lp
    free_card(device)
    if len(phases) == 2:
        emit(phases[0], nvidia_smi=smi, **fields, **run)
        emit(phases[1], nvidia_smi=smi, model=cfg.name, **f)
    else:
        emit(phases[0], nvidia_smi=smi, **fields, decode=run, scoring=f)
    L = cfg.num_layers
    want_caps = {(1, 1), (DENSE_PREFILL_BATCH * DENSE_PREFILL_LEN // 512,
                          int(cfg.num_experts_per_tok * 512
                              / cfg.padded_experts * cfg.capacity_factor))}
    caps = {(c["groups"], c["capacity"]) for c in
            run["drops"]["calls"] + f["drops"]["calls"]}
    if run["launches"] != _only(run["launches"]) \
            or tuple(toks.shape) != (DECODE_BATCH, gen) \
            or f["launches"] != _only(f["launches"], flash_attention=L) \
            or f["flash_routes"] != {"wgmma": L, "simt": 0} \
            or caps != want_caps \
            or not scored_ok(f, DENSE_PREFILL_BATCH, DENSE_PREFILL_LEN):
        raise AssertionError(f"{arch}: decode launched {run['launches']}, "
                             f"scoring {f['launches']}, routes "
                             f"{f['flash_routes']}, (groups, capacity) "
                             f"{caps} (expected {want_caps}), log-probs "
                             f"finite {f['finite']}, max {f['max_logprob']}")
    return f["launches"]


def encdec_phases(device) -> tuple:
    """whisper-medium whole over seeded (8, WHISPER_FRAMES, 1,024) bf16
    stub frames: ``build_cross_cache`` timed (a warm call first; 24 causal
    encoder launches), ``lm_decode.serve`` at batch 8 over DECODE_PROMPT +
    DECODE_GEN tokens on those frames (the encoder's 24 launches, then 24
    cross-attention launches a step: one query over the 1,500 keys,
    non-causal), one decode step's idle share; a 2 x WHISPER_SCORE_LEN
    scoring pass over 2 x WHISPER_FRAMES frames (24 encoder, 24 decoder
    self- and 24 cross-attention launches).  All on the tensor cores.
    Returns the decode and scoring launches."""
    from repro_torch.models import lm as LM

    smi = nvidia_smi()
    cfg = lm_config(WHISPER_ARCH)
    params = lm_params(cfg, device, seed=4)
    fields = model_fields(cfg, params)
    frames = stub_frames(cfg, device, DECODE_BATCH)
    with torch.no_grad():
        LM.build_cross_cache(params, cfg, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cross = LM.build_cross_cache(params, cfg, frames)
        torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0
    cross_gb = sum(t.numel() * t.element_size() for t in cross.values()) / 1e9
    prompt = lm_prompt(cfg, device, DECODE_BATCH, DECODE_PROMPT)
    before = collections.Counter(PATH_SHAPES["flash_attention"])
    toks, run = served(cfg, params, device, prompt, DECODE_GEN,
                       frames=frames)
    idle = decode_idle(cfg, params, device, cross=cross)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    n = cfg.encoder_layers + L * run["decode_steps"]
    emit("encdec_decode", nvidia_smi=smi, **fields,
         encoder_layers=cfg.encoder_layers, frames=WHISPER_FRAMES,
         build_cross_cache_s=cross_s, cross_cache_gb=cross_gb, **run,
         **idle, step_bound_ms=(fields["weight_gb"] + cross_gb) * 1e9
         / HBM_BYTES_PER_S * 1e3)
    del cross
    lp, f = scored(cfg, params, device, DENSE_PREFILL_BATCH,
                   WHISPER_SCORE_LEN)
    keys = PATH_SHAPES["flash_attention"] - before
    emit("encdec_prefill", nvidia_smi=nvidia_smi(), model=cfg.name,
         frames=WHISPER_FRAMES, **f,
         kernel_keys={json.dumps(list(k)): c for k, c in keys.items()})
    del params, lp
    free_card(device)
    m = 3 * L
    if run["launches"] != _only(run["launches"], flash_attention=n) \
            or run["flash_routes"] != {"wgmma": n, "simt": 0} \
            or tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN) \
            or f["launches"] != _only(f["launches"], flash_attention=m) \
            or f["flash_routes"] != {"wgmma": m, "simt": 0} \
            or not scored_ok(f, DENSE_PREFILL_BATCH, WHISPER_SCORE_LEN):
        raise AssertionError(f"encdec: decode launched {run['launches']} "
                             f"(expected {n} flash), routes "
                             f"{run['flash_routes']}; scoring "
                             f"{f['launches']} (expected {m}), routes "
                             f"{f['flash_routes']}, log-probs finite "
                             f"{f['finite']}, max {f['max_logprob']}")
    return run["launches"], f["launches"]


def params_on(tree, device):
    """A copy of a ParamTree on ``device``."""
    from repro_torch.nn.core import ParamTree

    def copy(t):
        return {k: copy(t[k]) if isinstance(t[k], ParamTree)
                else t[k].detach().to(device) for k in t}
    return ParamTree(copy(tree))


def lm_family_hold(phase: str, cfg, device, *, tokens: int = LM_HOLD_TOKENS,
                   steps: int = LM_HOLD_STEPS, int8_steps: int = 0) -> None:
    """A 2-layer full-width model in fp32 (TF32 off): the weights drawn on
    the card and copied to the CPU, so the card runs the kernels and the
    CPU their plain versions on the same values.  A ``tokens``-long
    scoring pass, log-probs within 1e-3; ``steps`` greedy decode steps from
    the CPU's tokens, logits within 1e-3 and the same argmax except where
    the CPU's top two lie within TIE_GAP; then the carried state (rwkv:
    shifts and wkv; hybrid: the SSM state) and the K/V cache within 1e-3,
    its stored positions equal.  The VLM scores and decodes from
    embeddings at M-RoPE ids with t / h / w apart (text, an image grid,
    text; each decode step the chosen token's embedding row); Whisper
    encodes WHISPER_FRAMES seeded frames for the pass and builds each
    device's cross cache from them for decode (compared too); the MoE's
    expert selections and kept masks must be equal on both devices in
    every call.  With ``int8_steps``, the first that many of those tokens
    on the card over an int8 cache and over the float one: mean |d log p|
    between them under INT8_DRIFT (gated), top-1 agreement reported
    (:func:`int8_drift`)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import lm as LM

    cpu = torch.device("cpu")
    torch.cuda.reset_peak_memory_stats(device)
    p_g = lm_params(cfg, device, seed=3)
    p_c = params_on(p_g, cpu)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, tokens), generator=g)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        batch = dict(vlm_inputs(p_c, toks, 8, (8, 8), g),
                     targets=batch["targets"])
    elif cfg.family == "encdec":
        batch["frames"] = torch.randn((1, WHISPER_FRAMES, cfg.d_model),
                                      generator=g)
    step = make_prefill_step(cfg)
    routes: dict = {}
    reset_launches()
    with recorded_routes(routes):
        lp_c = step({"model": p_c}, batch)
        lp_g = step({"model": p_g}, {k: t.to(device)
                                     for k, t in batch.items()})
    score_launches = read_launches()
    score_err = float((lp_g.cpu() - lp_c).abs().max())

    B = 2
    cache_c = LM.init_cache(cfg, B, steps + 1, device=cpu)
    cache_g = LM.init_cache(cfg, B, steps + 1, device=device)
    if cfg.family == "encdec":
        frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=g)
        with torch.no_grad():
            cache_c["cross"] = LM.build_cross_cache(p_c, cfg, frames)
            cache_g["cross"] = LM.build_cross_cache(p_g, cfg,
                                                    frames.to(device))
    pos = grid_position_ids(2, (2, 3), steps - 8, cpu)[:, None].expand(
        3, B, steps)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    fed = []
    logit_err, mismatched, near_ties = 0.0, 0, 0
    reset_launches()
    with torch.no_grad(), recorded_routes(routes):
        for t in range(steps):
            fed.append(tok)
            extra = {}
            if cfg.family == "vlm":
                extra = {"embeds": p_c["embed"][tok],
                         "position_ids": pos[:, :, t:t + 1]}
            l_c, cache_c = LM.decode_step(p_c, cfg, tok, cache_c, **extra)
            l_g, cache_g = LM.decode_step(
                p_g, cfg, tok.to(device), cache_g,
                **{k: v.to(device) for k, v in extra.items()})
            l_g = l_g.cpu()
            logit_err = max(logit_err, float((l_g - l_c).abs().max()))
            top2 = torch.topk(l_c, 2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) < TIE_GAP
            differ = torch.argmax(l_g, -1) != torch.argmax(l_c, -1)
            mismatched += int((differ & ~tie).sum())
            near_ties += int(tie.sum())
            tok = torch.argmax(l_c, -1)[:, None]
    decode_launches = read_launches()
    states = {"rwkv": ("shift", "cm_shift", "wkv"), "dense": ("kv",),
              "vlm": ("kv",), "moe": ("kv",), "encdec": ("kv", "cross"),
              "hybrid": ("ssm", "kv")}[cfg.family]
    kv_of = {"kv": lambda c: c["kv"], "cross": lambda c: c["cross"]}
    flat = lambda c, n: (c[n] if n not in kv_of else torch.cat(
        [kv_of[n](c)["k"].flatten(), kv_of[n](c)["v"].flatten()]))
    state_err = {n: float((flat(cache_g, n).cpu().float()
                           - flat(cache_c, n).float()).abs().max())
                 for n in states}
    pos_equal = "kv" not in states or torch.equal(
        cache_g["kv"]["pos"].cpu(), cache_c["kv"]["pos"])
    fields = {}
    if int8_steps:
        fields["int8"] = dict(int8_drift(cfg, p_g, torch.cat(fed, 1).to(
            device), int8_steps), bar=INT8_DRIFT, top1_gated=False)
    routes_equal = None
    if cfg.family == "moe":
        pairs = list(zip(routes.get("cpu", []), routes.get("cuda", [])))
        routes_equal = len(pairs) == len(routes.get("cpu", [])) == len(
            routes.get("cuda", [])) > 0 and all(
            torch.equal(a[n], b[n]) for a, b in pairs
            for n in ("experts", "keep"))
        fields["routes"] = {"calls": len(pairs), "equal": routes_equal,
                            "dropped_share_cpu": 1 - sum(
                                int(r["keep"].sum()) for r in routes["cpu"])
                            / sum(r["keep"].numel() for r in routes["cpu"])}
    emit(phase, model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         tf32=torch.backends.cuda.matmul.allow_tf32, plain_on="cpu",
         window=cfg.sliding_window,
         score_tokens=tokens, score_max_abs_err=score_err,
         score_launches=score_launches, decode_steps=steps, batch=B,
         decode_launches=decode_launches, logits_max_abs_err=logit_err,
         argmax_mismatches=mismatched, near_ties=near_ties,
         state_max_abs_err=state_err, cache_positions_equal=pos_equal,
         tol=HOLD_TOL,
         peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
         **fields)
    del p_g, cache_g
    free_card(device)
    if not (score_err <= HOLD_TOL and logit_err <= HOLD_TOL
            and mismatched == 0 and max(state_err.values()) <= HOLD_TOL
            and pos_equal and routes_equal is not False) \
            or ("int8" in fields
                and not fields["int8"]["mean_abs_dlogp"] < INT8_DRIFT):
        raise AssertionError(f"{phase}: scoring error {score_err}, logits "
                             f"error {logit_err}, {mismatched} argmax "
                             f"mismatches, state errors {state_err}, "
                             f"positions equal {pos_equal}, routes equal "
                             f"{routes_equal}, int8 {fields.get('int8')}")


def _seed_loops(name: str, device):
    """A factory of ``name``'s loops at full width on one env: ``make(plan,
    seed)`` builds a TrainLoop whose policy is drawn from ``seed`` and
    whose seed plan draws seed s's from ``seed_of(seed, s)``, as
    ``run_recipe`` does."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop

    rec = recipes.get_train(name)
    env = rec.make_env()
    env_params = env.init(device)

    def make(plan, seed):
        pol = rec.make_policy(env, seed=seed, device=device,
                              requires_grad=True)
        return TrainLoop(env, env_params, pol,
                         rec.make_config(env, rec.num_envs, PLAN_ITERS),
                         plan=plan, seed_params=lambda sd: rec.make_policy(
                             env, seed=sd, device=device).params.flat())
    return make


def _within(got: torch.Tensor, want: torch.Tensor, tol) -> dict:
    """``got`` against ``want`` at (rtol, atol): the largest error over
    its allowance (pass <= 1), the largest absolute error, bitwise."""
    rtol, atol = tol
    err = (got - want).abs()
    return {"excess": float((err / (atol + rtol * want.abs())).max()),
            "max_abs_err": float(err.max()),
            "bitwise": bool(torch.equal(got, want))}


def plan_vmap_seeds_phase(device) -> dict:
    """``vmap_seeds`` at full width: each recipe of PLAN_SEEDS with its S
    seeds through ``run_recipe(plan="vmap_seeds")``, PLAN_ITERS captured
    iterations whose every iteration launches each kernel as often as the
    single plan's (one launch a call site for all S seeds, held exactly),
    the folded shapes recorded for ``path_shapes``; the single plan at the
    same S x B rows for its it/s; then, in scan mode from one env, seeds 0
    and S - 1 held per iteration against the single runs of their seeds
    (losses and log Z at PLAN_LOSS_TOL, mean log-rewards at
    PLAN_REWARD_TOL).  Returns the vmapped runs' launches."""
    from repro_torch.algo.plan import VmapSeedsPlan, seed_of

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, S in PLAN_SEEDS.items():
        per_iter = PLAN_LAUNCHES_PER_ITER[name]
        with recording_folded_shapes():
            fields, launches = counted_run(name, PLAN_ITERS, per_iter,
                                           device, plan="vmap_seeds",
                                           num_seeds=S)
        _add(total, launches)
        B = fields["num_envs"]
        single, _ = counted_run(name, PLAN_ITERS, per_iter, device,
                                num_envs=S * B)
        make = _seed_loops(name, device)
        _, (m, _) = make(VmapSeedsPlan(S), 0).run(0, PLAN_ITERS,
                                                  mode="scan")
        holds = {}
        for s in (0, S - 1):
            sd = seed_of(0, s)
            _, (m1, _) = make(None, sd).run(sd, PLAN_ITERS, mode="scan")
            holds[s] = {k: _within(m[k][:, s], m1[k],
                                   PLAN_REWARD_TOL if k == "mean_log_reward"
                                   else PLAN_LOSS_TOL) for k in m1}
        ok = all(h["excess"] <= 1 for hs in holds.values()
                 for h in hs.values())
        emit("plan_vmap_seeds", nvidia_smi=smi, recipe=name, seeds=S,
             num_envs_per_seed=B,
             captured_iterations_per_s=fields["steady_iterations_per_s"],
             seed_iterations_per_s=S * fields["steady_iterations_per_s"],
             single_same_rows={"num_envs": S * B,
                               "captured_iterations_per_s":
                               single["steady_iterations_per_s"]},
             vmapped_over_single=fields["steady_iterations_per_s"]
             / single["steady_iterations_per_s"],
             held_seeds=holds, **{k: v for k, v in fields.items()
                                  if k != "num_envs"})
        if not ok:
            raise AssertionError(f"{name}: vmap_seeds seeds differ from "
                                 f"their single runs: {holds}")
    return total


def _leaves_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def plan_data_parallel_phase(device) -> dict:
    """``data_parallel(1)`` over NCCL (a group of one on the card, its
    all-reduce captured inside the iteration's CUDA graph) against the
    single plan: each run of PLAN_DP_RUNS for PLAN_DP_ITERS iterations
    through ``run_recipe``, every loss, log Z and mean log-reward row,
    trained leaf and buffer leaf bitwise equal; each replay's launches
    the single plan's; one all-reduce an iteration, captured.  ``auto`` on
    one card resolves to single.  Returns the data-parallel runs'
    launches."""
    import torch.distributed as dist

    from repro_torch.algo.plan import make_plan
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    reduces = {"captured": 0, "eager": 0}
    real = dist.all_reduce

    def counting(*args, **kwargs):
        key = ("captured" if torch.cuda.is_current_stream_capturing()
               else "eager")
        reduces[key] += 1
        return real(*args, **kwargs)

    def run(name, **kw):
        reset_launches()
        out = run_recipe(name, iterations=PLAN_DP_ITERS, seed=0,
                         device=device, eval_every=0, log=lambda *_: None,
                         **PLAN_DP_RUNS[name], **kw)
        torch.cuda.synchronize()
        hist = out["history"]
        rate = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"])
        return out, run_launches(read_launches(), out["loop"].captured), rate

    for name in PLAN_DP_RUNS:
        one, _, rate1 = run(name)
        dist.all_reduce = counting
        try:
            dp, launches, rate = run(name, plan="data_parallel", devices=1)
        finally:
            dist.all_reduce = real
            dp["loop"].plan.close()
        _add(total, launches)
        rows = all(a[k] == b[k] for a, b in zip(one["history"],
                                                dp["history"])
                   for k in ("loss", "log_z", "mean_log_reward"))
        leaves = _leaves_equal(one["loop"].trained(one["state"]),
                               dp["loop"].trained(dp["state"]))
        buf1, buf = one["state"].sampler, dp["state"].sampler
        buffers = buf1 is None and buf is None or (
            _leaves_equal(buf1.data, buf.data)
            and torch.equal(buf1.size, buf.size)
            and torch.equal(buf1.insert_pos, buf.insert_pos))
        c1, c = one["loop"].captured, dp["loop"].captured
        emit("plan_data_parallel", nvidia_smi=smi, recipe=name,
             sampler=PLAN_DP_RUNS[name].get("sampler", "on_policy"),
             plan=dp["loop"].plan.describe(), backend="nccl",
             iterations=PLAN_DP_ITERS, rows_bitwise=rows,
             leaves_bitwise=leaves, buffers_bitwise=buffers,
             all_reduces=dict(reduces), replays=c.replays,
             graph_launches=c.launches, launches=launches,
             captured_iterations_per_s=rate,
             single_captured_iterations_per_s=rate1)
        if not (rows and leaves and buffers) or c.launches != c1.launches \
                or reduces["captured"] != 1 or c.replays != PLAN_DP_ITERS - 1:
            raise AssertionError(f"{name}: data_parallel(1) is not the "
                                 f"single plan: rows {rows}, leaves "
                                 f"{leaves}, buffers {buffers}, launches "
                                 f"{c.launches} / {c1.launches}, "
                                 f"all-reduces {reduces}")
        reduces.update(captured=0, eager=0)
    auto = make_plan("auto", num_envs=16)
    emit("plan_data_parallel", auto=auto.describe(),
         visible=torch.cuda.device_count())
    if auto.name != "single":
        raise AssertionError(f"auto on one card resolved to {auto}")
    return total


def plan_serve_phase(device) -> dict:
    """The serve phase's requests through ``Scheduler(plan="data_parallel",
    devices=["cuda", "cuda:0"])`` against the single pool: every
    sample and log-reward bitwise, the pool cut into shards of
    SERVE_LANES / PLAN_SERVE_SHARDS lanes, each stepping with its own
    ``decode_step`` launch at that lane count (recorded for
    ``path_shapes``).  Returns the sharded pool's launches."""
    import numpy as np

    from repro_torch.serve import SampleRequest, Scheduler

    smi = nvidia_smi()
    reqs = [SampleRequest(env="bitseq", num_samples=16, seed=1),
            SampleRequest(env="bitseq", num_samples=64, seed=2,
                          logit_temp=0.8),
            SampleRequest(env="bitseq", num_samples=7, seed=3,
                          reward_beta=2.0),
            SampleRequest(env="bitseq", num_samples=200, seed=4,
                          logit_temp=0.8, reward_beta=2.0)]
    out = {}
    # the card spelled two ways: every shard shares the engine's policy
    devices = ["cuda"] + [device] * (PLAN_SERVE_SHARDS - 1)
    for kind, kw in (("single", {}), ("sharded", {
            "plan": "data_parallel", "devices": devices})):
        sched = Scheduler(num_lanes=SERVE_LANES, init_seed=0, device=device,
                          **kw)
        sched.submit(SampleRequest(env="bitseq", num_samples=SERVE_LANES,
                                   seed=1000))
        sched.run()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rids = [sched.submit(r) for r in reqs]
        res = sched.run()
        torch.cuda.synchronize()
        out[kind] = ([res[r] for r in rids], time.perf_counter() - t0,
                     read_launches(), sched.engine_for(reqs[0]))
    (want, wall1, launches1, _), (got, wall, launches, eng) = \
        out["single"], out["sharded"]
    same = all(np.array_equal(a.samples, b.samples)
               and np.array_equal(a.log_rewards, b.log_rewards)
               for a, b in zip(want, got))
    n = sum(r.num_samples for r in reqs)
    shard_lanes = [lane.t.shape[0] for lane in eng.lanes]
    shared = all(p is eng.policy and q is eng.inner_params
                 for _, p, q in eng._shard_ctx)
    emit("plan_serve", nvidia_smi=smi, env="bitseq n=120 k=8 (A=3840)",
         lanes=eng.num_lanes, shard_lanes=shard_lanes,
         plan=eng.plan.describe(), devices=[str(d) for d in devices],
         shared_policy=shared, samples=n, bitwise=same,
         samples_per_s=n / wall, single_samples_per_s=n / wall1,
         launches=launches, single_launches=launches1)
    if not same or not shared or shard_lanes != [
            SERVE_LANES // PLAN_SERVE_SHARDS] * PLAN_SERVE_SHARDS \
            or launches["decode_step"] == 0:
        raise AssertionError(f"the sharded pool is not the single pool: "
                             f"bitwise {same}, shared {shared}, shards "
                             f"{shard_lanes}, launches {launches}")
    return launches


# -- phase 13: LM training ---------------------------------------------------

#: lm_train: one run of Hymba-1.5B whole, at the CLI's defaults (batch,
#: seq, steps), then on at the scoring geometry, where the 2,048 window
#: binds and the scan takes the chunk route over 64 chunks; rwkv6-1.6b
#: whole at the latter
LM_TRAIN_HYMBA = ((8, 128, 4), (2, 4096, 3))
LM_TRAIN_RWKV = (2, 4096, 3)
#: the CLI's learning rate (``launch.train``'s default)
LM_TRAIN_LR = 3e-4
#: lm_train_hold: 2 full-width fp32 layers, one step of this batch
LM_TRAIN_HOLD = (1, 128)
#: lm_converge: examples/lm_gfn_finetune.py's model_25m and settings
LM_CONVERGE_STEPS, LM_CONVERGE_BATCH, LM_CONVERGE_SEQ = 300, 4, 96
LM_CONVERGE_LR = 1e-4
#: the JAX package's TB loss at those steps: mean and spread (largest -
#: smallest) over seeds 0-3 of ``scripts/lm_train_reference.py`` on a CPU;
#: the loss rises in every seed (step 0's mean 10.93), so the reference
#: misses the example's own bar (last loss below the first)
LM_CONVERGE_MEANS = {100: 7754.5916748046875, 200: 27466.24462890625,
                     299: 55624.1474609375}
LM_CONVERGE_SPREAD = {100: 1271.8447265625, 200: 1550.28515625,
                      299: 1272.55859375}
LM_CONVERGE_REFERENCE_BAR_MET = False
#: lm_checkpoint: a 2-layer full-width Hymba at the CLI's batch, stopped
#: after CKPT_CUT steps and resumed to CKPT_STEPS
CKPT_CUT, CKPT_STEPS = 2, 3
#: in the device-kernel names of the backward kernels: every flash
#: backward kernel of both routes (``flash_bwd_*``, ``flash_bwd_wgmma_*``)
#: and the parent's; the scan backward's by route (``rwkv6_scan_bwd_kernel``
#: the recurrence, the parent's too; the chunk route's
#: ``rwkv6_chunk_state_kernel`` in its adjoint form, then
#: ``rwkv6_chunk_bwd_*``: a backward row runs no forward kernel)
FLASH_BWD_MATCH = "flash_bwd_"
SCAN_BWD_MATCH = {"recurrence": "rwkv6_scan_bwd", "chunk": "rwkv6_chunk"}


def model_25m():
    """``examples/lm_gfn_finetune.py``'s ``model_25m`` (dense, 8 layers,
    d_model 320, 5/1 heads of 64, d_ff 1,088, vocab 16,000, QKV bias,
    bf16, remat none)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="gfn-lm-25m", family="dense", num_layers=8, d_model=320,
        num_heads=5, num_kv_heads=1, head_dim=64, d_ff=1088,
        vocab_size=16000, qkv_bias=True, remat="none")


def check_flash_attention_bwd(B, Sq, Skv, H, KVH, D, *, causal, window,
                              bf16, seed, device, parent=None) -> dict:
    """The forward kernel's out and lse (the log-sum-exp each query row
    keeps for the backward) held to the plain forward's (out as the
    forward rows hold it, lse at the fp32 tolerance); then the backward
    kernels of the route ``ops.flash_bwd_route`` picks (three launches
    either way: the tensor-core route's prep, dq, dk/dv; the SIMT route's
    delta, dq, dk/dv), which the row names and must be the rule's, on the
    kernel's out and lse against the plain backward (dense, fp32) on the
    same out and the plain lse, with the same q, k, v and a random
    cotangent; dq, dk, dv held entry by entry as the forward's output is;
    a repeat is bitwise.  With ``parent`` (:func:`parent_library`) the
    parent's backward (the SIMT kernels) is timed on the same inputs
    (``parent_kernel_us``).  (Both
    outs are bf16 roundings that may part by one ulp on an entry; a
    backward from each parts by more than one ulp of dq's scale, so the
    out is shared and held on its own.)  The library yardstick:
    ``F.scaled_dot_product_attention``'s backward under the same boolean
    mask, on (B, H, S, D) leaves (kv heads repeated beforehand)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (attention_mask, ref_flash_attention,
                                         ref_flash_attention_bwd,
                                         ref_flash_attention_lse)

    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do = (torch.randn(shape, generator=g).to(device, dt)
                   for shape in ((B, Sq, H, D), (B, Skv, KVH, D),
                                 (B, Skv, KVH, D), (B, Sq, H, D)))
    kw = dict(causal=causal, window=window)
    out, lse = ops._flash_forward(q, k, v, causal, window, 0, Skv, True)
    plain_out = ref_flash_attention(q, k, v, **kw)
    plain_lse = ref_flash_attention_lse(q, k, **kw)
    held = {"out": _held(out, plain_out, bf16),
            "lse": _held(lse, plain_lse, False)}
    del plain_out

    def kernel():
        return ops.flash_attention_backward(q, k, v, out, do, lse, **kw)

    def plain():
        return ref_flash_attention_bwd(q, k, v, out, do, plain_lse, **kw)

    before = dict(ops.flash_attention_backward.route_launches)
    got = kernel()
    torch.cuda.synchronize()
    route = [r for r, n in ops.flash_attention_backward.route_launches.items()
             if n != before[r]]
    want = plain()
    held.update({n: _held(a, b, bf16)
                 for n, a, b in zip(("dq", "dk", "dv"), got, want)})
    bitwise = all(torch.equal(a, b) for a, b in zip(kernel(), got))
    del want
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=0,
                          kv_len=None, device=device)
    G = H // KVH
    lq = q.transpose(1, 2).contiguous().requires_grad_(True)
    lk, lv = (x.repeat_interleave(G, 2).transpose(1, 2).contiguous()
              .requires_grad_(True) for x in (k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
    ldo = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    parent_us = None
    if parent is not None:
        from repro_torch.kernels import build
        bufs = [torch.zeros_like(t) for t in (q, k, v)]
        delta = torch.empty(B, H, Sq, dtype=torch.float32, device=device)
        args = build.FlashAttentionBwdArgs(
            q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
            out=out.data_ptr(), dout=do.data_ptr(), lse=lse.data_ptr(),
            delta=delta.data_ptr(), dq=bufs[0].data_ptr(),
            dk=bufs[1].data_ptr(), dv=bufs[2].data_ptr(), batch=B, q_len=Sq,
            kv_size=Skv, num_heads=H, num_kv_heads=KVH, head_dim=D,
            causal=int(causal), window=window, bf16=int(bf16),
            device=device.index or 0)
        parent_us = profiled_device_us(
            parent_call(parent.repro_flash_attention_bwd, args, device),
            iters=10, match=FLASH_BWD_MATCH)
        del bufs
    pairs = int(mask.sum()) * B * H
    nbytes = (q.element_size() * (4 * q.numel() + 4 * k.numel())
              + 4 * B * H * Sq)
    row = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KVH": KVH, "D": D,
           "dtype": str(dt), "causal": causal, "window": window,
           "route": route, "parent_kernel_us": parent_us,
           "max_abs_err": {n: h["max_abs_err"] for n, h in held.items()
                           if n in ("dq", "dk", "dv")},
           "held": held, "repeat_bitwise_equal": bitwise,
           **timings(kernel, plain, library, match=FLASH_BWD_MATCH,
                     plain_iters=5, iters=10),
           "library_call": "backward of F.scaled_dot_product_attention("
                           "bool mask), kv heads repeated",
           "attended_pairs": pairs,
           # 2.5 x the forward's 4 D flops a pair (S, dP, dV, dK, dQ)
           **bound(nbytes, 10 * D * pairs,
                   BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)}
    emit("kernel", name="flash_attention_bwd", **row)
    del lo, lq, lk, lv
    if not all(h["excess"] <= 1 for h in held.values()) or not bitwise \
            or route != [ops.flash_bwd_route(dt, D)]:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                             f"version at {(B, Sq, Skv, H, KVH, D)}: {held}, "
                             f"repeat bitwise {bitwise}, route {route}")
    return row


def check_rwkv6_scan_bwd(B, T, H, Dk, Dv, *, bonus, state, bf16, seed,
                         device, decay="mild", parent=None) -> dict:
    """The backward kernels of the route ``ops.scan_bwd_route`` picks (the
    row names it, and it must be the rule's) against their plain version
    (the exact reverse recurrence in fp32) on :func:`scan_inputs` and
    random cotangents of the output and the final state, from the chunk
    states the forward of the route ``ops.scan_route`` picks keeps; dr,
    dk, dv held as the forward's output is, dw, du and d(state) as fp32; a
    repeat is bitwise.  No library call computes this recurrence.  With
    ``parent`` the parent's backward (the step recurrence) is timed on the
    same inputs (``parent_kernel_us``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rwkv6_bwd

    dt = torch.bfloat16 if bf16 else torch.float32
    r, k, v, w, u, s0 = scan_inputs(B, T, H, Dk, Dv, bonus=bonus, state=state,
                                    bf16=bf16, decay=decay, seed=seed,
                                    device=device)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(B, T, H, Dv, generator=g).to(device, dt)
    ds = torch.randn(B, H, Dk, Dv, generator=g).to(device)
    _, _, carry = ops._scan_forward(r, k, v, w, u, s0, True)

    def kernel():
        return ops.rwkv6_scan_backward(r, k, v, w, u, s0, carry, do, ds)

    def plain():
        return ref_rwkv6_bwd(r, k, v, w, u, s0, do, ds)

    before = dict(ops.rwkv6_scan_backward.route_launches)
    got = kernel()
    torch.cuda.synchronize()
    route = [x for x, n in ops.rwkv6_scan_backward.route_launches.items()
             if n != before[x]]
    # the plain version is a chain of ~20 small launches a step: timed
    # between CUDA events over this one call (profiling 10^5 launches
    # costs many seconds to read back)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_us = start.elapsed_time(end) * 1e3
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    held = {n: _held(a, b, bf16 and n in ("dr", "dk", "dv"))
            for n, a, b in zip(names, got, want) if b is not None}
    bitwise = all(a is None or torch.equal(a, b)
                  for a, b in zip(kernel(), got))
    del want
    parent_us = None
    if parent is not None:
        from repro_torch.kernels import build
        pad = lambda d: 16 if d <= 16 else 32 if d <= 32 else 64
        bufs = {n: torch.empty_like(t) for n, t in (("r", r), ("k", k),
                                                    ("v", v))}
        dw = torch.empty(B, T, H, Dk, dtype=torch.float32, device=device)
        du = torch.empty(B, H, Dk, dtype=torch.float32, device=device)
        dstate = torch.empty(B, H, Dk, Dv, dtype=torch.float32,
                             device=device)
        scratch = torch.empty(B * H * ops.SCAN_CHUNK * pad(Dk) * pad(Dv),
                              dtype=torch.float32, device=device)
        wf = w.to(torch.float32).contiguous()
        args = build.Rwkv6ScanBwdArgs(
            r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=wf.data_ptr(),
            u=None if u is None else u.data_ptr(), carry=carry.data_ptr(),
            dout=do.data_ptr(), dstate_out=ds.data_ptr(),
            scratch=scratch.data_ptr(), grad_r=bufs["r"].data_ptr(),
            grad_k=bufs["k"].data_ptr(), grad_v=bufs["v"].data_ptr(),
            grad_w=dw.data_ptr(), grad_u=du.data_ptr(),
            grad_state=dstate.data_ptr(), batch=B, steps=T, num_heads=H,
            dk=Dk, dv=Dv, bf16=int(bf16), device=device.index or 0)
        parent_us = profiled_device_us(
            parent_call(parent.repro_rwkv6_scan_bwd, args, device), iters=10,
            match=SCAN_BWD_MATCH["recurrence"])
        del bufs, dw, du, dstate, scratch
    # r, k, v, dO and w read; dr, dk, dv and dw written (u, du and the
    # states are Dk x Dv per head)
    el = r.element_size()
    nbytes = el * (2 * r.numel() + v.numel() + do.numel()) \
        + el * (2 * r.numel() + v.numel()) + 4 * 2 * w.numel()
    row = {"B": B, "T": T, "H": H, "Dk": Dk, "Dv": Dv, "dtype": str(dt),
           "bonus": bonus, "state": state, "decay": decay,
           "forward_route": ops.scan_route(dt, T), "route": route,
           "max_abs_err": {n: h["max_abs_err"] for n, h in held.items()},
           "held": held, "repeat_bitwise_equal": bitwise,
           "kernel_us": profiled_device_us(
               kernel, iters=10, match=SCAN_BWD_MATCH[route[0]]),
           "parent_kernel_us": parent_us,
           "wrapper_us": cuda_time_us(kernel, iters=10, warmup=2),
           "plain_us": plain_us, "plain_timed": "CUDA events, one call",
           "library_us": None,
           # a step: the state recomputed, G v, S dO, S G, G's update, G k
           **bound(nbytes, 12 * Dk * Dv * B * T * H)}
    emit("kernel", name="rwkv6_scan_bwd", **row)
    if not all(h["excess"] <= 1 for h in held.values()) or not bitwise \
            or route != [ops.scan_bwd_route(dt, T)]:
        raise AssertionError(f"rwkv6_scan_bwd disagrees with its plain "
                             f"version at {(B, T, H, Dk, Dv)}: {held}, "
                             f"repeat bitwise {bitwise}, route {route}")
    return row


def train_state_on(params, opt_state, device):
    """A copy of an LM training state on ``device`` (the hold's CPU
    side)."""
    import copy

    from repro_torch.convert import opt_state_to
    model = copy.deepcopy(params["model"]).to(device)
    log_z = params["log_z"].detach().clone().to(device).requires_grad_(True)
    return {"model": model, "log_z": log_z}, opt_state_to(opt_state, device)


def _leaf_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are all zeros)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return 0.0 if err == 0 else err / max(scale, 1e-30)


def lm_train_hold(device) -> None:
    """One TB train step of Hymba-1.5B and rwkv6-1.6b cut to
    LM_TRAIN_HOLD's 2 full-width fp32 layers, on the card (kernels) and
    on the CPU (plain versions), from the same parameters (drawn on the
    card, log Z warm-started there, copied) and the same
    ``synthetic_gfn_batch``.  The loss and every gradient leaf are held to
    the CPU's; then the card's optimizer step (every updated parameter and
    Adam moment, the second moment as its square root) to the CPU's chain
    applied to the card's gradients from the same state.  Each within
    HOLD_TOL of the leaf's largest entry, with no allowance: Adam's first
    update is lr g / (|g| + 1e-8), so from each device's own gradients an
    entry that the two round to either side of 0 would move 2 lr apart;
    on one set of gradients a step that moved no parameter, or moved one
    the wrong way, fails."""
    from repro_torch.checkpoint.manager import lm_train_leaves
    from repro_torch.data.tokens import synthetic_gfn_batch
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    cpu = torch.device("cpu")
    B, S = LM_TRAIN_HOLD
    for arch in ("hymba-1.5b", RWKV_ARCH):
        cfg = lm_config(arch, num_layers=LM_HOLD_LAYERS, dtype="float32")
        tcfg = steps.LMTrainConfig(lr=LM_TRAIN_LR)
        tx = steps.make_optimizer(tcfg)
        params, opt_state, _ = train.init_state(cfg, tcfg, seed=11,
                                                device=device)
        with torch.no_grad():
            params["log_z"].copy_(train.pilot_log_z(params, cfg, B, S,
                                                    seed=11, device=device))
        sides = {"card": (params, opt_state, device),
                 "cpu": train_state_on(params, opt_state, cpu) + (cpu,)}
        out = {}
        for side, (p, o, dev) in sides.items():
            # step 1's batch: on the pilot's own batch (step 0) the warm
            # start makes the mean TB residual, log Z's gradient, zero up
            # to rounding
            batch = synthetic_gfn_batch(cfg, B, S, seed=11, step=1,
                                        device=dev)
            # make_train_step's body, with its gradients kept and, on the
            # CPU, the card's gradients stepped
            leaves = steps.param_leaves(p)
            total, metrics = steps.loss_fn(p, cfg, tcfg, batch)
            grads = dict(zip(leaves, torch.autograd.grad(
                total, list(leaves.values()), materialize_grads=True)))
            stepped = grads if side == "card" else {
                n: g.detach().cpu() for n, g in out["card"]["grads"].items()}
            with torch.no_grad():
                updates, o = tx.update(
                    stepped, o, {n: t.detach() for n, t in leaves.items()})
                adamw.apply_updates_(leaves, updates)
            out[side] = {"loss": metrics["loss"].detach(), "grads": grads,
                         "state": lm_train_leaves(p, o)}
        card, host = out["card"], out["cpu"]
        loss_err = _leaf_err(card["loss"], host["loss"])
        grad_err = {n: _leaf_err(card["grads"][n], g)
                    for n, g in host["grads"].items()}
        state_err = {}
        for n, t in host["state"].items():
            c = card["state"][n]
            if "/.nu/" in n:
                c, t = c.sqrt(), t.sqrt()
            state_err[n] = _leaf_err(c, t)
        worst = max(list(grad_err.values()) + list(state_err.values())
                    + [loss_err])
        emit("lm_train_hold", model=cfg.name, layers=cfg.num_layers,
             batch=B, seq=S, dtype="float32",
             loss={"card": float(card["loss"]), "cpu": float(host["loss"])},
             loss_err=loss_err, leaves=len(grad_err),
             worst_grad=max(grad_err.items(), key=lambda kv: kv[1]),
             worst_state=max(state_err.items(), key=lambda kv: kv[1]),
             state_stepped_on="the card's gradients, both devices",
             tol=f"{HOLD_TOL:g} of each leaf's largest entry")
        if not worst <= HOLD_TOL:
            raise AssertionError(f"lm_train_hold {arch}: card and CPU part "
                                 f"by {worst} (> {HOLD_TOL})")
        del params, opt_state, sides, out
        free_card(device)


def lm_train_start(cfg, device, seed: int = 0) -> dict:
    """A fresh TB run of ``cfg`` through ``launch.train``'s ``init_state``
    (as ``train_loop`` starts one): ``{"p", "o", "step", "t", "seed"}``
    for :func:`lm_train_run`."""
    from repro_torch.launch import steps, train

    tcfg = steps.LMTrainConfig(lr=LM_TRAIN_LR)
    params, opt_state, step = train.init_state(cfg, tcfg, seed=seed,
                                               device=device)
    return {"p": params, "o": opt_state, "step": step, "t": 0, "seed": seed}


def lm_train_run(cfg, batch: int, seq: int, steps_: int, device,
                 per_step: dict, profile: bool, state: dict) -> dict:
    """``steps_`` more TB steps of ``state``'s run (:func:`lm_train_start`)
    at ``batch`` x ``seq``, log Z first warm-started on this size's pilot
    batch (as a run started at this size is): each step timed alone (host
    clock around a synchronized step), its loss read, its launches counted
    (each backward's by route too, :func:`bwd_route_launches`) and held to
    ``per_step`` exactly; peak memory over these steps (the run's state
    included); then, with ``profile``, one more step's device idle share
    (:func:`profiled_step`).  Returns the phase's fields and the steps'
    launches (the backwards' routes included)."""
    from repro_torch.data.tokens import synthetic_gfn_batch
    from repro_torch.launch import train

    step, seed = state["step"], state["seed"]
    with torch.no_grad():
        state["p"]["log_z"].copy_(train.pilot_log_z(
            state["p"], cfg, batch, seq, seed=seed, device=device))
    torch.cuda.reset_peak_memory_stats(device)
    times, losses, launches = [], [], []
    total = {k: 0 for k in list(wrappers()) + list(bwd_route_launches())}
    for _ in range(steps_):
        b = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=state["t"],
                                device=device)
        state["t"] += 1
        reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state["p"], state["o"], m = step(state["p"], state["o"], b)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        counts = {**read_launches(), **bwd_route_launches()}
        launches.append({k: v for k, v in counts.items() if v})
        _add(total, counts)
    peak = torch.cuda.max_memory_allocated(device)
    want = {k: v for k, v in per_step.items() if v}
    fields = {"model": cfg.name, "layers": cfg.num_layers, "batch": batch,
              "seq": seq, "steps": steps_, "remat": cfg.remat,
              "step_seconds": times, "loss": losses,
              "steps_per_s": steps_ / sum(times),
              "steady_steps_per_s": (steps_ - 1) / sum(times[1:])
              if steps_ > 1 else None,
              "tokens_per_s": batch * seq * steps_ / sum(times),
              "peak_memory_gb": peak / 1e9,
              "launches_per_step": launches[-1]}
    if profile:
        b = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=state["t"],
                                device=device)
        state["t"] += 1

        def one():
            state["p"], state["o"], _ = step(state["p"], state["o"], b)

        f = profiled_step(one)
        fields.update(device_idle_share=f["device_idle_share"],
                      profiled_step_wall_us=f["wall_us"],
                      profiled_step_busy_us=f["device_busy_us"],
                      device_top=f["device_top"][:6])
    if not all(math.isfinite(x) for x in losses) or any(
            got != want for got in launches):
        raise AssertionError(f"lm_train {cfg.name} ({batch} x {seq}): "
                             f"losses {losses}; launches per step "
                             f"{launches}, expected {want}")
    return fields, total


def lm_train_phase(device) -> dict:
    """Hymba-1.5B whole, one run drawn once: LM_TRAIN_HYMBA's steps at
    its first size, then on at its second (log Z warm-started anew); then
    rwkv6-1.6b whole at LM_TRAIN_RWKV (see :func:`lm_train_run`): per
    step, Hymba launches 64 flash and 64 scan forwards (each layer's
    twice: remat full recomputes it in the backward) and 32 of each
    backward, all on the tensor-core flash backward and the chunk-parallel
    scan backward (bf16, D 64, T >= 64); rwkv6 48 scan forwards and 24
    backwards, all on the chunk route.  Returns the runs' launches."""
    def fwd(cfg):       # each layer's forwards a step: twice under remat
        return cfg.num_layers * (2 if cfg.remat == "full" else 1)

    total = {k: 0 for k in list(wrappers()) + list(bwd_route_launches())}
    hymba = lm_config("hymba-1.5b")
    L = hymba.num_layers
    run = lm_train_start(hymba, device)
    for batch, seq, n in LM_TRAIN_HYMBA:
        fields, launches = lm_train_run(
            hymba, batch, seq, n, device,
            {"flash_attention": fwd(hymba), "rwkv6_scan": fwd(hymba),
             "flash_attention_bwd": L, "rwkv6_scan_bwd": L,
             "flash_attention_bwd/wgmma": L, "rwkv6_scan_bwd/chunk": L},
            profile=seq == LM_TRAIN_HYMBA[-1][1], state=run)
        emit("lm_train", **fields)
        _add(total, launches)
    del run
    free_card(device)
    rwkv = lm_config(RWKV_ARCH)
    batch, seq, n = LM_TRAIN_RWKV
    run = lm_train_start(rwkv, device)
    fields, launches = lm_train_run(
        rwkv, batch, seq, n, device,
        {"rwkv6_scan": fwd(rwkv), "rwkv6_scan_bwd": rwkv.num_layers,
         "rwkv6_scan_bwd/chunk": rwkv.num_layers},
        profile=True, state=run)
    emit("lm_train", **fields)
    _add(total, launches)
    del run
    free_card(device)
    return total


def lm_converge(device) -> dict:
    """``examples/lm_gfn_finetune.py`` on the card: model_25m, 300 TB steps
    of batch 4 x 96 at lr 1e-4 through ``launch.train.train_loop``; the
    loss at steps 100, 200 and 299 within max(3 x the seeds' spread, 10 %
    of the mean) of the JAX package's (``LM_CONVERGE_MEANS``), and the
    example's bar (``losses[-1] < losses[0]``) met or missed as the
    reference's is.  Returns the run's launches (remat none: 8 flash
    forwards and 8 backwards a step, the backwards on the tensor-core
    route, 8 forwards for the warm start)."""
    from repro_torch.launch import train

    cfg = model_25m()
    reset_launches()
    t0 = time.perf_counter()
    out = train.train_loop(cfg, steps=LM_CONVERGE_STEPS,
                           batch=LM_CONVERGE_BATCH, seq=LM_CONVERGE_SEQ,
                           lr=LM_CONVERGE_LR, log_every=100, seed=0,
                           device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {**read_launches(), **bwd_route_launches()}
    losses = {h["step"]: h["loss"] for h in out["history"]}
    band = {s: max(3 * LM_CONVERGE_SPREAD[s], 0.1 * m)
            for s, m in LM_CONVERGE_MEANS.items()}
    within = {s: abs(losses[s] - m) <= band[s]
              for s, m in LM_CONVERGE_MEANS.items()}
    bar = losses[LM_CONVERGE_STEPS - 1] < losses[0]
    L = cfg.num_layers
    want = {"flash_attention": L * (LM_CONVERGE_STEPS + 1),
            "flash_attention_bwd": L * LM_CONVERGE_STEPS,
            "flash_attention_bwd/wgmma": L * LM_CONVERGE_STEPS}
    emit("lm_converge", model=cfg.name, steps=LM_CONVERGE_STEPS,
         batch=LM_CONVERGE_BATCH, seq=LM_CONVERGE_SEQ, lr=LM_CONVERGE_LR,
         loss=losses, reference_mean=LM_CONVERGE_MEANS,
         reference_spread=LM_CONVERGE_SPREAD, band=band, within=within,
         example_bar_met=bar,
         reference_bar_met=LM_CONVERGE_REFERENCE_BAR_MET,
         wall_s=wall, steps_per_s=LM_CONVERGE_STEPS / wall,
         launches={k: v for k, v in launches.items() if v})
    if not all(within.values()) or bar != LM_CONVERGE_REFERENCE_BAR_MET \
            or {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"lm_converge: losses {losses} against the "
                             f"reference's {LM_CONVERGE_MEANS} (band "
                             f"{band}); example bar {bar}; launches "
                             f"{launches}, expected {want}")
    del out
    free_card(device)
    return launches


def lm_checkpoint(device) -> dict:
    """A 2-layer full-width bf16 Hymba through ``train_loop`` at the CLI's
    batch: CKPT_STEPS steps straight, against CKPT_CUT steps (checkpoint
    at the end) resumed to CKPT_STEPS; every leaf of the two final states
    (``lm_train_leaves``) within HOLD_TOL of its largest entry, and
    whether all are bitwise equal.  Returns the runs' launches."""
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                lm_train_leaves)
    from repro_torch.launch import train

    cfg = lm_config("hymba-1.5b", num_layers=LM_HOLD_LAYERS)
    batch, seq, _ = LM_TRAIN_HYMBA[0]
    kw = dict(batch=batch, seq=seq, seed=4, lr=LM_TRAIN_LR, device=device)
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        straight = train.train_loop(cfg, steps=CKPT_STEPS, **kw)
        t0 = time.perf_counter()
        train.train_loop(cfg, steps=CKPT_CUT, ckpt_dir=f"{tmp}/b", **kw)
        cut_s = time.perf_counter() - t0
        resumed = train.train_loop(cfg, steps=CKPT_STEPS,
                                   ckpt_dir=f"{tmp}/b", **kw)
        latest = CheckpointManager(f"{tmp}/b").latest_step()
    a = lm_train_leaves(straight["params"], straight["opt_state"])
    b = lm_train_leaves(resumed["params"], resumed["opt_state"])
    errs = {n: _leaf_err(b[n], t) for n, t in a.items()}
    bitwise = all(torch.equal(b[n], t) for n, t in a.items())
    worst = max(errs.items(), key=lambda kv: kv[1])
    emit("lm_checkpoint", model=cfg.name, layers=cfg.num_layers,
         batch=batch, seq=seq, cut=CKPT_CUT, steps=CKPT_STEPS,
         leaves=len(errs), worst=worst, bitwise=bitwise,
         resumed_history=resumed["history"], latest_step=latest,
         cut_run_seconds=cut_s, tol=f"{HOLD_TOL:g} of each leaf's largest "
                                    "entry")
    launches = {**read_launches(), **bwd_route_launches()}
    # bf16, D 64, T 128: every backward on the tensor-core flash route and
    # the chunk-parallel scan route
    routed = (launches["flash_attention_bwd/wgmma"]
              == launches["flash_attention_bwd"] > 0
              and launches["rwkv6_scan_bwd/chunk"]
              == launches["rwkv6_scan_bwd"] > 0)
    if not worst[1] <= HOLD_TOL or latest != CKPT_STEPS \
            or [h["step"] for h in resumed["history"]] != [CKPT_STEPS - 1] \
            or not routed:
        raise AssertionError(f"lm_checkpoint: the resumed run departs from "
                             f"the straight one: {worst}, latest {latest}, "
                             f"history {resumed['history']}; backward "
                             f"routes {launches}")
    del straight, resumed, a, b
    free_card(device)
    return launches


def single_nvcc_call_seconds(build) -> float:
    """The seconds of one ``nvcc -shared`` call over every kernel source
    (what the parallel build saves on)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        str(Path(tmp) / "single.so"),
                        *map(str, build.SOURCES)],
                       check=True, capture_output=True, timeout=600)
        return time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of the parent commit: its decode_step, "
             "decode_attention, traj_logprob backward, subtb_loss and "
             "flash / scan backward kernels are built and timed beside this "
             "tree's on the same inputs (parent_kernel_us)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spawned = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    dataset = spawned.submit(timed_ising_dataset, ISING_DATASET)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build()
    build.library()
    seconds = time.perf_counter() - t0
    single = concurrent.futures.ThreadPoolExecutor(1).submit(
        single_nvcc_call_seconds, build)
    ptxas = named_ptxas(log)
    emit("build", seconds=seconds,
         library=str(Path(path).relative_to(ROOT)), ptxas=ptxas,
         spilling=spilling(ptxas))
    parent = None
    if opts.parent is not None:
        parent, parent_ptxas = parent_library(opts.parent.resolve())
        emit("parent_build", sources=list(PARENT_SOURCES), ptxas=parent_ptxas,
             spilling=spilling(parent_ptxas))

    floor_us = launch_floor_us(device)
    # the serving batch and the lane counts the serve phase's requests are
    # held at (forward_rollout over 7, 16 and 200 samples), 128 (bitseq's
    # log Z bounds) and 256
    rows = [check_decode_step(B, 3, 16, 64, 8, 256, 3840, seed=B,
                              device=device, floor_us=floor_us, parent=parent)
            for B in (1, 7, 16, SERVE_LANES, 128, 200, 256)]
    rows.append(check_decode_step(5, 2, 9, 48, 6, 80, 203, seed=99,
                                  device=device, floor_us=floor_us,
                                  parent=parent))
    # the sequence recipes' eval rollouts (non-exploring: the fused step):
    # tfbind8's 256 and 2,000 lanes, AMP's 128 over 61 slots and its
    # top-100's 256
    rows += [check_decode_step(B, L, C, 64, 8, 256, A, seed=100 + B,
                               device=device, floor_us=floor_us)
             for B, L, C, A in ((256, 2, 9, 4), (2000, 2, 9, 4),
                                (128, 3, 61, 21), (256, 3, 61, 21))]
    # the serving tier (serve_tier): its held requests' forward_rollout
    # batches of 8 / 32 / 64 at bitseq, tfbind8 (2 layers, 9 slots, A = 4)
    # and AMP (61 slots, A = 21), which are also the front's 64 lanes and
    # bitseq's autosize buckets 16 / 32 / 64
    rows += [check_decode_step(B, L, C, 64, 8, 256, A, seed=300 + B + A,
                               device=device, floor_us=floor_us)
             for B, L, C, A in ((8, 3, 16, 3840), (32, 3, 16, 3840),
                                (8, 2, 9, 4), (32, 2, 9, 4), (64, 2, 9, 4),
                                (8, 3, 61, 21), (32, 3, 61, 21),
                                (64, 3, 61, 21))]
    main_row = next(r for r in rows if r["B"] == SERVE_LANES)
    check_decode_step_lanes(device)
    # the training rollout's shape first; odd S and H with empty rows; then
    # every head dim up to 64 at the training shape and at S = 100 (several
    # chunks of the online softmax)
    attn = [check_decode_attention(16, 16, 8, 8, list(range(1, 17)), seed=0,
                                   device=device, floor_us=floor_us,
                                   parent=parent),
            check_decode_attention(5, 37, 3, 8, [0, 1, 36, 37, 0], seed=1,
                                   device=device, floor_us=floor_us,
                                   parent=parent)]
    attn += [check_decode_attention(16, 16, 8, hd, list(range(1, 17)),
                                    seed=2 + hd, device=device,
                                    floor_us=floor_us, parent=parent)
             for hd in (16, 32, 64)]
    attn += [check_decode_attention(16, 100, 8, hd,
                                    [(7 * i) % 101 for i in range(16)],
                                    seed=3 + hd, device=device,
                                    floor_us=floor_us, parent=parent)
             for hd in (8, 16, 32, 64)]
    # tfbind8's training rollout (9 slots, BOS included) and AMP's (61
    # slots), ragged: rows stop at different steps
    attn += [check_decode_attention(16, 9, 8, 8,
                                    [1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9, 5,
                                     5, 1, 3], seed=20, device=device,
                                    floor_us=floor_us),
             check_decode_attention(16, 61, 8, 8,
                                    [1, 2, 6, 11, 61, 60, 33, 7, 61, 2, 45,
                                     19, 61, 30, 3, 58], seed=21,
                                    device=device, floor_us=floor_us)]
    # bitseq_tb under vmap_seeds(4): 4 seeds' 16 rows folded into one
    # launch, ragged lengths
    attn.append(check_decode_attention(64, 16, 8, 8,
                                       [(5 * i) % 16 + 1 for i in range(64)],
                                       seed=24, device=device,
                                       floor_us=floor_us))
    # the pop-only cached backward (cached_backward): 16 terminals whose
    # queries attend the whole sequence down to BOS alone
    attn += [check_decode_attention(16, 9, 8, 8, [9] * 8 + [5] * 4 + [1] * 4,
                                    seed=22, device=device,
                                    floor_us=floor_us),
             check_decode_attention(16, 61, 8, 8,
                                    [61, 61, 60, 41, 33, 20, 11, 9, 5, 3,
                                     2, 1, 1, 57, 48, 13], seed=23,
                                    device=device, floor_us=floor_us)]
    traj = [check_traj_logprob(16, 15, 3840, seed=0, device=device,
                               floor_us=floor_us, parent=parent),
            check_traj_logprob(16, 15, 15, seed=1, device=device,
                               floor_us=floor_us, parent=parent),
            check_traj_logprob(3, 50, 203, seed=2, device=device,
                               floor_us=floor_us, parent=parent)]
    # the sequence recipes' losses (tfbind8 P_F, QM9 P_F), AMP's log Z
    # bounds (128 trajectories of 61 steps), the losses' P_B (tfbind8,
    # QM9); the other log Z bounds, P_F and P_B: bitseq's 128 x 15,
    # tfbind8's 256 x 8, QM9's 256 x 5, AMP's P_B, the hypergrid's 256 x 29
    traj += [check_traj_logprob(B, T, A, seed=10 + i, device=device,
                                floor_us=floor_us)
             for i, (B, T, A) in enumerate([
                 (16, 8, 4), (16, 5, 22), (128, 61, 21), (16, 8, 1),
                 (16, 5, 2), (128, 15, 3840), (128, 15, 15), (256, 8, 4),
                 (256, 8, 1), (256, 5, 22), (256, 5, 2), (128, 61, 2),
                 (256, 29, 5)])]
    # bitseq_tb under vmap_seeds(4): the folded P_F and P_B (64 x 15)
    traj += [check_traj_logprob(64, 15, A, seed=60 + A, device=device,
                                floor_us=floor_us) for A in (3840, 15)]
    # tfbind8_tb's replay loss over the 16 fresh and 16 replayed rows: P_F
    # and P_B (32 x 8)
    traj += [check_traj_logprob(32, 8, A, seed=50 + A, device=device,
                                floor_us=floor_us) for A in (4, 1)]
    # the graph recipes: phylo_fldb's loss, P_F over DS1's 1,378 slot pairs
    # and its learned P_B over the 53 slots (32 trees of 26 merges), and
    # dag_mdb's log Z bounds, P_F and P_B over 26 actions (256 x 11)
    traj += [check_traj_logprob(B, T, A, seed=30 + i, device=device,
                                floor_us=floor_us)
             for i, (B, T, A) in enumerate([
                 (32, 26, 1378), (32, 26, 53), (256, 11, 26)])]
    # ising_ebgfn's loss, P_F over the 162 site-spin pairs and its learned
    # P_B over the 81 sites (256 trajectories of 81 steps), and the same at
    # ising_converge's 4x4 lattice (64 x 16, A = 32 and 16)
    traj += [check_traj_logprob(B, T, A, seed=40 + i, device=device,
                                floor_us=floor_us)
             for i, (B, T, A) in enumerate([
                 (256, 81, 162), (256, 81, 81), (64, 16, 32), (64, 16, 16)])]
    # (16, 30) is the main path's (4x8^4, a warp per trajectory); 78 the
    # paper grid's; 7000 a long trajectory (a block of 896 threads); then
    # potentials at the offset log Z gives them (1e3), where JAX's expanded
    # prefix form cancels, as N(0, 1) and as a random walk, and lambda = 1;
    # 9000 takes two tiles (8 states x 1,024 threads each); (16, 9) the
    # cli phase's hypergrid under time_limit:limit=8
    subtb = [check_subtb(B, T1, lam, seed=i, device=device,
                         floor_us=floor_us, kind=kind, offset=offset,
                         parent=parent)
             for i, (B, T1, lam, kind, offset) in enumerate(
                 [(16, 30, 0.9, "normal", 0.0), (16, 78, 0.9, "normal", 0.0),
                  (3, 100, 0.8, "normal", 0.0), (1, 7, 0.5, "normal", 0.0),
                  (4, 200, 0.99, "normal", 0.0),
                  (3, 7000, 0.999, "normal", 0.0),
                  (16, 30, 0.9, "normal", 1e3),
                  (3, 7000, 0.999, "normal", 1e3),
                  (3, 7000, 0.999, "walk", 1e3),
                  (3, 7000, 1.0, "normal", 1e3),
                  (2, 9000, 0.999, "walk", 1e3),
                  (16, 9, 0.9, "normal", 0.0),
                  (128, 30, 0.9, "normal", 0.0)])]
    # the scoring pass's attention: Hymba's heads over 2 x 4,096 tokens in
    # bf16, window 2,048 (the tensor-core route), and the same geometry in
    # fp32 (the SIMT route; holds the skipping of key tiles outside the
    # window at TOL); then ragged, fp32, wide heads, a cached prefill; then
    # the tensor-core route at D = 128 non-causal, ragged, a cached prefill
    flash = [check_flash_attention(2, 4096, 4096, 25, 5, 64, causal=True,
                                   window=2048, bf16=True, seed=0,
                                   device=device),
             check_flash_attention(2, 4096, 4096, 25, 5, 64, causal=True,
                                   window=2048, bf16=False, seed=5,
                                   device=device),
             check_flash_attention(1, 17, 33, 2, 1, 16, causal=True,
                                   window=0, bf16=False, seed=1,
                                   device=device),
             check_flash_attention(2, 300, 300, 4, 2, 64, causal=True,
                                   window=64, bf16=False, seed=2,
                                   device=device),
             check_flash_attention(2, 64, 256, 4, 1, 128, causal=False,
                                   window=0, bf16=False, seed=3,
                                   device=device),
             check_flash_attention(2, 17, 64, 4, 2, 32, causal=True,
                                   window=16, q_offset=40, kv_len=57,
                                   bf16=False, seed=4, device=device),
             check_flash_attention(2, 64, 256, 4, 1, 128, causal=False,
                                   window=0, bf16=True, seed=6,
                                   device=device),
             check_flash_attention(1, 17, 33, 2, 1, 16, causal=True,
                                   window=0, bf16=True, seed=7,
                                   device=device),
             check_flash_attention(2, 17, 64, 4, 2, 32, causal=True,
                                   window=16, q_offset=40, kv_len=57,
                                   bf16=True, seed=8, device=device)]
    # Hymba's SSM heads: the scoring pass's (chunk route) and a decode
    # step's (recurrence), from a state; then ragged fp32 with u, and
    # RWKV6's 64 x 64 heads (recurrence); then on the chunk route RWKV6's
    # heads in bf16 with u, a ragged T, and the scoring shape at strong
    # decays (far below the JAX chunk form's 1e-30 clamp)
    scan = [check_rwkv6_scan(2, 4096, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=0, device=device),
            check_rwkv6_scan(8, 1, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=1, device=device),
            check_rwkv6_scan(1, 100, 3, 32, 32, bonus=True, state=True,
                             bf16=False, seed=2, device=device),
            check_rwkv6_scan(2, 300, 4, 64, 64, bonus=True, state=True,
                             bf16=False, seed=3, device=device),
            check_rwkv6_scan(2, 300, 4, 64, 64, bonus=True, state=True,
                             bf16=True, seed=4, device=device),
            check_rwkv6_scan(2, 1000, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=5, device=device),
            check_rwkv6_scan(2, 4096, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=6, device=device,
                             decay="strong")]
    # the dense family (phase 11): head dim 128, causal, GQA groups of 5
    # (qwen2.5-32b's scoring pass), 8 (command-r-35b, qwen2-72b) and 12
    # (command-r-plus-104b) over 2 x 2,048 tokens in bf16; the cached S > 1
    # call (16 queries at q_offset 1,024 over kv_len 1,040 of 2,048 slots);
    # the dense hold's fp32 pass (the SIMT route)
    flash += [check_flash_attention(2, 2048, 2048, H, 8, 128, causal=True,
                                    window=0, bf16=True, seed=20 + H,
                                    device=device) for H in (40, 64, 96)]
    flash += [check_flash_attention(2, CACHED_NEW, CACHED_SLOTS, 40, 8, 128,
                                    causal=True, window=0, bf16=True, seed=30,
                                    device=device, q_offset=CACHED_FILLED,
                                    kv_len=CACHED_FILLED + CACHED_NEW),
              check_flash_attention(1, LM_HOLD_TOKENS, LM_HOLD_TOKENS, 40, 8,
                                    128, causal=True, window=0, bf16=False,
                                    seed=31, device=device)]
    # Hymba's scoring pass starts from no state; RWKV6's 32 heads of 64 with
    # u: the scoring pass (chunk route, no state), a decode step (state),
    # and the rwkv hold's fp32 pass and decode step (recurrence)
    scan += [check_rwkv6_scan(2, 4096, 25, 16, 64, bonus=False, state=False,
                              bf16=True, seed=7, device=device),
             check_rwkv6_scan(2, RWKV_PREFILL_LEN, 32, 64, 64, bonus=True,
                              state=False, bf16=True, seed=8, device=device),
             check_rwkv6_scan(DECODE_BATCH, 1, 32, 64, 64, bonus=True,
                              state=True, bf16=True, seed=9, device=device),
             check_rwkv6_scan(1, LM_HOLD_TOKENS, 32, 64, 64, bonus=True,
                              state=False, bf16=False, seed=10,
                              device=device),
             check_rwkv6_scan(2, 1, 32, 64, 64, bonus=True, state=True,
                              bf16=False, seed=11, device=device)]

    # the VLM, MoE and Whisper families (phase 12): qwen2-moe's MHA (16/16
    # heads of 128) and qwen3-moe's GQA groups of 8 (32/4) over 2 x 2,048
    # (the VLM's 64/8 heads of 128 are the dense rows' H = 64); Whisper's
    # 16/16 heads of 64: the encoder's causal pass over 1,500 frames (the
    # last key tile ragged) at the decode batch and the scoring batch, the
    # decoder's causal 448, its cross-attention from 448 queries and from
    # one (a decode step) over the 1,500 keys, non-causal
    flash += [check_flash_attention(2, 2048, 2048, H, KVH, 128, causal=True,
                                    window=0, bf16=True, seed=40 + H,
                                    device=device)
              for H, KVH in ((16, 16), (32, 4))]
    flash += [check_flash_attention(B, Sq, Skv, 16, 16, 64, causal=causal,
                                    window=0, bf16=True, seed=50 + i,
                                    device=device)
              for i, (B, Sq, Skv, causal) in enumerate([
                  (DECODE_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, True),
                  (2, WHISPER_FRAMES, WHISPER_FRAMES, True),
                  (2, WHISPER_SCORE_LEN, WHISPER_SCORE_LEN, True),
                  (2, WHISPER_SCORE_LEN, WHISPER_FRAMES, False),
                  (DECODE_BATCH, 1, WHISPER_FRAMES, False)])]

    emit("build_single_call", single_nvcc_call_seconds=single.result(),
         beside="the kernel checks")

    # the phases the kernels line counts record the shapes they launch at
    with recording_path_shapes():
        serve = serve_phase(device)
        serve_tier = serve_tier_phase(device)
        train = train_phase(device)
    loop, state, before = train_hold_phase(device)
    train_profile(loop, state)
    trained_fused_step(loop, state, before, device)
    replayed_fused_step(loop, state, device)
    with recording_path_shapes():
        hypergrid = hypergrid_train_phase(device)
    _, loop, state = hold_iteration("hypergrid_hold", "hypergrid_subtb",
                                    device)
    train_profile(loop, state, phase="hypergrid_profile")
    hypergrid_converge(device)
    with recording_path_shapes():
        seqs = seqs_train_phase(device)
    seqs_profile(device)
    with recording_path_shapes():
        seqs_evals = seqs_evals_phase(device)
        graph_env = graph_env_train_phase(device)
    graph_env_profile(device)
    with recording_path_shapes():
        graph_evals = graph_evals_phase(device)
        ising = ising_train_phase(device, dataset)
    spawned.shutdown()
    ising_hold(device)
    with recording_path_shapes():
        ising_conv = ising_converge(device)
        box_conv = box_converge(device)
        replay = replay_train_phase(device)
        replay_conv = replay_converge(device)
        cli = cli_phase(device)
    # the execution plans: the seed plan records its folded shapes itself
    plan_vmap = plan_vmap_seeds_phase(device)
    with recording_path_shapes():
        plan_dp = plan_data_parallel_phase(device)
        plan_serve = plan_serve_phase(device)
    replay_hold(device)
    box_hold(device)
    dag_converge(device)
    graph_train_phase(device)
    hymba = lm_config("hymba-1.5b")
    params = lm_params(hymba, device)
    with recording_path_shapes():
        decode, decode_scan = lm_decode_phase(hymba, params, device)
        prefill, prefill_scan = lm_prefill_phase(hymba, params, device)
    scan_hold_phase(hymba, params, device)
    lm_profile(hymba, params, device)
    del params
    lm_family_hold("lm_hold", lm_config(
        "hymba-1.5b", num_layers=LM_HOLD_LAYERS, dtype="float32",
        sliding_window=HYMBA_HOLD_WINDOW), device, tokens=HYMBA_HOLD_TOKENS,
        steps=HYMBA_HOLD_STEPS)
    # the dense and RWKV6 families, each model freed before the next
    free_card(device)
    dense = lm_config(DENSE_ARCH)
    params = lm_params(dense, device)
    with recording_path_shapes():
        _, seq = dense_decode_phase(dense, params, device)
        dense_prefill = dense_prefill_phase(dense, params, device)
        dense_cached = dense_cached_phase(dense, params, device)
        dense_int8_phase(dense, params, device, seq)
    lm_profile(dense, params, device, phase="dense_profile")
    del params
    free_card(device)
    with recording_path_shapes():
        command_r = command_r_phase(device)
        dense_cut = dense_cut_phase(device)
    rwkv = lm_config(RWKV_ARCH)
    params = lm_params(rwkv, device)
    with recording_path_shapes():
        _, rwkv_decode_scan = rwkv_decode_phase(rwkv, params, device)
        _, rwkv_prefill_scan = rwkv_prefill_phase(rwkv, params, device)
    lm_profile(rwkv, params, device, phase="rwkv_profile")
    del params
    free_card(device)
    lm_family_hold("dense_hold", lm_config(
        DENSE_ARCH, num_layers=LM_HOLD_LAYERS, dtype="float32"), device,
        int8_steps=INT8_HOLD_STEPS)
    lm_family_hold("rwkv_hold", lm_config(
        RWKV_ARCH, num_layers=LM_HOLD_LAYERS, dtype="float32"), device)
    # the VLM, MoE and Whisper families, each model freed before the next
    vlm = lm_config(VLM_ARCH, num_layers=VLM_LAYERS)
    params = lm_params(vlm, device, seed=2)
    with recording_path_shapes():
        vlm_decode_phase(vlm, params, device)
        vlm_prefill = vlm_prefill_phase(vlm, params, device)
    del params
    free_card(device)
    with recording_path_shapes():
        moe_prefill = moe_phases(MOE_ARCH, device, DECODE_PROMPT, DECODE_GEN,
                                 seed=5, phases=("moe_decode", "moe_prefill"))
        moe_a27 = moe_phases(MOE_A27_ARCH, device, MOE_A27_PROMPT,
                             MOE_A27_GEN, seed=6, phases=("moe_a27",))
        encdec_decode, encdec_prefill = encdec_phases(device)
    lm_family_hold("vlm_hold", lm_config(
        VLM_ARCH, num_layers=LM_HOLD_LAYERS, dtype="float32"), device,
        steps=VLM_HOLD_STEPS)
    lm_family_hold("moe_hold", lm_config(
        MOE_A27_ARCH, num_layers=LM_HOLD_LAYERS, dtype="float32"), device)
    lm_family_hold("encdec_hold", lm_config(
        WHISPER_ARCH, num_layers=LM_HOLD_LAYERS,
        encoder_layers=LM_HOLD_LAYERS, dtype="float32"), device)
    # LM training (phase 13): the backward kernels (and the forward rows
    # the training phases add: Hymba at the CLI's 8 x 128, the holds' fp32
    # 2 x 128, model_25m's 4 x 96) at every shape the phases launch, a D 128
    # dense shape and Whisper's cross-attention; then the phases
    free_card(device)
    flash += [check_flash_attention(B, S, S, H, KVH, 64, causal=True,
                                    window=w, bf16=bf16, seed=60 + i,
                                    device=device)
              for i, (B, S, H, KVH, w, bf16) in enumerate([
                  (8, 128, 25, 5, 2048, True), (1, 128, 25, 5, 2048, False),
                  (4, 96, 5, 1, 0, True)])]
    # (rwkv6's hold, (1, 128, 32, 64/64) fp32 with u, has its row above)
    scan += [check_rwkv6_scan(B, T, H, Dk, Dv, bonus=False, state=False,
                              bf16=bf16, seed=20 + i, device=device)
             for i, (B, T, H, Dk, Dv, bf16) in enumerate([
                 (8, 128, 25, 16, 64, True), (1, 128, 25, 16, 64, False)])]
    # (each bf16 row with D % 16 == 0 on the tensor-core backward, each
    # bf16 scan row with T >= 64 on the chunk-parallel one; the last rows
    # the new routes' edges: a window edge at D 128 over a ragged Sq, one
    # step past a chunk at strong decay with u)
    flash_bwd = [check_flash_attention_bwd(B, Sq, Skv, H, KVH, D,
                                           causal=causal, window=w,
                                           bf16=bf16, seed=70 + i,
                                           device=device, parent=parent)
                 for i, (B, Sq, Skv, H, KVH, D, causal, w, bf16) in
                 enumerate([
                     (8, 128, 128, 25, 5, 64, True, 2048, True),
                     (2, 4096, 4096, 25, 5, 64, True, 2048, True),
                     (1, 128, 128, 25, 5, 64, True, 2048, False),
                     (4, 96, 96, 5, 1, 64, True, 0, True),
                     (2, 2048, 2048, 40, 8, 128, True, 0, True),
                     (2, WHISPER_SCORE_LEN, WHISPER_FRAMES, 16, 16, 64,
                      False, 0, True),
                     (1, 300, 300, 8, 2, 128, True, 100, True)])]
    scan_bwd = [check_rwkv6_scan_bwd(B, T, H, Dk, Dv, bonus=bonus,
                                     state=False, bf16=bf16, seed=80 + i,
                                     device=device, decay=decay,
                                     parent=parent)
                for i, (B, T, H, Dk, Dv, bonus, bf16, decay) in enumerate([
                    (8, 128, 25, 16, 64, False, True, "mild"),
                    (2, 4096, 25, 16, 64, False, True, "mild"),
                    (2, 4096, 32, 64, 64, True, True, "mild"),
                    (1, 128, 25, 16, 64, False, False, "mild"),
                    (1, 128, 32, 64, 64, True, False, "mild"),
                    (2, 1000, 25, 16, 64, False, True, "strong"),
                    (1, 65, 32, 64, 64, True, True, "strong")])]
    free_card(device)
    with recording_path_shapes(), recording_bwd_shapes():
        reset_launches()
        lm_train_hold(device)
        hold_routes = bwd_route_launches()      # fp32: the SIMT routes
        lm_train = lm_train_phase(device)
        lm_conv = lm_converge(device)
        lm_ckpt = lm_checkpoint(device)
    check_path_shapes(rows, attn, traj, subtb, flash, scan, flash_bwd,
                      scan_bwd)

    def entry(name, source, replaces, launches, rows, main):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] if not isinstance(
                    r["max_abs_err"], dict) else max(r["max_abs_err"].values())
                    for r in rows),
                "ms": main["kernel_us"] / 1e3,
                "plain_ms": main["plain_us"] / 1e3,
                "bound_ms": main["bound_us"] / 1e3,
                "bound_by": main["bound_by"],
                "library_ms": None if main.get("library_us") is None
                else main["library_us"] / 1e3}

    def main_launches(kernel):
        """A kernel's launches on bitseq_tb's, the hypergrid's, the
        sequence recipes', the graph recipes' (training and evals),
        EB-GFN's, box_tb's (none), the replay paths', the CLI's and the
        execution plans' (vmap_seeds, data_parallel)."""
        return sum(p[kernel] for p in (train, hypergrid, seqs, seqs_evals,
                                       graph_env, graph_evals, ising,
                                       ising_conv, box_conv, replay,
                                       replay_conv, cli, plan_vmap,
                                       plan_dp))

    csrc = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        entry("decode_step", csrc + "decode_step.cu",
              "src/repro/kernels/decode_attention.py:239",
              serve["decode_step"] + serve_tier["decode_step"]
              + seqs_evals["decode_step"] + cli["decode_step"]
              + plan_serve["decode_step"], rows, main_row),
        entry("decode_attention", csrc + "decode_attention.cu",
              "src/repro/kernels/decode_attention.py:98",
              main_launches("decode_attention"), attn, attn[0]),
        entry("traj_logprob_fwd", csrc + "traj_logprob.cu",
              "src/repro/kernels/traj_logprob.py:61",
              main_launches("traj_logprob_fwd"), [f for f, _ in traj],
              traj[0][0]),
        entry("traj_logprob_bwd", csrc + "traj_logprob.cu",
              "src/repro/kernels/ops.py:130",
              main_launches("traj_logprob_bwd"), [b for _, b in traj],
              traj[0][1]),
        entry("subtb_loss_fwd", csrc + "subtb_loss.cu",
              "src/repro/kernels/subtb_loss.py:58",
              main_launches("subtb_loss_fwd"), [f for f, _ in subtb],
              subtb[0][0]),
        entry("subtb_loss_bwd", csrc + "subtb_loss.cu",
              "src/repro/core/objectives.py:253",
              main_launches("subtb_loss_bwd"), [b for _, b in subtb],
              subtb[0][1]),
        # Hymba's, qwen2.5-32b's, command-r-35b's, the cut models', the
        # VLM's and the MoEs' scoring passes, the cached S > 1 calls,
        # Whisper's encoder, decoder and cross-attention (decode and pass)
        # and the LM training phases' forwards
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:75",
              sum(p["flash_attention"] for p in (
                  prefill, dense_prefill, dense_cached, command_r,
                  dense_cut, vlm_prefill, moe_prefill, moe_a27,
                  encdec_decode, encdec_prefill, lm_train, lm_conv,
                  lm_ckpt)), flash, flash[0]),
        # the scan's two routes (ops.scan_route): the step recurrence, on
        # decode's path (its row: a decode step), and the chunk kernels, on
        # the scoring pass's (its row: the scoring shape); Hymba's and
        # rwkv6-1.6b's
        dict(entry("rwkv6_scan", csrc + "rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:73",
                   sum(p["recurrence"] for p in (
                       decode_scan, prefill_scan, rwkv_decode_scan,
                       rwkv_prefill_scan)),
                   [r for r in scan if r["route"] == ["recurrence"]],
                   scan[1]), scan_route="recurrence"),
        # (and the LM training phases' forwards: bf16 over T >= 64)
        dict(entry("rwkv6_chunk", csrc + "rwkv6_chunk.cu",
                   "src/repro/kernels/rwkv6_scan.py:73",
                   sum(p["chunk"] for p in (
                       decode_scan, prefill_scan, rwkv_decode_scan,
                       rwkv_prefill_scan))
                   + lm_train["rwkv6_scan"] + lm_ckpt["rwkv6_scan"],
                   [r for r in scan if r["route"] == ["chunk"]], scan[0]),
              scan_route="chunk"),
        # the LM training phases' backwards (JAX differentiates its jnp
        # layers there), each on two routes (ops.flash_bwd_route,
        # ops.scan_bwd_route): the bf16 training steps' tensor-core flash
        # and chunk-parallel scan backwards (each row: Hymba's 2 x 4,096
        # training shape), and the fp32 training hold's SIMT flash and
        # step-recurrence scan backwards (each row: the hold's shape)
        dict(entry("flash_attention_bwd_wgmma",
                   csrc + "flash_attention_bwd_wgmma.cu",
                   "src/repro/models/layers.py:94",
                   sum(p["flash_attention_bwd/wgmma"] for p in (
                       lm_train, lm_conv, lm_ckpt)),
                   [r for r in flash_bwd if r["route"] == ["wgmma"]],
                   flash_bwd[1]), bwd_route="wgmma"),
        dict(entry("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
                   "src/repro/models/layers.py:94",
                   hold_routes["flash_attention_bwd/simt"],
                   [r for r in flash_bwd if r["route"] == ["simt"]],
                   flash_bwd[2]), bwd_route="simt"),
        dict(entry("rwkv6_chunk_bwd", csrc + "rwkv6_chunk_bwd.cu",
                   "src/repro/models/layers.py:164",
                   sum(p["rwkv6_scan_bwd/chunk"] for p in (lm_train,
                                                          lm_ckpt)),
                   [r for r in scan_bwd if r["route"] == ["chunk"]],
                   scan_bwd[1]), bwd_route="chunk"),
        dict(entry("rwkv6_scan_bwd", csrc + "rwkv6_scan_bwd.cu",
                   "src/repro/models/layers.py:164",
                   hold_routes["rwkv6_scan_bwd/recurrence"],
                   [r for r in scan_bwd if r["route"] == ["recurrence"]],
                   scan_bwd[3]), bwd_route="recurrence"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
