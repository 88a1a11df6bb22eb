#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of k²-means on one NVIDIA GPU.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build the CUDA kernels from ``src/`` (the seven
   ports of the TPU kernels, the correct-rounding kernels of the torch
   paths, the ordered segment sums and the SSM scans; one ``nvcc`` per
   source, in parallel);
2. run the port's main path, ``repro_torch.core.fit(x, 1000,
   method="k2means", init="gdi", kn=30, max_iters=30)``, at the paper's
   mnist shape (n=60000, d=784) on GMM data made on the card from a
   seed, with every kernel's launch count set to 0 just before and read
   just after; check that every kernel of the fit launched, that the
   energy history is finite and non-increasing (rel 1e-6) and ends below
   the GDI init's energy; fit once more from the same generator seed and
   check that the two fits are bit-identical (assignments, centers,
   energy, iterations); check that GDI's split norms ran once per sweep
   and the centers' norms once per iteration; check a small fit from GDI
   against the plain PyTorch path;
2b. serve from that fit: ``KMeansModel.from_result(result, x)`` (K2
   builds the graph), then ``predict`` 65536 held-out rows of the same
   mixture at batch_size=8192 in f32 (resolution through K1) and in int8
   (K4 + an exact f32 re-rank), each after one warm-up call and with the
   counts set to 0 just before; check the launches, that the int8
   assignments equal the f32 ones, that every returned squared distance
   is the minimum over the routed center's neighborhood (rtol 1e-6), that
   the counted f32 distances per query stay within the dense budget, and
   a small predict against the plain PyTorch path; print queries/s,
   recall@1 against the brute-force argmin, host reads per call and peak
   device memory;
2f. (run right after 2b) the streaming model: ``KMeansModel.from_result
   (result, x, capacity=2n, window=4, half_life=8, count_floor=0.25,
   refresh_every=4, drift_guard=True)``, then the 65536 held-out rows as
   8 ``partial_fit`` batches of 8192 in f32 (K1) and in int8 (K4), counts
   set to 0 before each batch; from batch 5 the window evicts the
   training rows (``segment_sum_blocks``), K2 rebuilds the graph at each
   refresh; check after every batch the arena's and the stream's
   invariant counters, the live rows against the window's, the count
   floor and the launches; check that each int8 fold assigns what the
   int8 path gives on its state and that it parts from the f32 path only
   where the f32 route's stale bounds pruned a nearer center (ROADMAP §3
   entry 13); ``predict(stream=)`` cold, then warm on the same batch (1
   counted distance a warm row; rows whose best two tie stay cold), both
   equal to a cold predict; ``save`` under ``build/`` and ``restore``
   onto the card, both models then folding two more batches bit-
   identically; a small drifting stream with center repairs (K3 in the
   splits) on the card against the plain CPU path, bit for bit; print ms
   per batch (append and re-sort batches apart), rows/s, evictions,
   re-sorts, host reads per call, the warm and cold charges and
   queries/s, the checkpoint's seconds and bytes and peak device memory;
2g. (after 2f) the int8 fit arena: ``fit(..., precision="int8")`` from
   phase 2's generator seed, counts set to 0 just before: check it
   bit-identical to phase 2's f32 fit (assignments, centers, energy,
   iterations), K4 once per iteration and K1 never, int8 ops counted,
   fewer f32 distances, and moved rows at d + 16 bytes against 4 (d + 3);
   print ms per iteration beside phase 2's and K4's launches;
2h. fault tolerance at the mnist shape, from phase 2's GDI init: (a) a
   rebuild fit checkpointing every 3 iterations (under ``build/``),
   killed by ``FaultInjector(preempt_at=5)`` and resumed: check the
   assignment equal to the uninterrupted fit's and one restore; (b) a
   resident fit with ``guards=True`` under NaN rows, poisoned centers and
   poisoned slots: check the regroup and split rungs healed (K3 in the
   splits), the NaN rows quarantined, the result finite and guard-clean;
   (c) (b)'s kind of schedule on ROADMAP §3 entry 9's integer blobs (n =
   3000, d = 16, k = 48) on the card and on the CPU: check the same
   events, repairs and final assignment;
2i. the serving plane: a ``ServeExecutor`` over phase 2's model (predict
   only) takes a Poisson trace of the held-out queries (requests of 256
   rows, half the sustainable rate, a burst at 8x) under poisoned
   queries, a slow consumer and transient ``serve_predict`` failures,
   twice: check identical responses, rung transcripts and events, every
   request answered or typed, the ladder up to ROUTE_ONLY and back to
   FULL, retries and quarantined rows counted, FULL and INT8_SCAN answers
   equal to ``model.predict``'s, K1 and K4 launched; print the wall time
   per batch beside the virtual clock's;
2j. (after 2i) the rest of the single-device fit API at the mnist
   shape, counts set to 0 before each run: (a) ``fit(..., backend="xla",
   init="gdi")``, the host GDI loop then the ungrouped xla k²-means
   (rebuild): check that K3 and K2 launched and K1 never, the history
   finite and non-increasing (rel 1e-6), and a second run bit-identical;
   (b) from phase 2's GDI init, the xla resident fit against phase 2's
   fit and the xla rebuild fit against a kernels rebuild fit: identical
   assignments, centers and iterations, energies within rel 1e-6; (c)
   ``gdi_parallel_init`` at k = 1000 (K3 twice a round, K5 for the
   dropped leaves) and MiniBatch at its default passes from it (K5 every
   batch and evaluation); (d) AKM at m = 30 from phase 2's GDI init,
   capped at 20 iterations (K5 for the grouping and the routing), its
   history non-increasing; (e) each of (c) and (d) at n = 3000, d = 16,
   k = 48 on the card and on the CPU from one generator seed, bit for
   bit; print seconds, ms per iteration beside phase 2's, energies,
   counted ops and K5/K3 launches;
2k. (after 2j) the sharded fit (``launch.mesh``, ``core.distributed``):
   (a) four gloo ranks spawned on this card (NCCL refuses two ranks on
   one card), each drawing phase 2's rows again from the seed (15,000 a
   shard), run ``fit(mesh=, init="gdi")`` (the shard-aware seed, then
   the kernels backend resident) with the counts set to 0 just before:
   check K1, K2, K3 and the ordered sums launched on every rank and the
   history finite and non-increasing; then the sharded fit from phase
   2's GDI init centers, against phase 2's fit (assignments that
   differ, iterations, energy ratio) and against the single-card fit
   from the same start (energy within rel 1e-4), and the host reads of a
   3-iteration sharded fit (rank 0's device-to-host copies less gloo's
   staging of the gathers) equal to one card's; (b) that fit again,
   bit-identical; (c) a one-rank NCCL mesh equal to the single-device fit
   bit for bit; (d) at entry 9's blobs (n = 3000, d = 16, k = 48) four
   ranks on the card equal to four on the CPU bit for bit, with rank 1
   lost before iteration 5 keeping the fault-free result;
2c. the paper's baselines on the same rows: ``kmeanspp_init`` at k=1000,
   then ``fit(method="lloyd", init="kmeanspp")`` (every assignment step
   through K5) and ``fit(method="elkan", init="kmeanspp")`` for a few
   iterations, counts set to 0 just before each fit; print the k-means++
   seconds, ms per Lloyd iteration, the energies and the k²-means /
   Lloyd++ energy and counted-ops ratios, host reads per Lloyd iteration
   and inside the k-means++ loop; check that K5 launched once per Lloyd
   iteration, that Lloyd's energy history does not increase (rel 1e-6),
   ends at or below the k-means++ init's, that host reads are 1 per
   Lloyd iteration (+1 for the final energy) and 0 in k-means++, and that
   Elkan's first assignment equals Lloyd's first from the same centers;
2d. the assignment bench (the reference's ``benchmarks/assign_bench``
   check, on the card): K7 rowwise and K1 tiled over the k²-means fit's
   resident arena with the same per-block lists, counts set to 0 just
   before; check that both launched and agree;
2e. LM serving with k²-attention (``repro_torch.launch.serve.run``) at
   Qwen3-8B's full width (d_model 4096, 32 q-heads over 8 kv-heads,
   d_head 128, d_ff 12288, vocab 151,936, qk-norm) with the depth cut to
   4 of its 36 layers and random weights from a seed: 2 requests of a
   65,536-token random prompt are prefilled (chunked forward), decoded 64
   greedy tokens with full attention, then every layer's keys are
   clustered (kc 2048, cap 512) and the cache repacked cluster-major, and
   the same 64 tokens are decoded with k²-attention (top-p 16, ring 256,
   a fold of the ring every 32 steps), counts set to 0 just before; print
   the prefill and attach seconds, tokens dropped by full clusters, ms
   per decode token, token agreement, member rows absorbed by the folds,
   attention reads per token, peak device memory and host reads per
   decode step; the clustered decode and its folds go through the
   serving executor's envelope (``ex.call``); check that K6 launched
   once per layer per clustered token and nothing else launched, that
   every logit is finite, that host reads are 1 per decode step (also
   through the envelope), that every step and fold went through the
   executor, that a small serve (the smoke config in f32) on the card
   agrees with the plain CPU path, and that a short decode through the
   envelope equals the direct calls; print ms per token through the
   envelope beside direct calls on the same cache; then the flat-cache
   k²-attention variant: k²-means (kc 2048, cap 512) over every layer's
   prompt keys kept as member lists beside the flat cache
   (``serve.attach_member_lists``) and 8 greedy tokens through
   ``serve_step`` (the top-p clusters' rows gathered from the flat cache,
   each token filed by ``cluster_append``), counts set to 0 just before:
   check finite logits, 1 host read a step, no kernel launched (K6
   neither), and that the smoke config's flat variant in f32 (8 steps) on
   the card agrees with the plain CPU path; print the member lists'
   seconds, ms per token and the token agreement with the cluster-major
   decode's first 8 tokens;
2l. (after phase 3 and the profile, with phase 2e's model released) the
   MoE family at Arctic's full width (d_model 7168, 56 q-heads over 8
   kv-heads, d_head 128, 128 experts top-2, moe_d_ff 4864, a dense
   residual of d_ff 4864, vocab 32,000), depth cut to 2 of its 35 layers,
   random weights from the seed: as phase 2e, with 2 requests of a
   32,768-token prompt; print the allocated memory at the start, init,
   prefill and attach seconds, tokens dropped by full clusters, ms per
   token full and clustered, token agreement, peak device memory, host
   reads per decode step and the bytes bound of a decode step's expert
   products; check K6 once per layer per clustered token and nothing
   else, finite logits, 1 host read a step, every step and fold through
   the executor; then seed a GDI router (``moe.gdi_router_init``) over
   request 0's embedded prompt (32,768 x 7168 f32, 128 experts): check
   its shape, unit columns (rtol 1e-6), K3 launched twice a round and K5
   never, the card's router equal to the plain CPU path's from the same
   generator bit for bit, and the first and the last round's K3 launches
   (7 column slices of 1024) held against K3's plain version as phase 3
   holds K3; print its seconds and layer 0's aux and pairs dropped by
   the chunked forward's capacity on the normed embeddings under the
   random router and under GDI's (the serve prefill routes each
   position's tokens as a decode step does and drops none); check a
   small GDI router and Arctic's smoke config in f32 on
   the card against the plain CPU path (the router bit for bit, the
   logits within 1e-4 of their largest magnitude);
2m. (after phase 2l, with its model released) MLA: DeepSeek-V2-Lite at
   the reference config's full width and depth, no cut (27 layers: a
   dense GQA first layer of 16 kv-heads and d_ff 1408, then 26 MLA + MoE
   layers, d_model 2048, 16 heads, kv_lora 512, nope 128, rope 64, v 128,
   64 experts top-6, 2 shared, moe_d_ff 1408, vocab 102,400), random
   weights from the seed, through ``serve.run``: 2 requests of a
   32,768-token prompt prefilled by the chunked forward, 64 greedy tokens
   with full attention over the latent cache (k²-attention does not
   apply to it), counts set to 0 just before; print the allocated memory
   at the start, init and prefill seconds, ms per decode token, peak
   device memory, the latent cache's bytes beside a same-head GQA
   cache's, host reads per decode step and the bytes bound of a step's
   expert products (all 64 experts of 26 layers); check finite logits, 1
   host read a step, no kernel launched, the parameter count against
   ``params_estimate`` (with the dense first layer counted as such, the
   routers and norms), and DeepSeek's smoke config in f32 on the card
   against the plain CPU path (prefill and 8 decode steps, logits within
   1e-4 of their largest magnitude);
2n. (after phase 2m, with its model released) RWKV6: RWKV6-3B at the
   reference config's full width and depth, no cut (32 layers, d_model
   2560, 40 heads of 64, d_ff 8960, vocab 65,536), random weights from
   the seed, through ``serve.run``: 2 requests of a 32,768-token prompt
   prefilled by the chunked forward (each layer's time loop one
   ``wkv6_scan`` launch), 32 greedy tokens over the recurrent state (one
   launch a layer a step), counts set to 0 just before; print the
   allocated memory at the start, init and prefill seconds, ms per decode
   token, peak device memory, the state's bytes, host reads per decode
   step, and ``wkv6_scan``'s time a layer at the prefill's shape (CUDA
   events) beside its bound; check the launches, finite logits, 1 host
   read a step, the parameter count against ``params_estimate`` (made up
   for the terms it leaves out), the serve prefill of the first 64 tokens
   against ``serve_step`` stepped over them (every cache field within rel
   1e-3), and the smoke config in f32 on the card against the plain CPU
   path;
2o. (after 2n) the hybrid: Zamba2-7B at the reference config's full
   width and depth (81 Mamba2 layers, d_model 3584, 32 heads, P 224, N
   64; the shared attention + MLP block every 6 layers, 14 applications,
   32 kv-heads of 112, d_ff 14,336; vocab 32,000), as 2n with 2 x 16,384
   prompt tokens (one ``ssd_scan`` launch a layer), then the shared
   block's cache clustered (``serve.attach_clusters``: kc 256, cap 256,
   top-p 16 -- serving knobs: the config's 2048 x 512 would take 421 GB
   for 14 applications) and the same 32 tokens decoded with k²-attention
   without folds (K6 once an application a step, through the executor);
   print also the attach seconds, tokens dropped by full clusters, full
   and clustered ms per token and the token agreement; check also K6's
   launches and the rings; the smoke config's clustered decode in f32 on
   the card against the plain CPU path;
2p. (after 2o, with its model released) the audio family: Whisper-base
   whole (6 encoder and 6 decoder layers, d_model 512, 8 heads of 64,
   d_ff 2048, vocab 51,865), random weights from the seed, through
   ``serve.run``: 64 utterances of 1500 frames (30 s) drawn from the
   seed, encoded (the cross keys and values of every decoder layer
   written into the cache), a 224-token prompt prefilled, 32 greedy
   tokens with full attention, then the decoder's self-attention cache
   clustered at kc 32, cap 32, top-p 4 (serving knobs: the config's 2048
   x 512 would take 137 GB a layer at 64 utterances) and 32 tokens with
   k²-attention, a fold every 16, counts set to 0 just before; print
   init, encode, prefill and attach seconds, tokens dropped, ms per token
   full and clustered, the parameter count against ``params_estimate``,
   the cross K/V bytes, peak memory and host reads a step; check K6 once
   a layer a clustered token and nothing else, finite logits, the folds,
   1 host read a step, every step and fold through the executor, the
   parameter count made up (the cross attention and the norms), the
   cross cache kept through the clustering, the chunked prefill of the
   first 32 tokens against ``serve_step`` stepped over them (f32, every
   cache field within rel 1e-3) and the smoke config card = CPU;
2q. (after 2p) the VLM family: InternVL2-76B's LLM at full width
   (d_model 8192, 64 q-heads over 8 kv-heads of 128, d_ff 28,672, vocab
   128,256), depth cut to 4 of its 80 layers, through ``serve.run``: 2 x
   32,768 prompt positions whose first 256 are patch rows drawn from the
   seed, then as phase 2e (64 tokens full and clustered at kc 2048, cap
   512, top-p 16, folds every 32); print as phase 2e, the parameter
   count, peak memory and K6's device time at a GQA group of 8 beside its
   bound; check as phase 2e, the parameter count (with the norms), the
   patched chunked prefill of the first 300 positions against a stepped
   one (f32, rel 1e-3) and the smoke config card = CPU;
2r. (after 2q, with its model released) LM training: Qwen3-8B at full
   width (d_model 4096, 32 q-heads over 8 kv-heads of 128, d_ff 12,288,
   vocab 151,936, the embedding tied) cut to 4 of 36 layers, random
   weights from the seed, ``launch.train.make_train_step`` (autograd
   through ``forward_train`` with remat "dots" and q_chunk 512, clipping,
   AdamW) through ``ft.FaultTolerantLoop`` at B x S = 4 x 2048 on
   ``ShardedBatcher`` tokens: run A trains 8 steps with a checkpoint
   (params and AdamW state) under ``build/train_ckpt``, the job's
   directory, at step 4, written in the background; run B trains from
   the same init, is preempted at step 6 and resumes from the job's
   newest checkpoint (step 4) to step 8; then one step with int8 gradient
   compression, counts set to 0 just before run A; print the allocated
   memory at the start, init seconds, ms a step and tokens/s, peak device
   memory, the step's FLOPs and their share of the card's peak, the
   unembedding's share of the FLOPs, host reads a step and the
   checkpoint's bytes; check finite losses and gradient norms, the params
   moving, no kernel launched, the resumed run ending on run A's params
   and AdamW state bit for bit (and replaying its losses) and 1 host read
   a step;
2s. (after 2r) the SSM families' training: RWKV6-3B cut to 4 of 32 layers
   and Zamba2-7B cut to 7 of 81 (two applications of the shared block),
   full width, B x S = 2 x 4096, 4 steps each, counts set to 0 just
   before; each layer's scan runs through the ``ssm_scan`` autograd
   Functions: the forward kernel (saving the state every 64 steps), again
   when the backward recomputes the layer, and the backward kernel
   (``wkv6_scan_bwd``, ``ssd_scan_bwd``); print ms a step, tokens/s, peak
   memory and each backward kernel's launches and time a layer at the
   training shape beside its bound; check finite losses and the launches;
   then every arch's smoke config, one forward and backward in f32 on the
   card against the CPU (the loss rel 1e-5, every gradient leaf within
   1e-4 of its largest magnitude);
2t. (after 2s) the sharded k²-attention decode: Qwen3-8B at full width cut
   to 2 of 36 layers, random weights from the seed, 2 x 16,384-token
   prompts, the config's kc 2048 x cap 512 x top-p 16; each rank's bytes
   reckoned and printed; one device's clustered decode of 32 tokens (the
   parent), the same decode teacher-forced with the merge reordered as the
   shards merge it (its gap to one device sets the tolerance) and K6 on a
   shard's layer-0 tables with its remote selections (ids -1, a head's
   whole selection among them) against its plain version; then four gloo
   ranks sharing the card (``run_local``), each ``serve.run(mesh=)``
   (prefill, 32 tokens full, the clustering with its 512 clusters
   packed, 32 clustered tokens, no folds) and the clustered decode
   teacher-forced over one device's tokens twice; check each layer's
   attention output at the first step within one bf16 ulp of one
   device's, every step's logits within max(2e-2, 1.5 x the reordered
   gap) of their largest, K6 once a layer a token on each rank, host
   reads a step as one device's (gloo's staging apart), the merge's bytes
   a rank a token equal ``dryrun.decode_merge_bytes``, two runs
   bit-identical; print the free-running agreement and peak memory;
2u. (after 2t) ZeRO-1 training: Qwen3-8B at full width cut to 2 of 36
   layers, four gloo ranks sharing the card, 1 x 2048 tokens a rank, remat
   "dots"; the parent first trains 3 steps on one device over the four
   shards' batches concatenated in shard order, and again with the batch's
   gradient taken as the four shards' gradients added in shard order (the
   sharded step's reordering); then each rank trains 3 steps, the first
   step again and one compressed step; check the losses and rank 0's
   params within 1.5 x the reordered run's gap of one device's, the
   bytes a rank sends a step equal ``dryrun.zero_step_bytes``, the first
   step again bit-identical and every rank the same params, the
   compressed step finite; print ms a step, tokens/s and each rank's
   peak memory;
2v. (after 2u) the analyzer on the card (``repro_torch.analysis.cli.run``,
   every pass, the report under ``build/``): no blocking finding; every
   ``LAUNCHES`` key launched by the kernel pass and each of its cases'
   plans read (``k2_plan_*``) with its dynamic shared memory within the
   card's opt-in limit; for the resident step and the k²-attention decode
   step, the audit's host reads equal the profiler's device-to-host
   copies on the same call; print one JSON line a case (kernel, variant,
   grid, threads, dynamic shared memory, registers, spill bytes, resident
   blocks an SM) and the findings by rule (~20 s);
3. hold each kernel against its plain version on tensors of those runs
   (K2 on the final centers, bit-equal, and the k_n-NN graph on the card
   equal to the CPU's; K1 over the final resident arena with no
   block skipped and over one predict batch's grouped layout, K3 on the
   GDI leaf-grouped layout and on one segment over every block, each
   launched twice and held bit-equal to itself, K4 on one int8 predict
   batch and over the int8 fit arena (bn = 32, every block; with the
   re-rank's ``slab_sqdist`` timed beside it), K5 on x and the Lloyd++
   centers, K7 over the arena, K6 on
   layer 0's cluster-major tables at a decode step of phase 2e and, after
   phase 2l, of phase 2l (a GQA group of 7 where phase 2e's is 4),
   launched twice and held bit-identical to itself; K1, K5 and K7 also on
   ``data.rounding_fixture`` rows, whose own-center products sit at f32
   rounding midpoints, and K2 on those rows and centers as one center
   set; the rounding kernels on the final centers, GDI's split norms on
   the GDI layout, a predict batch's products with the centers and with
   the router's centroids; the ordered segment sums over the final arena,
   at the second fit's delta call over the most moved rows and at phase
   2f's first eviction delta) and
   time both with CUDA events (and, after phases 2n and 2o, each scan
   kernel on 256 steps of layer 0's prefill inputs and at S = 1 from the
   state after them, its final state bit-equal to its plain version's and
   its outputs within 1e-5 of their sum of absolute terms, K6 on its
   arguments at a clustered decode step of phase 2o, dh = 112, and, after
   phases 2p and 2q, K6 on their layer-0 tables: dh = 64 with cap 32 and
   a GQA group of 1, and dh = 128 at a GQA group of 8; after phase 2s,
   each backward kernel on 256 steps of layer 0's training inputs with a
   seeded random output gradient, launched twice and bit-identical, every
   gradient within 1e-5 of its sum of absolute terms of autograd through
   the plain version, and timed beside that autograd backward), beside one
   library call where one
   computes the same function and beside the least time the card could
   take (bytes over 3.35 TB/s, or operations over the H100 SXM data
   sheet's peak for their type: 67 TFLOP/s FP32 and FP64 tensor, 1979
   TOP/s int8); K6
   and its yardsticks are timed with the L2 cache flushed before each
   launch, as a decode step finds it (the other layers' weights pass
   through it in between); K4, K6 and K7 also with the profiler's device
   time (``device_ms`` in their entries), since events around a short
   kernel also time its launcher's host work;
4. print the kernels' JSON line (``launches_stream``: a kernel's launches
   in phase 2f's 8 batches, K4's in its int8 leg; ``launches_exec``: in
   phase 2i's first run; ``launches_per_shard``: each rank's in phase
   2k's ``fit(mesh=)``, null on a row for one call site of a wrapper,
   whose launches are counted with the wrapper's), then
   ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` adds one ``partial_fit`` batch in
phase 2f and, after phase 3, the fit, one predict in each precision, one
Lloyd++ fit, and phase 2e's full and k²-attention decode (8 steps each)
and a ring fold, in phase 2l its full and k²-attention decode (4
steps each), in phase 2m 4 full-attention decode steps, in phases
2n and 2o one decode step, and in phases 2p and 2q their full and
k²-attention decode (4 steps each), under
``torch.profiler``:
device time by kernel, the device's busy share of the host clock, and
the host synchronisations.
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N, D, K, KN, TRUE_K, MAX_ITERS, SEED = 60000, 784, 1000, 30, 128, 30, 0
BKN = 8
MESH_RANKS = 4                     # phase 2k: gloo ranks sharing the card
NQ, BATCH = 65536, 8192            # held-out queries, predict batch size
LLOYD_ITERS, ELKAN_ITERS = 300, 5   # Lloyd++ runs to convergence here
# phase 2e: Qwen3-8B's width, depth cut to 4 of 36 layers
LM_ARCH, LM_LAYERS, LM_BATCH, LM_PROMPT, LM_DECODE, LM_FOLD = (
    "qwen3-8b", 4, 2, 65536, 64, 32)
# phase 2l: Arctic's width (128 experts, top-2, a dense residual), depth cut
# to 2 of 35 layers; 32,768-token prompts keep the prefill's MoE buffers
# (C = 1,280 slots an expert) and the cluster tables within the card
MOE_ARCH, MOE_LAYERS, MOE_PROMPT = "arctic-480b", 2, 32768
# phase 2m: DeepSeek-V2-Lite whole (27 layers at full width), 32,768-token
# prompts (V2-Lite's published context)
MLA_ARCH, MLA_PROMPT = "deepseek-v2-lite-16b", 32768
# phase 2e's flat-cache k²-attention variant: decode steps
FLAT_DECODE = 8
# phases 2n and 2o: RWKV6-3B and Zamba2-7B whole (every layer at full
# width), 32 decode tokens; Zamba2's shared block's cluster tables at kc
# 256 x cap 256 (65,536 slots a head, 4x the prompt: the config's 2048 x
# 512 would take 421 GB for its 14 applications); phase 3's scan checks
# over 256 steps of layer 0's prefill inputs, and the stepped prefill
# check over the first 64 tokens
SSM_PROMPT = {"rwkv6-3b": 32768, "zamba2-7b": 16384}
SSM_DECODE, SSM_KC, SSM_CAP, SSM_TOP_P = 32, 256, 256, 16
SSM_SCAN_STEPS, SSM_STEPPED = 256, 64
# phase 2p: Whisper-base whole (6 encoder and 6 decoder layers at full
# width): 64 utterances of 1500 frames (30 s), a 224-token prompt (half
# the 448-token text context), 32 tokens full and clustered at kc 32 x cap
# 32 x top-p 4 (serving knobs: the config's 2048 x 512 would take 137 GB a
# layer at B = 64), a fold every 16; the stepped prefill check over the
# first 32 prompt tokens
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES, AUDIO_PROMPT, AUDIO_DECODE = (
    "whisper-base", 64, 1500, 224, 32)
AUDIO_KC, AUDIO_CAP, AUDIO_TOP_P, AUDIO_FOLD, AUDIO_STEPPED = 32, 32, 4, 16, 32
# phase 2q: InternVL2-76B's LLM at full width, cut to 4 of 80 layers (6
# would not fit the card); 2 x 32,768 prompt positions (the repo's
# prefill_32k), the first 256 patch rows; phase 2e's decode, folds and
# k²-attention knobs (the config's); the stepped prefill check over the
# first 300 positions
VLM_ARCH, VLM_LAYERS, VLM_PROMPT, VLM_STEPPED = "internvl2-76b", 4, 32768, 300
# phase 2r: Qwen3-8B trained at full width, depth cut to 4 of 36 layers (as
# phase 2e), B x S = 4 x 2048, remat "dots", q_chunk 512: 8 steps with a
# checkpoint at step 4, then a run preempted at step 6 and resumed from its
# step-4 checkpoint, then one step with int8 gradient compression
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = (
    "qwen3-8b", 4, 4, 2048, 8)
TRAIN_CKPT_AT, TRAIN_FAIL_AT = 4, 6
# phase 2s: RWKV6-3B (4 of 32 layers) and Zamba2-7B (7 of 81 layers, two
# applications of the shared block) trained at full width, B x S = 2 x
# 4096, 4 steps each
SSM_TRAIN = {"rwkv6-3b": 4, "zamba2-7b": 7}
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 4096, 4
# phase 2t: the sharded k²-attention decode, Qwen3-8B at full width cut to
# 2 of 36 layers, 2 x 16,384-token prompts, the config's kc 2048 x cap 512 x
# top-p 16 over MESH_RANKS gloo ranks sharing the card, 32 tokens full then
# clustered, no folds
LMM_LAYERS, LMM_BATCH, LMM_PROMPT, LMM_DECODE = 2, 2, 16384, 32
# phase 2u: ZeRO-1 training of Qwen3-8B at full width cut to 2 of 36 layers
# over MESH_RANKS gloo ranks sharing the card, 1 x 2048 tokens a rank, 3
# steps, the first again and one compressed step (gloo stages each rank's
# 2.5 GB of gradients and blocks a step through the host: ~10 s a step)
ZERO_LAYERS, ZERO_SEQ, ZERO_STEPS = 2, 2048, 3
# phase 2f: the streaming model (window in epochs = partial_fit batches)
STREAM_WINDOW, STREAM_HALF_LIFE, STREAM_FLOOR, STREAM_REFRESH = 4, 8.0, 0.25, 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, FP32 outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM, bf16 tensor cores (dense)
FP64_TC_FLOP_PER_S = 67e12         # H100 SXM, FP64 tensor cores
INT8_OP_PER_S = 1979e12            # H100 SXM, int8 tensor cores (dense)

FIT_KERNELS = ("center_sqdist", "candidate_assign_tiled", "segmented_scan",
               "segment_sum_blocks", "exact_sqnorm", "exact_split_sqnorms",
               "exact_rowdot")

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, torch, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, ops: float,
          ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import (K2Step, KMeansModel, OpCounter,
                                      center_knn_graph, clustering_energy,
                                      fit, fit_elkan, fit_k2means, fit_lloyd,
                                      initialize, kmeanspp_init)
        from repro_torch.core import engine
        from repro_torch.core.model import _RESOLVE_RERANK as rerank
        from repro_torch.data import gmm_blobs, rounding_fixture
        from repro_torch.kernels import _build, exact_round, ref
        from repro_torch.kernels.candidate_assign import (
            candidate_assign_int8_tiled, candidate_assign_rowwise,
            candidate_assign_tiled, candidate_tables, pad_candidates)
        from repro_torch.kernels.center_knn import center_sqdist
        from repro_torch.kernels.distance_argmin import distance_argmin
        from repro_torch.kernels.ops import assign_nearest_kernel
        from repro_torch.kernels.ops import (choose_group_bn,
                                             group_by_cluster_device)
        from repro_torch.kernels.segment_sum import segment_sum_blocks
        from repro_torch.kernels.segmented_scan import segmented_scan
        from repro_torch.kernels.cluster_attend import cluster_attend_partial
        from repro_torch.launch import serve
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    # --- 1. the card, the versions, the build ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"phase 1: built {sorted(took)} in "
          f"{time.perf_counter() - t0:.1f} s (per source: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # --- 2. the main path -----------------------------------------------
    dev = torch.device("cuda")
    # the training rows and the held-out queries: one draw from the
    # mixture, split
    allx = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    x, queries = allx[:N], allx[N:]
    # the GDI init on its own: its energy is the bar the fit must clear;
    # it and two iterations from it warm the path up before the timed run
    c0, a0 = initialize(x, K, "gdi",
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        OpCounter())
    e_init = float(clustering_energy(x, c0, a0))
    fit_k2means(x, c0, a0, kn=KN, max_iters=2, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = fit(x, K, method="k2means", init="gdi", kn=KN,
              max_iters=MAX_ITERS, device=dev, profile=True,
              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    launches = _build.launches()
    hist = [e for _, e in res.history]
    print(f"phase 2: fit n={N} d={D} k={K} kn={KN}: GDI "
          f"{res.profile['init_s']:.3f} s, {res.iterations} iterations, "
          f"{res.profile['iterate_s'] / max(res.iterations, 1) * 1e3:.2f} "
          f"ms/iteration, energy {res.energy:.6g} (GDI init {e_init:.6g}), "
          f"launches {launches}")
    print(f"  counted ops {res.profile['total_ops']:.6g}, layout bytes "
          f"{res.profile['bytes_moved']:.6g}, resorts "
          f"{res.profile['resorts']:.0f}")
    for name in FIT_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in the fit ({launches[name]})")
    # one GDI sweep is one K3 scan and one pass of its split norms; the
    # centers' norms once per k²-means iteration (the candidate tables)
    check(launches["exact_split_sqnorms"] == launches["segmented_scan"]
          and launches["exact_sqnorm"] == res.iterations,
          f"exact_split_sqnorms once per GDI sweep "
          f"({launches['exact_split_sqnorms']} for "
          f"{launches['segmented_scan']} K3 sweeps), exact_sqnorm once per "
          f"iteration ({launches['exact_sqnorm']} for {res.iterations})")
    check(res.centers.shape == (K, D) and res.assignment.shape == (N,),
          "result shapes")
    check(bool(torch.isfinite(res.centers).all()), "centers finite")
    a_min, a_max = int(res.assignment.min()), int(res.assignment.max())
    check(0 <= a_min and a_max < K, "assignment in [0, k)")
    check(len(hist) == res.iterations and all(map(_finite, hist)),
          "energy history finite, one entry per iteration")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
          "energy history non-increasing (rel 1e-6)")
    check(res.energy < e_init, "final energy below the GDI init's")
    # the second fit also records the engine's delta sums (phase 3 holds
    # the one over the most moved rows against its plain version)
    deltas = []
    engine_sums = engine.segment_sum_blocks

    def record(xx, b2s, k, bn, *, w=None, perm=None):
        if bn == 1:
            deltas.append(((xx.clone(), b2s.clone(), k, bn),
                           dict(w=w.clone(), perm=perm.clone())))
        return engine_sums(xx, b2s, k, bn, w=w, perm=perm)
    engine.segment_sum_blocks = record
    try:
        again = fit(x, K, method="k2means", init="gdi", kn=KN,
                    max_iters=MAX_ITERS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 1))
    finally:
        engine.segment_sum_blocks = engine_sums
    same = (bool(torch.equal(again.assignment, res.assignment))
            and bool(torch.equal(again.centers, res.centers))
            and again.energy == res.energy
            and again.iterations == res.iterations)
    check(same, f"the fit again from the same seed is bit-identical: "
                f"{int((again.assignment != res.assignment).sum())} "
                f"assignments differ, centers equal "
                f"{bool(torch.equal(again.centers, res.centers))}, energy "
                f"{again.energy:.9g} vs {res.energy:.9g}, iterations "
                f"{again.iterations} vs {res.iterations}")
    del again
    _small_fit_agrees(torch, dev, fit_k2means, check)
    _small_gdi_fit_agrees(torch, dev, fit_k2means, check)

    # --- 2b. the served model: predict in f32 and int8 ------------------
    torch.cuda.synchronize()
    _build.reset_launches()
    model = KMeansModel.from_result(res, x, kn=KN, device=dev)
    torch.cuda.synchronize()
    built = _build.launches()
    check(built["center_sqdist"] > 0,
          f"center_sqdist launched at the model build ({built})")
    dense = model.dense_distances_per_query()
    print(f"phase 2b: model k={model.k} kn={model.kn} route_groups="
          f"{model.route_groups} route_cap={model.route_cap} probes="
          f"{model.route_probes}, dense distances per query {dense}, arena "
          f"bn={model.bn} capacity={model.capacity}")
    served = {}
    for prec, kernel in (("f32", "candidate_assign_tiled"),
                         ("int8", "candidate_assign_int8_tiled")):
        model.predict(queries, batch_size=BATCH, precision=prec)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counter = OpCounter()
        _build.reset_launches()
        t0 = time.perf_counter()
        a, dist = model.predict(queries, batch_size=BATCH, precision=prec,
                                counter=counter, return_sqdist=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _build.launches()
        peak = torch.cuda.max_memory_allocated() - base
        reads = _host_reads(torch, lambda: model.predict(
            queries, batch_size=BATCH, precision=prec))
        served[prec] = dict(a=a, d=dist, counter=counter, launches=got)
        print(f"  predict {prec}: {NQ / secs:.1f} queries/s ({secs:.4f} s "
              f"for {NQ}, batch {BATCH}), counted f32 distances "
              f"{counter.distances / NQ:.3f}/query, int8 ops "
              f"{counter.int8_ops / NQ:.1f}/query, scan bytes "
              f"{counter.bytes_scanned / NQ:.1f}/query, host reads {reads} "
              f"per call, peak device memory +{peak / 2 ** 20:.1f} MiB, "
              f"launches {got}")
        check(got[kernel] > 0 and got["exact_cross"] > 0,
              f"{kernel} and exact_cross (the router's rounding) launched "
              f"by predict({prec}) ({got[kernel]}, {got['exact_cross']})")
        check(counter.distances / NQ <= dense,
              f"predict({prec}) counted f32 distances per query "
              f"{counter.distances / NQ:.3f} <= dense {dense}")
    f32, i8 = served["f32"], served["int8"]
    print(f"  int8 / f32 counted f32 distances: "
          f"{i8['counter'].distances / f32['counter'].distances:.4f}; scan "
          f"bytes {i8['counter'].bytes_scanned / f32['counter'].bytes_scanned:.4f}")
    check(bool(torch.equal(f32["a"], i8["a"])),
          f"int8 assignments equal the f32 ones "
          f"({int((f32['a'] != i8['a']).sum())} differ)")
    routed = model.route(queries)
    want_d = _neighborhood_min(torch, queries, model.centers,
                               model.neighbors[routed.long()])
    for prec in ("f32", "int8"):
        got_d = served[prec]["d"]
        rel = float(((got_d - want_d).abs() / want_d.clamp(min=1e-30)).max())
        check(bool(((got_d - want_d).abs() <= 1e-6 * want_d).all()),
              f"predict({prec}) distances are the minimum over the routed "
              f"neighborhood: max rel err {rel:.3g} (rtol 1e-6)")
    truth, _ = assign_nearest_kernel(queries, model.centers)
    print(f"  recall@1 against the brute-force argmin: "
          f"{float((f32['a'] == truth).float().mean()):.6f}")
    _small_predict_agrees(torch, dev, fit_k2means, KMeansModel, OpCounter,
                          check)

    # --- 2f. the streaming served model: partial_fit, checkpoints -------
    t0 = time.perf_counter()
    print(f"phase 2f: streaming model from the fit (capacity {2 * N}, "
          f"window {STREAM_WINDOW}, half-life {STREAM_HALF_LIFE}, floor "
          f"{STREAM_FLOOR}, refresh every {STREAM_REFRESH}, drift guard) "
          f"over the {NQ} held-out rows in batches of {BATCH}")
    stream = _stream_phase(torch, dev, res, x, queries, check)
    print(f"  phase 2f wall {time.perf_counter() - t0:.1f} s")

    # --- 2g. the int8 fit arena (K4 on the fit) -------------------------
    t0 = time.perf_counter()
    fit8 = _int8_fit_phase(torch, dev, x, res, check)
    print(f"  phase 2g wall {time.perf_counter() - t0:.1f} s")

    # --- 2h. fault tolerance: resume, a chaos fit, card against CPU ------
    t0 = time.perf_counter()
    _ft_phase(torch, dev, x, check)
    print(f"  phase 2h wall {time.perf_counter() - t0:.1f} s")

    # --- 2i. the serving plane over phase 2's model ---------------------
    t0 = time.perf_counter()
    served_exec = _serve_phase(torch, dev, res, queries, check)
    print(f"  phase 2i wall {time.perf_counter() - t0:.1f} s")

    # --- 2j. the rest of the fit API: xla, host GDI, MiniBatch, AKM -----
    t0 = time.perf_counter()
    _methods_phase(torch, dev, x, res, check)
    print(f"  phase 2j wall {time.perf_counter() - t0:.1f} s")

    # --- 2k. the mesh: the sharded fit over ranks sharing this card -----
    t0 = time.perf_counter()
    mesh_launches = _mesh_phase(torch, dev, x, res, check)
    print(f"  phase 2k wall {time.perf_counter() - t0:.1f} s")

    # --- 2c. the paper's baselines: k-means++, Lloyd++ and Elkan --------
    def pp_gen():
        return torch.Generator(device=dev).manual_seed(SEED + 2)
    kmeanspp_init(x, 8, pp_gen())                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_pp = kmeanspp_init(x, K, pp_gen())
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    pp_reads = _host_reads(torch, lambda: kmeanspp_init(x, K, pp_gen()))
    e_pp = float(assign_nearest_kernel(x, c_pp)[1].sum())
    # Lloyd's first assignment (and the warm-up of its path) and Elkan's
    # initial one, from the same centers
    lloyd1 = fit_lloyd(x, c_pp, max_iters=1, device=dev).assignment
    elkan0 = fit_elkan(x, c_pp, max_iters=0, device=dev).assignment
    torch.cuda.synchronize()
    _build.reset_launches()
    res_l = fit(x, K, method="lloyd", init="kmeanspp", max_iters=LLOYD_ITERS,
                device=dev, profile=True, generator=pp_gen())
    torch.cuda.synchronize()
    l_launch = _build.launches()
    hist_l = [e for _, e in res_l.history]
    lloyd_ms = res_l.profile["iterate_s"] / res_l.iterations * 1e3
    lloyd_reads = _host_reads(torch, lambda: fit_lloyd(x, c_pp, max_iters=3,
                                                       device=dev))
    torch.cuda.synchronize()
    _build.reset_launches()
    res_e = fit(x, K, method="elkan", init="kmeanspp", max_iters=ELKAN_ITERS,
                device=dev, profile=True, generator=pp_gen())
    torch.cuda.synchronize()
    e_launch = _build.launches()
    print(f"phase 2c: k-means++ k={K}: {pp_s:.4f} s "
          f"({res_l.profile['init_s']:.4f} s inside fit), host reads "
          f"{pp_reads} in the whole init; energy {e_pp:.6g}")
    print(f"  Lloyd++: {res_l.iterations} iterations (cap {LLOYD_ITERS}), "
          f"{lloyd_ms:.3f} ms/iteration, energy {res_l.energy:.6g}, counted "
          f"ops {res_l.ops:.6g}, host reads {lloyd_reads} for 3 iterations, "
          f"launches {l_launch}")
    ops_l = res_l.history[min(res_e.iterations, res_l.iterations) - 1][0]
    print(f"  Elkan++: {res_e.iterations} iterations, "
          f"{res_e.profile['iterate_s'] / max(res_e.iterations, 1) * 1e3:.3f} "
          f"ms/iteration, energy {res_e.energy:.6g}, counted ops "
          f"{res_e.ops:.6g} (Lloyd++ after as many iterations: "
          f"{ops_l:.6g}), launches {e_launch}")
    print(f"  k2-means (phase 2) / Lloyd++: energy "
          f"{res.energy / res_l.energy:.6f}, counted ops "
          f"{res.ops / res_l.ops:.6f}")
    # K5 once per Lloyd iteration, each with its |c|^2 rounding; the
    # k-means++ init rounds |x|^2 once and each chosen center's products
    # and norm once
    want_l = {"distance_argmin": res_l.iterations,
              "exact_sqnorm": res_l.iterations + K + 1, "exact_rowdot": K}
    check(all(l_launch[name] == v for name, v in want_l.items())
          and sum(l_launch.values()) == sum(want_l.values()),
          f"distance_argmin (K5) launched once per Lloyd iteration and "
          f"only the rounding kernels beside it ({l_launch} for "
          f"{res_l.iterations} iterations, k={K})")
    check(len(hist_l) == res_l.iterations and all(map(_finite, hist_l)),
          "Lloyd energy history finite, one entry per iteration")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(hist_l, hist_l[1:])),
          "Lloyd energy history non-increasing (rel 1e-6)")
    check(abs(hist_l[0] - e_pp) <= 1e-6 * e_pp,
          "the fit's k-means++ drew the same centers (first Lloyd energy = "
          "the init's, rel 1e-6)")
    check(res_l.energy <= e_pp, "Lloyd++ energy <= the k-means++ init's")
    check(pp_reads == 0, f"no host read inside k-means++ ({pp_reads})")
    check(lloyd_reads == 3 + 1, f"host reads: 1 per Lloyd iteration + 1 for "
                                f"the final energy ({lloyd_reads} for 3)")
    check(bool(torch.equal(lloyd1, elkan0)),
          f"Elkan's first assignment equals Lloyd's first from the same "
          f"centers ({int((lloyd1 != elkan0).sum())} differ)")
    check(_finite(res_e.energy) and res_e.assignment.shape == (N,),
          "Elkan's result finite and of the expected shape")

    # --- 2d. the assignment bench: K7 rowwise beside K1 tiled -----------
    c = res.centers.contiguous()
    sb = K2Step(k=K, kn=KN, bkn=BKN)
    args, args7, bn, k7_bound = k7_inputs(torch, x, c, res.assignment)
    s_rows, nb = args[0].shape[0], args[4].shape[0]
    torch.cuda.synchronize()
    _build.reset_launches()
    a_t, d_t, _ = candidate_assign_tiled(*args, bn=bn, bkn=BKN)
    a_r, d_r = candidate_assign_rowwise(*args7, bn=bn)
    torch.cuda.synchronize()
    bench = _build.launches()
    print(f"phase 2d: assignment bench over the resident arena ({s_rows} "
          f"rows, bn={bn}, {nb} blocks, kn={KN}): launches {bench}")
    check(bench["candidate_assign_rowwise"] == 1
          and bench["candidate_assign_tiled"] == 1,
          "candidate_assign_rowwise (K7) and candidate_assign_tiled (K1) "
          "launched by the bench")
    check(bool(torch.equal(a_t, a_r)) and bool(torch.equal(d_t, d_r)),
          f"K7 rowwise equals K1 tiled on the same lists (assign_bench's "
          f"check): {int((a_t != a_r).sum())} assignments differ")

    # --- 2e. LM serving with k²-attention at Qwen3-8B's width ----------
    t0 = time.perf_counter()
    lm = _lm_serve(torch, dev, serve, check)
    print(f"  phase 2e wall {time.perf_counter() - t0:.1f} s")

    # --- 3. each kernel against its plain version -----------------------
    kernels = []

    # K2: center_sqdist on the final centers, bit-equal to its plain
    # version; the k_n-NN graph built on the card is the CPU's. Its bound:
    # the k (k + 1) / 2 products of the upper triangle (the matrix is
    # symmetric; its diagonal products are the norms), on the f64 tensor
    # cores, and one read of c and one write of the matrix
    kernels.append(_against_plain(
        torch, check, f"K2 center_sqdist on the final centers ({K} x {D})",
        functools.partial(center_sqdist, c),
        functools.partial(ref.center_sqdist_ref, c),
        dict(name="center_sqdist",
             source="src/repro_torch/kernels/csrc/center_knn.cu",
             replaces="src/repro/kernels/center_knn.py:26",
             launches=launches["center_sqdist"],
             launches_stream=stream["launches"]["center_sqdist"]),
        bound((K * D + K * K) * 4.0, K * (K + 1) / 2 * 2.0 * D,
              FP64_TC_FLOP_PER_S),
        library=lambda: torch.cdist(c, c) ** 2))
    graph_cpu = center_knn_graph(c.cpu(), KN)
    check(bool(torch.equal(center_knn_graph(c, KN).cpu(), graph_cpu)),
          f"the k_n-NN graph of the final centers (k={K}, kn={KN}) on the "
          f"card equals the CPU's")

    # K1: candidate_assign_tiled over the final resident arena, no skips
    knp = args[3].shape[1]
    rows_read = int(torch.unique(args[4]).numel())
    kernels.append(_against_plain(
        torch, check, f"K1 over the final resident arena ({s_rows} rows, "
                      f"bn={bn}, no block skipped)",
        functools.partial(candidate_assign_tiled, *args, bn=bn, bkn=BKN),
        functools.partial(ref.candidate_assign_tiled_ref, *args, bn),
        dict(name="candidate_assign_tiled",
             source="src/repro_torch/kernels/csrc/candidate_assign.cu",
             replaces="src/repro/kernels/candidate_assign.py:130",
             launches=launches["candidate_assign_tiled"],
             launches_stream=stream["launches"]["candidate_assign_tiled"]),
        bound(s_rows * D * 4.0 + rows_read * knp * (D + 2) * 4.0
              + nb * 8.0 + s_rows * 12.0 * 2,
              2.0 * s_rows * knp * D + 2.0 * s_rows * D)))

    # K7: candidate_assign_rowwise over the same arena and lists
    k7 = functools.partial(candidate_assign_rowwise, *args7, bn=bn)
    kernels.append(_against_plain(
        torch, check, f"K7 over the final resident arena ({s_rows} rows, "
                      f"bn={bn}, kn={KN})", k7,
        functools.partial(ref.candidate_assign_ref, *args7, bn),
        dict(name="candidate_assign_rowwise",
             source="src/repro_torch/kernels/csrc/candidate_assign_rowwise.cu",
             replaces="src/repro/kernels/candidate_assign.py:401",
             launches=bench["candidate_assign_rowwise"],
             device_ms=device_ms(k7, torch)),
        k7_bound))
    print(f"  tiled_vs_rowwise_wall (K7 ms / K1 ms over the arena): "
          f"{kernels[-1]['ms'] / kernels[-2]['ms']:.3f}")
    del args, args7, k7

    # K3: segmented_scan on the GDI leaf-grouped layout, and on the first
    # GDI round's layout (one segment over every block: the longest chains
    # of the kernel's look-back)
    bn3 = choose_group_bn(N, K, D)
    perm, b2s = group_by_cluster_device(a0, K, bn3)
    xg = x[perm.clamp(min=0).long()].contiguous()
    w = (perm >= 0).to(torch.float32)
    err = _k3_agrees(torch, check, segmented_scan, ref, xg, w, b2s, bn3,
                     f"{K} segments")
    perm1, b2s1 = group_by_cluster_device(torch.zeros_like(a0), 1, bn3)
    x1 = x[perm1.clamp(min=0).long()].contiguous()
    w1 = (perm1 >= 0).to(torch.float32)
    _k3_agrees(torch, check, segmented_scan, ref, x1, w1, b2s1, bn3,
               "one segment")
    kernels.append(_split_entry(torch, check, exact_round, ref,
                                segmented_scan, xg, w, b2s, bn3,
                                launches["exact_split_sqnorms"]))
    print(f"  K3 on one segment ({x1.shape[0]} rows, {b2s1.shape[0]} "
          f"blocks): "
          f"{time_ms(lambda: segmented_scan(x1, w1, b2s1, bn=bn3), torch):.4f}"
          f" ms")
    del x1, w1
    r3 = xg.shape[0]
    b_ms, b_by = bound(r3 * D * 4.0 * 2 + r3 * 4.0 * 3 + b2s.shape[0] * 4.0,
                       3.0 * r3 * D)
    kernels.append(dict(
        name="segmented_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_scan.cu",
        replaces="src/repro/kernels/segmented_scan.py:60",
        launches=launches["segmented_scan"],
        launches_stream=stream["launches"]["segmented_scan"],
        max_abs_err=err,
        ms=time_ms(lambda: segmented_scan(xg, w, b2s, bn=bn3), torch),
        plain_ms=time_ms(lambda: ref.segmented_scan_ref(xg, w, b2s, bn3),
                         torch),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # K1 and K4 on the first predict batch, grouped by its routed centers
    # as bounded_predict_assign(_int8) groups it (bn=8 at this shape)
    qb = queries[:BATCH]
    cidx = pad_candidates(model.neighbors, BKN).contiguous()
    knp = cidx.shape[1]
    qg, b2c, skip, bnp, live, slabs = _predict_layout(
        torch, model, qb, "f32", choose_group_bn, group_by_cluster_device)
    ctab, csqtab = candidate_tables(c, cidx)
    zi = torch.zeros(qg.shape[0], dtype=torch.int32, device=dev)
    zf = torch.zeros(qg.shape[0], device=dev)
    args = (qg, ctab, csqtab, cidx, b2c, skip, zi, zf, zf)
    kernels.append(_against_plain(
        torch, check, f"K1 at the predict layout (bn={bnp})",
        functools.partial(candidate_assign_tiled, *args, bn=bnp, bkn=BKN),
        functools.partial(ref.candidate_assign_tiled_ref, *args, bnp),
        dict(name="candidate_assign_tiled[predict]",
             source="src/repro_torch/kernels/csrc/candidate_assign.cu",
             replaces="src/repro/kernels/candidate_assign.py:130",
             launches=served["f32"]["launches"]["candidate_assign_tiled"],
             launches_exec=served_exec["launches"][
                 "candidate_assign_tiled"]),
        bound(live * D * 4.0 + slabs * knp * (D + 2) * 4.0
              + b2c.shape[0] * 8.0 + qg.shape[0] * 12.0 * 2,
              2.0 * live * knp * D + 2.0 * live * D)))
    del ctab, args

    args, bnp, k4_bound = k4_inputs(torch, model, qb)
    kern = functools.partial(candidate_assign_int8_tiled, *args, bn=bnp,
                             bkn=BKN, r=rerank)
    kernels.append(_against_plain(
        torch, check, f"K4 at the predict layout (bn={bnp})", kern,
        functools.partial(ref.candidate_assign_int8_tiled_ref, *args, bnp,
                          rerank),
        dict(name="candidate_assign_int8_tiled",
             source="src/repro_torch/kernels/csrc/candidate_assign_int8.cu",
             replaces="src/repro/kernels/candidate_assign.py:282",
             launches=served["int8"]["launches"][
                 "candidate_assign_int8_tiled"],
             launches_stream=stream["launches_int8"][
                 "candidate_assign_int8_tiled"],
             launches_exec=served_exec["launches"][
                 "candidate_assign_int8_tiled"],
             device_ms=device_ms(kern, torch)),
        k4_bound))
    del args, kern
    # K4 over the int8 fit arena (bn = 32, every block), and the exact
    # re-rank's slab distances, which the int8 fit forms for every row
    args, bn8, k4f_bound, slab_in = k4_fit_inputs(torch, x, c,
                                                   res.assignment)
    kern = functools.partial(candidate_assign_int8_tiled, *args, bn=bn8,
                             bkn=BKN, r=8)
    kernels.append(_against_plain(
        torch, check, f"K4 over the int8 fit arena ({args[0].shape[0]} "
                      f"slots, bn={bn8}, no block skipped)", kern,
        functools.partial(ref.candidate_assign_int8_tiled_ref, *args, bn8,
                          8),
        dict(name="candidate_assign_int8_tiled[fit]",
             source="src/repro_torch/kernels/csrc/candidate_assign_int8.cu",
             replaces="src/repro/kernels/candidate_assign.py:282",
             launches=fit8["launches"]["candidate_assign_int8_tiled"],
             device_ms=device_ms(kern, torch)),
        k4f_bound))
    slab = functools.partial(exact_round.slab_sqdist, *slab_in, bn8)
    s_rows, knp8 = slab_in[0].shape[0], slab_in[1].shape[1]
    slab_bound = bound(s_rows * D * 4.0 + int(torch.unique(slab_in[3])
                                              .numel()) * knp8 * (D + 1) * 4.0
                       + s_rows * knp8 * 4.0, 2.0 * s_rows * knp8 * D,
                       FP64_TC_FLOP_PER_S)
    print(f"  slab_sqdist over the int8 fit arena (the re-rank's distances "
          f"of every slot to its {knp8} slab rows): "
          f"{time_ms(slab, torch, reps=5):.4f} ms, device "
          f"{device_ms(slab, torch, reps=5):.4f} ms, bound "
          f"{slab_bound[0]:.4f} ms ({slab_bound[1]}); a fit iteration "
          f"{fit8['ms']:.3f} ms")
    del args, kern, slab, slab_in
    # K5: distance_argmin on x and the Lloyd++ centers
    c_l = res_l.centers.contiguous()
    kernels.append(_against_plain(
        torch, check, f"K5 on x and the Lloyd++ centers (n={N}, k={K}, "
                      f"d={D})",
        functools.partial(distance_argmin, x, c_l),
        functools.partial(ref.distance_argmin_ref, x, c_l),
        dict(name="distance_argmin",
             source="src/repro_torch/kernels/csrc/distance_argmin.cu",
             replaces="src/repro/kernels/distance_argmin.py:54",
             launches=l_launch["distance_argmin"]),
        bound((N * D + K * D + K) * 4.0 + N * 8.0, 2.0 * N * K * D),
        library=functools.partial(_cublas_argmin, torch, x, c_l)))
    kernels.append(_k6_entry(torch, check, lm, cluster_attend_partial, ref))
    _fixture_agrees(torch, dev, check, rounding_fixture, K2Step,
                    center_knn_graph, pad_candidates, candidate_tables,
                    candidate_assign_tiled, candidate_assign_rowwise,
                    distance_argmin, center_sqdist, ref)

    # the kernels of the torch paths: the correct rounding of the centers'
    # norms (every iteration's candidate tables) and of a predict batch's
    # products with the centers (the router's distances), and the engine's
    # ordered center sums over the final arena
    kernels.append(_against_plain(
        torch, check, f"exact_sqnorm on the final centers ({K} x {D})",
        functools.partial(exact_round.exact_sqnorm, c),
        functools.partial(ref.exact_sqnorm, c),
        dict(name="exact_sqnorm",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/kernels/candidate_assign.py:79",
             launches=launches["exact_sqnorm"]),
        bound(K * D * 4.0 + K * 4.0, 2.0 * K * D),
        library=lambda: torch.linalg.vecdot(c, c)))
    # exact_cross at both of predict's shapes: a batch against every
    # center (the re-rank's distances) and against the router's group
    # centroids, each given the squared norms that quant.sqdist_exact
    # passes for its screen
    for label, cc, what in (("", c, "the final centers"),
                            ("[router]", model.router.gc, "the router's "
                             "group centroids")):
        kk = cc.shape[0]
        ct = cc.T
        qsq = exact_round.exact_sqnorm(qb)
        csq = exact_round.exact_sqnorm(cc)
        kernels.append(_against_plain(
            torch, check, f"exact_cross{label} of a predict batch ({BATCH} x "
                          f"{D}) with {what} ({kk})",
            functools.partial(exact_round.exact_cross, qb, ct, asq=qsq,
                              bsq=csq),
            functools.partial(ref.exact_cross, qb, ct),
            dict(name=f"exact_cross{label}",
                 source="src/repro_torch/kernels/csrc/exact_round.cu",
                 replaces="src/repro/core/model.py:151",
                 launches=served["f32"]["launches"]["exact_cross"]),
            bound((BATCH * D + kk * D + BATCH * kk) * 4.0,
                  2.0 * BATCH * kk * D),
            library=lambda: qb @ ct))   # f32: TF32 is off (device.py)
    proj_dirs = (c - c.roll(1, 0)).contiguous()    # a direction per leaf
    kernels.append(_against_plain(
        torch, check, f"exact_rowdot of the rows ({N} x {D}) with their "
                      f"clusters' directions (GDI's projections)",
        functools.partial(exact_round.exact_rowdot, x, proj_dirs,
                          res.assignment),
        functools.partial(ref.exact_rowdot, x, proj_dirs, res.assignment),
        dict(name="exact_rowdot",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/core/gdi.py:215",
             launches=launches["exact_rowdot"]),
        bound((N * D + K * D + N) * 4.0 + N * 8.0, 2.0 * N * D)))
    st = sb.init_resident(x, torch.ones(N, device=dev), c, res.assignment)
    nb, s_rows = st.b2c.shape[0], st.pid.shape[0]
    bn = s_rows // nb
    seg = torch.repeat_interleave(st.b2c.long(), bn)
    seg = torch.where((seg >= 0) & (st.wg > 0), seg, K)
    kernels.append(_against_plain(
        torch, check, f"segment_sum_blocks over the final arena ({s_rows} "
                      f"slots, bn={bn})",
        functools.partial(segment_sum_blocks, st.xg, st.b2c, K, bn,
                          w=st.wg),
        functools.partial(ref.segment_sum_blocks_ref, st.xg, st.b2c, K, bn,
                          w=st.wg),
        dict(name="segment_sum_blocks",
             source="src/repro_torch/kernels/csrc/segment_sum.cu",
             replaces="src/repro/core/engine.py:264",
             launches=launches["segment_sum_blocks"],
             launches_stream=stream["launches"]["segment_sum_blocks"]),
        bound(s_rows * (D + 1) * 4.0 + nb * 4.0 + K * (D + 1) * 4.0,
              2.0 * s_rows * D),
        library=lambda: torch.zeros(K + 1, D, device=dev).index_add_(
            0, seg, st.xg * st.wg[:, None])))
    del st, seg
    if deltas:                         # the delta over the most moved rows
        # (its bound: each moved row read once, though two lanes name it;
        # b2s for every lane, perm and w for the live ones; the outputs)
        (dx, db2s, dk, _), dkw = max(
            deltas, key=lambda call: int((call[0][1] >= 0).sum()))
        live = int((db2s >= 0).sum())
        dseg = torch.where(db2s >= 0, db2s, dk).long()
        kernels.append(_against_plain(
            torch, check, f"segment_sum_blocks at a delta call ({live} moved "
                          f"lanes into {dk} segments)",
            functools.partial(segment_sum_blocks, dx, db2s, dk, 1, **dkw),
            functools.partial(ref.segment_sum_blocks_ref, dx, db2s, dk, 1,
                              **dkw),
            dict(name="segment_sum_blocks[delta]",
                 source="src/repro_torch/kernels/csrc/segment_sum.cu",
                 replaces="src/repro/core/engine.py:264",
                 launches=launches["segment_sum_blocks"]),
            bound(live / 2 * D * 4.0 + db2s.shape[0] * 4.0 + live * 8.0
                  + dk * (D + 1) * 4.0, 2.0 * live * D),
            library=lambda: torch.zeros(dk + 1, D, device=dev).index_add_(
                0, dseg, dx[dkw["perm"].long()] * dkw["w"][:, None])))
    else:
        check(False, "the second fit made a delta call")
    del deltas
    if stream["evict"] is not None:    # phase 2f's first eviction delta
        # (its bound: the evicted slots' rows and weights, every slot's
        # weight and block ids once, the outputs)
        (ex, eb2s, ek, ebn), ekw = stream["evict"]
        ew = ekw["w"]
        n_ev = int((ew > 0).sum())
        eseg = torch.repeat_interleave(eb2s.long(), ebn)
        eseg = torch.where((eseg >= 0) & (ew > 0), eseg, ek)
        kernels.append(_against_plain(
            torch, check, f"segment_sum_blocks at phase 2f's eviction delta "
                          f"({ex.shape[0]} slots, bn={ebn}, {n_ev} evicted)",
            functools.partial(segment_sum_blocks, ex, eb2s, ek, ebn, **ekw),
            functools.partial(ref.segment_sum_blocks_ref, ex, eb2s, ek, ebn,
                              **ekw),
            dict(name="segment_sum_blocks[evict]",
                 source="src/repro_torch/kernels/csrc/segment_sum.cu",
                 replaces="src/repro/core/engine.py:333",
                 launches=stream["launches"]["segment_sum_blocks"]),
            bound(n_ev * D * 4.0 + ew.shape[0] * 4.0 + eb2s.shape[0] * 4.0
                  + ek * (D + 1) * 4.0, 2.0 * n_ev * D),
            library=lambda: torch.zeros(ek + 1, D, device=dev).index_add_(
                0, eseg, ex * ew[:, None])))
        del ex, ew, eseg
    else:
        check(False, "phase 2f made an eviction delta call")
    stream.pop("evict", None)
    for kr in kernels:
        dev_t = (f" (profiler's device time {kr['device_ms']:.4f} ms)"
                 if "device_ms" in kr else "")
        print(f"phase 3: {kr['name']}: {kr['ms']:.4f} ms{dev_t}, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']}, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), launches "
              f"{kr['launches']}")

    if "--profile" in sys.argv[1:]:
        _profile(torch, "fit", lambda: fit(
            x, K, method="k2means", init="gdi", kn=KN, max_iters=MAX_ITERS,
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
        for prec in ("f32", "int8"):
            _profile(torch, f"predict {prec}", lambda: model.predict(
                queries, batch_size=BATCH, precision=prec))
        _profile(torch, "Lloyd++ fit", lambda: fit(
            x, K, method="lloyd", init="kmeanspp", max_iters=LLOYD_ITERS,
            device=dev, generator=pp_gen()))
        _profile_serve(torch, serve, lm)

    # --- 2l. the MoE family at Arctic's width (after phase 3, which holds
    # K6 on phase 2e's tables, and the profile of phase 2e's decode) ------
    del lm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(_moe_phase(torch, dev, serve, check,
                              cluster_attend_partial, ref))
    print(f"  phase 2l wall {time.perf_counter() - t0:.1f} s")

    # --- 2m. MLA: DeepSeek-V2-Lite whole, with phase 2l's model released -
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _mla_phase(torch, dev, serve, check)
    print(f"  phase 2m wall {time.perf_counter() - t0:.1f} s")

    # --- 2n, 2o. the SSM families whole: RWKV6-3B, then Zamba2-7B -------
    for arch, tag in (("rwkv6-3b", "2n"), ("zamba2-7b", "2o")):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kernels.extend(_ssm_phase(torch, dev, serve, check, ref, smi_line,
                                  arch))
        print(f"  phase {tag} wall {time.perf_counter() - t0:.1f} s")

    # --- 2p, 2q. the audio and VLM families: Whisper-base whole, then
    # InternVL2-76B at full width, each after the previous model's release
    for tag, fn in (("2p", _audio_phase), ("2q", _vlm_phase)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kernels.append(fn(torch, dev, serve, check, cluster_attend_partial,
                          ref, smi_line))
        print(f"  phase {tag} wall {time.perf_counter() - t0:.1f} s")

    # --- 2r, 2s. LM training: Qwen3-8B at full width, then the SSM
    # families' scans and their backward kernels ---------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _train_phase(torch, dev, check, smi_line)
    print(f"  phase 2r wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.extend(_ssm_train_phase(torch, dev, check, ref, smi_line))
    print(f"  phase 2s wall {time.perf_counter() - t0:.1f} s")

    # --- 2t, 2u. the LM's placement: the sharded k²-attention decode and
    # ZeRO-1 training over gloo ranks sharing the card ---------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(_lm_mesh_phase(torch, dev, check, ref,
                                  cluster_attend_partial, smi_line))
    print(f"  phase 2t wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _zero_phase(torch, dev, check, smi_line)
    print(f"  phase 2u wall {time.perf_counter() - t0:.1f} s")

    # --- 2v. the analyzer on the card ------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _analysis_phase(torch, dev, check)
    print(f"  phase 2v wall {time.perf_counter() - t0:.1f} s")

    # --- 4. result -------------------------------------------------------
    for kr in kernels:
        kr["status"] = "ok" if kr["launches"] > 0 else "not launched"
        # each rank's launches in phase 2k's fit(mesh=, init="gdi"); the
        # counts are kept per wrapper, so a row for one call site of a
        # wrapper ("[delta]", "[evict]", "[predict]", ...) has none
        kr["launches_per_shard"] = (
            [got[kr["name"]] for got in mesh_launches]
            if mesh_launches and kr["name"] in mesh_launches[0] else None)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# --- phase 2v: the analyzer on the card -----------------------------------

def _analysis_phase(torch, dev, check) -> None:
    """Every pass of the port's analyzer on the card, then the audit's
    host reads held against the profiler's on the same calls."""
    from repro_torch.analysis import cli, host_sync_audit, registry
    from repro_torch.kernels import _build
    out = ROOT / "build" / "k2lint_torch_report.json"
    _build.reset_launches()
    rc = cli.run(out=str(out), quiet=True, device=dev)
    launched = _build.launches()
    rep = json.loads(out.read_text())
    kc = rep["passes"]["kernel_contracts"]
    audit = rep["passes"]["host_sync_audit"]
    optin = kc["limits"]["smem_optin"]
    print(f"phase 2v: the analyzer on the card exits {rc}: "
          f"{audit['entries']} entries, {kc['cases']} kernel cases "
          f"({kc['kernels']} kernels), counts {rep['counts']}; limits "
          f"{kc['limits']}")
    for p in kc["plans"]:
        print(json.dumps({"plan": f"{p['kernel']}/{p['case']}", **{
            k: p[k] for k in ("variant", "grid", "launches", "threads",
                              "smem", "registers", "spill_bytes",
                              "local_bytes", "blocks_per_sm")}}))
    by_rule: dict = {}
    for f in rep["findings"]:
        by_rule.setdefault(f["rule"], []).append(
            f"{f['severity']} {f['entry'] or f['file']}: {f['site']}")
    print(f"phase 2v: findings by rule {json.dumps(by_rule)}")
    check(rc == 0 and rep["ok"],
          f"phase 2v: the analyzer exits {rc} with "
          f"{rep['counts']['blocking']} blocking findings")
    check(all(launched.values()),
          f"phase 2v: kernels never launched "
          f"{[k for k, v in launched.items() if not v]}")
    check({p["kernel"] for p in kc["plans"]} == set(launched)
          and len(kc["plans"]) == kc["cases"],
          f"phase 2v: {len(kc['plans'])} of {kc['cases']} cases' plans read")
    check(all(p["smem"] <= optin for p in kc["plans"]),
          f"phase 2v: a plan above the opt-in shared memory {optin}")
    ents = {e.name: e for e in registry.audit_entries()}
    for name in ("step/kernels-resident-f32", "lm/decode-k2attn"):
        fn, args = ents[name].build(dev)
        torch.cuda.synchronize()
        box = []
        prof = _host_reads(torch, lambda: box.append(
            host_sync_audit.run_built(fn, args, dev, str(ROOT))))
        got = box[0].count("host_read")
        print(f"phase 2v: {name}: host reads audit {got}, profiler {prof}, "
              f"budget {ents[name].host_reads}, in the report "
              f"{audit['per_entry'][name]['host_reads']}")
        check(got == prof == ents[name].host_reads
              == audit["per_entry"][name]["host_reads"],
              f"phase 2v: {name}'s host reads: audit {got}, profiler "
              f"{prof}")


# --- phases 2r and 2s: LM training ----------------------------------------

def _run_loop(loop, box, start: int, n: int) -> int:
    """``loop.run`` from the state in ``box`` (a one-item list), the
    state's only reference during the run, so each step frees the one
    before (a caller's name for the first state would keep its 14 GB of
    params and moments alive through the run); the last state goes back
    into ``box``. Returns the step reached."""
    state, end = loop.run(box.pop(), start, n)
    box.append(state)
    return end


def _host_copy(state):
    """Every leaf of a (params, opt) state on the host, keyed by path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = t.detach().cpu()
    walk(state, ())
    return out


def _train_phase(torch, dev, check, smi_line: str) -> None:
    """Phase 2r: ``launch.train``'s step through ``ft.FaultTolerantLoop``
    on Qwen3-8B at full width, cut to TRAIN_LAYERS layers, random weights
    from the seed, ``ShardedBatcher`` tokens, one checkpoint directory
    for the job (``build/train_ckpt``): run A trains TRAIN_STEPS steps
    and checkpoints its params and AdamW state at TRAIN_CKPT_AT (written
    in the background while it trains on and while run B runs); run B
    trains from the same init, is preempted at TRAIN_FAIL_AT, and
    resumes from the job's newest checkpoint to TRAIN_STEPS; then one
    step with int8 gradient compression. Checks finite losses and
    gradient norms, the params moving, no kernel of the port launched,
    the resumed run ending on run A's state bit for bit (and replaying
    its losses), and one host read a step (the loop's copy of the loss
    and the gradient norm)."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint)
    from repro_torch.configs.base import get_config
    from repro_torch.ft import FaultTolerantLoop
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import train_flops
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import init_opt_shapes
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    print(f"phase 2r: {cfg.name} trained at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} q-heads over {cfg.n_kv_heads} "
          f"kv-heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"the embedding tied), cut to {TRAIN_LAYERS} of {full.n_layers} "
          f"layers; B x S = {B} x {S}, remat 'dots', q_chunk 512, AdamW "
          f"with the cosine schedule, clipping at norm 1; allocated at the "
          f"start {base / 2 ** 30:.2f} GiB; disk free under build/ "
          f"{shutil.disk_usage(root).free / 1e9:.1f} GB")
    t0 = time.perf_counter()
    box = [train.init_state(cfg, seed=SEED, device=dev)]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(box[0][0]))
    wq0 = box[0][0]["stack"]["attn"]["wq"]["w"].clone()
    batcher = train.batcher_for(cfg, B, S, seed=SEED)
    step_fn = train.make_train_step(cfg, remat="dots", q_chunk=512)
    _build.reset_launches()

    # run A: TRAIN_STEPS steps, a checkpoint at TRAIN_CKPT_AT
    rec_a = train.MetricsStep(step_fn)
    ck = AsyncCheckpointer(str(root), keep=1)
    loop = FaultTolerantLoop(rec_a, batcher, ck, ckpt_every=TRAIN_CKPT_AT)
    t0 = time.perf_counter()
    _run_loop(loop, box, 0, TRAIN_CKPT_AT)
    times = list(loop.policy.times)
    t_leg1 = time.perf_counter() - t0
    peak_leg1 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moved = not torch.equal(box[0][0]["stack"]["attn"]["wq"]["w"], wq0)
    del wq0
    loop = FaultTolerantLoop(rec_a, batcher, ck, ckpt_every=10 ** 9)
    _run_loop(loop, box, TRAIN_CKPT_AT, TRAIN_STEPS - 1 - TRAIN_CKPT_AT)
    times += loop.policy.times
    peak_leg2 = torch.cuda.max_memory_allocated()
    reads = _host_reads(torch, lambda: _run_loop(loop, box, TRAIN_STEPS - 1,
                                                 1))
    launched = {k: v for k, v in _build.launches().items() if v}
    want = _host_copy(box.pop())
    hist_a = list(rec_a.history)
    torch.cuda.empty_cache()

    steady = times[1:]
    ms = sum(steady) / len(steady) * 1e3
    fl = train_flops(cfg, B, S)
    total = fl["bf16"] + fl["f32"]
    floor_ms = (fl["bf16"] / BF16_FLOP_PER_S + fl["f32"] / FP32_FLOP_PER_S) \
        * 1e3
    print(f"  init {t_init:.3f} s ({n_params / 1e9:.4f} B parameters, AdamW "
          f"m and v in f32); steps (ms, host clock after the device): "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" (the last under the profiler); {ms:.1f} ms a step over steps "
          f"1..{len(times) - 1}, {B * S / ms * 1e3:.0f} tokens/s [{smi_line}]")
    print(f"  losses " + ", ".join(f"{m['loss']:.4f}" for m in hist_a)
          + "; gradient norms " + ", ".join(f"{m['grad_norm']:.3f}"
                                            for m in hist_a))
    print(f"  the step: {total / 1e12:.2f} TFLOP ({fl['bf16'] / 1e12:.2f} in "
          f"bf16 products, {fl['f32'] / 1e12:.2f} in f32: the unembedding "
          f"{fl['unembed'] / 1e12:.2f} TFLOP, {fl['unembed'] / total:.1%} of "
          f"the step, and attention's scores); at the data sheet's peaks "
          f"(989 TFLOP/s bf16, 67 TFLOP/s f32) it takes at least "
          f"{floor_ms:.1f} ms: {floor_ms / ms:.1%} of the card's peak "
          f"(achieved {total / ms * 1e3 / 1e12:.1f} TFLOP/s)")
    print(f"  peak device memory {peak_leg1 / 2 ** 30:.2f} GiB over steps "
          f"0..{TRAIN_CKPT_AT - 1} and the checkpoint's host copy, "
          f"{peak_leg2 / 2 ** 30:.2f} over steps {TRAIN_CKPT_AT}.."
          f"{TRAIN_STEPS - 2} (start {base / 2 ** 30:.2f}); host reads "
          f"{reads} in step {TRAIN_STEPS - 1}; the first {TRAIN_CKPT_AT} "
          f"steps and the checkpoint's host copy {t_leg1:.1f} s; launches "
          f"{launched}")
    check(all(_finite(m["loss"]) and _finite(m["grad_norm"])
              for m in hist_a) and len(hist_a) == TRAIN_STEPS,
          f"2r: loss and gradient norm finite at each of {TRAIN_STEPS} "
          f"steps")
    check(moved, "2r: the params move (layer 0's wq after "
          f"{TRAIN_CKPT_AT} steps differs from its init)")
    check(not launched, f"2r: no kernel of the port launched (K1-K7, the "
          f"scans: {launched})")
    check(reads == 1, f"2r: host reads: 1 a step ({reads})")

    # run B: the same init, preempted at TRAIN_FAIL_AT, resumed from the
    # job's newest checkpoint
    box = [train.init_state(cfg, seed=SEED, device=dev)]
    rec_b = train.MetricsStep(step_fn)
    loop = FaultTolerantLoop(rec_b, batcher, ck, ckpt_every=10 ** 9,
                             fail_at_step=TRAIN_FAIL_AT)
    try:
        _run_loop(loop, box, 0, TRAIN_STEPS)
        preempted = ""
    except RuntimeError as e:
        preempted = str(e)
    del loop
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ck.wait()
    t_wait = time.perf_counter() - t0
    ck_bytes = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    last = latest_step(str(root))
    t_latest = time.perf_counter() - t0
    t0 = time.perf_counter()
    like = (param_shapes(cfg), init_opt_shapes(param_shapes(cfg)))
    box = [restore_checkpoint(str(root), last, like, device=dev)]
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    rec_c = train.MetricsStep(step_fn)
    loop = FaultTolerantLoop(rec_c, batcher, ck, ckpt_every=10 ** 9)
    end = _run_loop(loop, box, last, TRAIN_STEPS - last)
    state = box.pop()
    got = _host_copy(state)
    diff = [p for p in want if not torch.equal(want[p], got[p])]
    print(f"  checkpoint at step {TRAIN_CKPT_AT}: {ck_bytes / 1e9:.2f} GB, "
          f"written in the background (the wait after run B "
          f"{t_wait:.1f} s); run B: {preempted!r} after "
          f"{len(rec_b.history)} steps; newest complete checkpoint step "
          f"{last} (found, every array read, in {t_latest:.1f} s), restored "
          f"in {t_restore:.1f} s; resumed to step {end}, losses "
          + ", ".join(f"{m['loss']:.4f}" for m in rec_c.history)
          + f"; leaves unequal to run A's: {len(diff)} of {len(want)}")
    check(preempted == f"simulated preemption at step {TRAIN_FAIL_AT}"
          and last == TRAIN_CKPT_AT and end == TRAIN_STEPS,
          f"2r: run B preempted at step {TRAIN_FAIL_AT}, resumed from the "
          f"step-{TRAIN_CKPT_AT} checkpoint to step {TRAIN_STEPS}")
    check(not diff and rec_c.history == hist_a[last:]
          and rec_b.history == hist_a[:TRAIN_FAIL_AT],
          f"2r: the resumed run ends on run A's params and AdamW state bit "
          f"for bit and replays its losses and gradient norms (unequal "
          f"leaves: {diff[:4]})")
    del want, got

    # one step with int8 gradient compression
    step_c = train.make_train_step(cfg, remat="dots", q_chunk=512,
                                   compress=True)
    t0 = time.perf_counter()
    state, m = step_c(state, batcher.batch_at(TRAIN_STEPS))
    vals = torch.stack([m["loss"], m["grad_norm"]]).tolist()
    t_c = time.perf_counter() - t0
    print(f"  a step with int8 gradient compression: {t_c * 1e3:.1f} ms, "
          f"loss {vals[0]:.4f}, gradient norm {vals[1]:.3f}")
    check(all(_finite(v) for v in vals) and int(state[1]["step"]) ==
          TRAIN_STEPS + 1, "2r: the compressed step's loss and gradient "
                           "norm finite")
    del state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def _ssm_scan_args(torch, ssm, cfg, params, tokens):
    """Layer 0's scan inputs over ``tokens`` as the layer computes them
    (f32, contiguous), and a zero state: (args, state0)."""
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import layer_params
    p0 = layer_params(params["stack"], 0)
    x = rmsnorm(p0["ln1"], params["embed"][tokens.long()])
    B, S = tokens.shape
    H = cfg.n_heads
    with torch.no_grad():
        if cfg.ssm == "mamba2":
            _, xin, Bm, Cm, dt = ssm._mamba2_inputs(p0["mix"], x, H)
            P = xin.shape[-1] // H
            args = (xin.reshape(B, S, H, P).float().contiguous(),
                    Bm.contiguous(), Cm.contiguous(),
                    torch.exp(-torch.exp(p0["mix"]["A_log"]) * dt)
                    .contiguous(), dt.contiguous(),
                    p0["mix"]["D"].detach().clone())
            state0 = torch.zeros((B, H, P, Bm.shape[-1]), device=x.device)
        else:
            x_prev = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
            r, k, v, w, _ = ssm._rwkv6_inputs(p0["mix"], x, x_prev, H)
            args = tuple(t.float().contiguous() for t in (r, k, v, w)) \
                + (p0["mix"]["u"].detach().clone(),)
            dh = cfg.d_model // H
            state0 = torch.zeros((B, H, dh, dh), device=x.device)
    return args, state0


def _bwd_bound(args, hybrid: bool):
    """The backward kernel's least time: bytes, the inputs (the forward's
    inputs, the checkpoints, the output's gradient) read once and every
    gradient (the initial state's too) written once; operations, the
    reverse recurrence's 11 FLOPs a state element a step, the states'
    recomputation left out. WKV6: the sums for dr, dw, dk and dv, 2 each,
    and dState's update, 3; plus 16 an element of a head's row for the
    rank-1 bonus terms (sum_j v_j do_j, sum_i r_i u_i k_i, and their
    shares of dr, dk, du and dv). SSD: dS', the sums for dC, dB, dx's
    e and ddecay, and dState's update; plus 8 a state row (dt x, dx,
    ddt's and dD's sums)."""
    from repro_torch.kernels.ssm_scan import CKPT_EVERY
    if hybrid:
        B_, S_, H_, P_ = args[0].shape
        N_ = args[1].shape[-1]
        st = B_ * H_ * P_ * N_
        io = (3 * B_ * S_ * H_ * P_ + 4 * B_ * S_ * N_ + 4 * B_ * S_ * H_
              + 2 * H_ + st + st * -(-S_ // CKPT_EVERY))
        ops = B_ * S_ * H_ * P_ * (11.0 * N_ + 8)
    else:
        B_, S_, H_, dh_ = args[0].shape
        st = B_ * H_ * dh_ * dh_
        io = (9 * B_ * S_ * H_ * dh_ + 2 * H_ * dh_ + st
              + st * -(-S_ // CKPT_EVERY))
        ops = B_ * S_ * H_ * dh_ * (11.0 * dh_ + 16)
    return bound(4.0 * io, ops)


def _scan_bwd_entry(torch, check, name, args, state0, launches,
                    hybrid: bool) -> dict:
    """A backward kernel on ``args`` (layer 0's inputs) from ``state0``,
    with a seeded random gradient of the outputs: launched twice and
    bit-identical; each gradient within 1e-5 of its sum of absolute terms
    plus 1e-6 (autograd through the plain version on |inputs| and
    |cotangent|, positive decays as they are) of autograd through the
    plain version; both timed with CUDA events."""
    from repro_torch.kernels import ref, ssm_scan
    saving, bwd, plain = (
        (ssm_scan.ssd_scan_saving, ssm_scan.ssd_scan_bwd,
         ref.ssd_scan_states_ref) if hybrid else
        (ssm_scan.wkv6_scan_saving, ssm_scan.wkv6_scan_bwd,
         ref.wkv6_scan_states_ref))
    keep = {3, 4} if hybrid else {3}
    gen = torch.Generator(device=args[0].device).manual_seed(SEED)
    out, _, ckpt = saving(*args, state0)
    dout = torch.randn(out.shape, generator=gen, device=out.device)
    got = bwd(*args, ckpt, dout)
    again = bwd(*args, ckpt, dout)
    same = all(torch.equal(a, b) for a, b in zip(got, again))

    def grads(inputs, cot, retain=False):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        o, _ = plain(*ts)
        loss = torch.sum(o * cot)
        return ts, loss
    ts, loss = grads(args + (state0,), dout)
    want = torch.autograd.grad(loss, ts, retain_graph=True)
    ts_a, loss_a = grads(tuple(a if i in keep else a.abs()
                               for i, a in enumerate(args))
                         + (state0.abs(),), dout.abs())
    scale = torch.autograd.grad(loss_a, ts_a)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = all(bool(((g - w).abs() <= 1e-5 * s + 1e-6).all())
             for g, w, s in zip(got, want, scale))
    check(ok, f"{name} {tuple(args[0].shape)} vs autograd through the "
              f"plain version: every gradient within 1e-5 of its sum of "
              f"|terms| (max abs errs {[f'{e:.3g}' for e in errs]})")
    check(same, f"{name}: launched twice, bit-identical")
    b_ms, b_by = _bwd_bound(args, hybrid)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces=("src/repro/models/ssm.py:165" if hybrid
                  else "src/repro/models/ssm.py:83"),
        launches=launches, max_abs_err=max(errs),
        ms=time_ms(lambda: bwd(*args, ckpt, dout), torch),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            loss, ts, retain_graph=True), torch, reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _ssm_train_phase(torch, dev, check, ref, smi_line: str) -> list:
    """Phase 2s: RWKV6-3B and Zamba2-7B at full width, cut to
    SSM_TRAIN[arch] layers, SSM_TRAIN_STEPS ``make_train_step`` steps
    each (remat "dots": a layer's scan runs forward twice a step, once
    more when the backward recomputes the layer, and its backward kernel
    once), counts set to 0 just before; prints ms a step, tokens/s, peak
    memory, the launches and each backward kernel's time a layer at the
    training shape beside its bound; checks finite losses and gradient
    norms and the launches. Then phase 3's checks of both backward
    kernels on SSM_SCAN_STEPS steps of layer 0's inputs, and every arch's
    smoke config one step in f32 on the card against the CPU. Returns
    the two kernels' entries."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ssm_scan
    from repro_torch.launch import train
    from repro_torch.models import ssm
    B, S = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ
    entries = []
    for arch, layers in SSM_TRAIN.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        hybrid = bool(cfg.attn_every)
        scan = "ssd_scan" if hybrid else "wkv6_scan"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        box = [train.init_state(cfg, seed=SEED, device=dev)]
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(box[0][0]))
        batcher = train.batcher_for(cfg, B, S, seed=SEED)
        rec = train.MetricsStep(train.make_train_step(cfg, remat="dots",
                                                      q_chunk=512))
        _build.reset_launches()
        times = []
        for s in range(SSM_TRAIN_STEPS):
            t0 = time.perf_counter()
            box.append(rec(box.pop(), batcher.batch_at(s)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        state = box.pop()
        launched = {k: v for k, v in _build.launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        apps = -(-layers // cfg.attn_every) if hybrid else 0
        ms = sum(times[1:]) / (len(times) - 1) * 1e3
        print(f"phase 2s: {cfg.name} trained at full width, cut to {layers}"
              f" of {full.n_layers} layers"
              + (f" ({apps} applications of the shared block)" if hybrid
                 else "")
              + f", {n_params / 1e9:.4f} B parameters, B x S = {B} x {S}, "
              f"remat 'dots'; allocated at the start {base / 2 ** 30:.2f} "
              f"GiB; init {t_init:.3f} s; steps (ms) "
              + ", ".join(f"{t * 1e3:.1f}" for t in times)
              + f": {ms:.1f} ms a step over steps 1..{len(times) - 1}, "
              f"{B * S / ms * 1e3:.0f} tokens/s; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB; losses "
              + ", ".join(f"{m['loss']:.4f}" for m in rec.history)
              + f"; launches {launched} [{smi_line}]")
        want = {scan: 2 * layers * SSM_TRAIN_STEPS,
                scan + "_bwd": layers * SSM_TRAIN_STEPS}
        n_bwd = launched.get(scan + "_bwd", 0)
        check(all(_finite(m["loss"]) and _finite(m["grad_norm"])
                  for m in rec.history),
              f"2s {arch}: loss and gradient norm finite at each step")
        check(launched == want,
              f"2s {arch}: launches {launched}: {scan} twice a layer a step "
              f"(the forward and the backward's recomputation) and "
              f"{scan}_bwd once, nothing else ({want})")

        # the backward kernel a layer at the training shape
        tokens = batcher.batch_at(0)["tokens"].to(dev)
        args, state0 = _ssm_scan_args(torch, ssm, cfg, state[0], tokens)
        del state, rec
        torch.cuda.empty_cache()
        saving, bwd = ((ssm_scan.ssd_scan_saving, ssm_scan.ssd_scan_bwd)
                       if hybrid else (ssm_scan.wkv6_scan_saving,
                                       ssm_scan.wkv6_scan_bwd))
        out, _, ckpt = saving(*args, state0)
        dout = torch.randn(out.shape, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED))
        fwd_ms = time_ms(lambda: saving(*args, state0), torch, reps=3,
                         warmup=1)
        bwd_ms = time_ms(lambda: bwd(*args, ckpt, dout), torch, reps=3,
                         warmup=1)
        b_ms, b_by = _bwd_bound(args, hybrid)
        print(f"  {scan}_bwd a layer at the training shape "
              f"({tuple(args[0].shape)}): {bwd_ms:.3f} ms (CUDA events), "
              f"bound {b_ms:.4f} ms ({b_by}); the forward with its "
              f"checkpoints {fwd_ms:.3f} ms; {n_bwd} launches in "
              f"{SSM_TRAIN_STEPS} steps [{smi_line}]")
        del out, ckpt, dout

        # phase 3's checks of the backward kernel: SSM_SCAN_STEPS steps
        head = tuple(a[:, :SSM_SCAN_STEPS].contiguous() if a.dim() >= 3
                     else a for a in args)
        del args
        entries.append(_scan_bwd_entry(torch, check, f"{scan}_bwd", head,
                                       state0, n_bwd, hybrid))
        del head, state0
        torch.cuda.empty_cache()
    for kr in entries:
        print(f"phase 3: {kr['name']}: {kr['ms']:.4f} ms, plain (autograd "
              f"backward) {kr['plain_ms']:.4f} ms, library "
              f"{kr['library_ms']}, bound {kr['bound_ms']:.4f} ms "
              f"({kr['bound_by']}), launches {kr['launches']} [{smi_line}]")
    _train_smoke_agrees(torch, dev, check)
    return entries


def _train_smoke_grads(torch, arch, dev):
    """``forward_train`` of an arch's smoke config in f32 on ``dev``
    (params from the CPU generator's seed): (loss, every leaf's
    gradient in key order, the launches)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import forward_train, init_params
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu", unembed_table=False)
    leaves = []

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in sorted(t.items())}
        leaves.append(t.float().to(dev).requires_grad_())
        return leaves[-1]
    params = move(params)
    gen = torch.Generator().manual_seed(SEED + 1)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, 16, cfg.d_model), generator=gen)
    if cfg.n_patches:
        batch["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                       generator=gen)
    _build.reset_launches()
    loss, _ = forward_train(cfg, params, {k: v.to(dev)
                                          for k, v in batch.items()},
                            q_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu() for g in grads], \
        _build.launches()


def train_smoke_agrees(torch, arch, dev) -> tuple[bool, tuple]:
    """An arch's smoke config, one step's forward and backward in f32 on
    the card (``dev``) against the CPU: the loss rel 1e-5, every gradient
    leaf within 1e-4 of its largest magnitude, the SSM configs through
    their scan and backward kernels and no other config through any
    kernel. (agrees, (arch, loss, CPU loss, largest leaf error, the
    kernels launched on the card)). Also run by
    tests/test_torch_cuda.py."""
    loss, grads, got = _train_smoke_grads(torch, arch, dev)
    loss_c, grads_c, _ = _train_smoke_grads(torch, arch, "cpu")
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(grads, grads_c)]
    kern = {k: v for k, v in got.items() if v}
    ssm_k = {"rwkv6-3b": "wkv6_scan", "zamba2-7b": "ssd_scan"}.get(arch)
    ok = (abs(loss - loss_c) <= 1e-5 * abs(loss_c)
          and max(errs) <= 1e-4
          and (set(kern) == {ssm_k, ssm_k + "_bwd"} if ssm_k else not kern))
    return ok, (arch, loss, loss_c, max(errs), kern)


def _train_smoke_agrees(torch, dev, check) -> None:
    """``train_smoke_agrees`` for every arch."""
    from repro_torch.configs.base import ARCH_IDS
    bad = [d for ok, d in (train_smoke_agrees(torch, a, dev)
                           for a in ARCH_IDS) if not ok]
    check(not bad, f"2s: every arch's smoke config in f32, forward_train's "
                   f"loss (rel 1e-5) and every gradient leaf (1e-4 of its "
                   f"largest magnitude) card = CPU, the SSM configs through "
                   f"their scan and backward kernels ({bad})")


def _profile(torch, label: str, fn) -> None:
    """``fn`` once more under torch.profiler (CPU + CUDA): device time by
    kernel, the busy share of the host clock, and the host calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # device-side events only (kernels, copies, sets); op-level entries
    # repeat the time of the kernels they launched
    on_dev = [e for e in events if "CUDA" in str(getattr(e, "device_type",
                                                         ""))]
    busy = sum(dev_us(e) for e in on_dev) / 1e6
    print(f"profile {label}: wall {wall:.4f} s under the profiler; device "
          f"busy {busy:.4f} s = {100 * busy / wall:.1f}% of the wall")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:100]}")
    for e in events:
        if "Synchronize" in e.key or "Memcpy" in e.key:
            print(f"  host calls: {e.key} x{e.count}")


def _profile_serve(torch, serve, lm) -> None:
    """Phase 2e's decode under the profiler: 8 full-attention steps (over
    the flat cache's prompt, rewriting its decode slots), 8 k²-attention
    steps, and one fold of the ring they filled."""
    cfg, params = lm["cfg"], lm["params"]
    tok = lm["prompt"][:, -1:]
    _profile(torch, "full decode x8", lambda: serve.decode(
        cfg, params, lm["flat_cache"], tok, LM_PROMPT, 8))
    pos = LM_PROMPT + LM_DECODE + 2
    _profile(torch, "clustered decode x8", lambda: serve.decode(
        cfg, params, lm["cache"], tok, pos, 8))
    rows = int(lm["cache"]["stack"]["ring_fill"][0])
    _profile(torch, f"ring fold ({rows} rows x {LM_LAYERS} layers)",
             lambda: serve.fold_ring(lm["cache"], lm["counts"]))


def _predict_layout(torch, model, qb, prec, choose_group_bn,
                    group_by_cluster_device):
    """One predict batch grouped by its routed centers, as the model's
    resolution groups it: (grouped rows, b2c, skip, bn, live rows,
    distinct candidate lists that live blocks read)."""
    bn = choose_group_bn(qb.shape[0], model.k, model.d, bkn=BKN,
                         itemsize=1 if prec == "int8" else 4)
    routed = model.route_batch(qb, precision=prec)[0]
    perm, b2c = group_by_cluster_device(routed, model.k, bn)
    skip = (~(perm >= 0).reshape(-1, bn).any(1)).to(torch.int32)
    live = int((skip == 0).sum()) * bn
    slabs = int(torch.unique(b2c[skip == 0]).numel())
    return (qb[perm.clamp(min=0).long()].contiguous(), b2c, skip, bn, live,
            slabs)


def k4_inputs(torch, model, qb):
    """K4's arguments at the first int8 predict batch's layout, grouped by
    its routed centers as ``bounded_predict_assign_int8`` groups it (bn=8
    at this shape), and its bound: (args, bn, (bound ms, what bounds it))
    from the live blocks' rows and the distinct slabs they name."""
    from repro_torch.core.model import _RESOLVE_RERANK as rerank
    from repro_torch.kernels import quant
    from repro_torch.kernels.candidate_assign import pad_candidates
    from repro_torch.kernels.ops import (choose_group_bn,
                                         group_by_cluster_device)
    cidx = pad_candidates(model.neighbors, BKN).contiguous()
    knp = cidx.shape[1]
    qg, b2c, skip, bnp, live, slabs = _predict_layout(
        torch, model, qb, "int8", choose_group_bn, group_by_cluster_device)
    xq, xsc = quant.quantize_rows(qg)
    args = (xq, xsc, quant.residual_norm(qg, xq, xsc),
            *quant.quantized_candidate_slabs(model._quant_tables()[0], cidx),
            b2c, skip)
    return args, bnp, bound(
        live * (D + 8.0) + slabs * knp * (D + 12.0) + b2c.shape[0] * 8.0
        + xq.shape[0] * (4.0 * rerank + 8.0), 2.0 * live * knp * D,
        INT8_OP_PER_S)


def k7_inputs(torch, x, c, assignment):
    """The assignment bench's inputs (phase 2d): the resident arena of
    ``x`` under ``assignment`` and the centers ``c`` (bn=32 at the fit's
    shape), no block skipped, with K1's candidate table of the k_n-NN
    graph and K7's per-block lists ``cand = graph[rowsel]`` (the same
    lists), and K7's bound from the arena's rows, the distinct center
    rows the lists name and the outputs: (K1's args, K7's args, bn,
    (bound ms, what bounds it))."""
    from repro_torch.core import K2Step, center_knn_graph
    from repro_torch.kernels.candidate_assign import (candidate_tables,
                                                      pad_candidates)
    dev = x.device
    st = K2Step(k=K, kn=KN, bkn=BKN).init_resident(
        x, torch.ones(x.shape[0], device=dev), c, assignment)
    nb, rows = st.b2c.shape[0], st.pid.shape[0]
    graph = center_knn_graph(c, KN)
    cidx = pad_candidates(graph, BKN).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    cand = graph[rowsel.long()].contiguous()
    zi = torch.zeros(rows, dtype=torch.int32, device=dev)
    zf = torch.zeros(rows, device=dev)
    noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
    distinct = int(torch.unique(cand).numel())
    return ((st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf),
            (st.xg, c, cand, noskip, zi, zf), rows // nb,
            bound(rows * D * 4.0 + distinct * (D + 1) * 4.0
                  + nb * (KN + 1) * 4.0 + rows * 8.0 * 2,
                  2.0 * rows * KN * D, FP64_TC_FLOP_PER_S))


def _against_plain(torch, check, what, kern, plain, entry, bound_ms_by,
                   library=None):
    """Hold a kernel bit-equal to its plain version on the same inputs
    and time both, and ``library`` (one PyTorch call computing the same
    function) where there is one: the kernels line's entry."""
    got, want = kern(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    pairs = [(g, w) for g, w in zip(got, want) if g is not None]
    same = all(bool(torch.equal(g, w)) for g, w in pairs)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in pairs)
    check(same, f"{what} vs plain: bit-equal ({same}), max abs err "
                f"{err:.3g}")
    return dict(entry, route="cuda", max_abs_err=err,
                ms=time_ms(kern, torch), plain_ms=time_ms(plain, torch),
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                library_ms=None if library is None else time_ms(library,
                                                                torch))


def _split_entry(torch, check, exact_round, ref, segmented_scan, xg, w,
                 b2s, bn, launches) -> dict:
    """GDI's split-score norms on the fit's GDI layout: K3's prefix sums
    of the grouped rows, the leaf totals at each leaf's last row (as
    ``gdi._segmented_sweep`` takes them), against the plain two-call
    composition; its bound is one read of the prefixes and the row ids,
    the distinct leaf totals once, and the two outputs."""
    csum = segmented_scan(xg, w, b2s, bn=bn)[0]
    r, d = csum.shape
    row_seg = torch.repeat_interleave(b2s.long(), bn)
    k = int(b2s.max()) + 1
    last = torch.full((k,), -1, dtype=torch.int64,
                      device=csum.device).scatter_reduce_(
        0, row_seg, torch.arange(r, device=csum.device), "amax")
    tot = torch.where((last >= 0)[:, None], csum[last.clamp(min=0)], 0.0)
    live = int((last >= 0).sum())
    return _against_plain(
        torch, check, f"exact_split_sqnorms on the GDI layout ({r} rows, "
                      f"{k} leaves, d={d})",
        functools.partial(exact_round.exact_split_sqnorms, csum, tot,
                          row_seg),
        functools.partial(ref.exact_split_sqnorms, csum, tot, row_seg),
        dict(name="exact_split_sqnorms",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/core/gdi.py:244", launches=launches),
        bound(r * d * 4.0 + r * 8.0 + live * d * 4.0 + 2 * r * 4.0,
              5.0 * r * d))


def _k3_agrees(torch, check, segmented_scan, ref, xg, w, b2s, bn,
               what) -> float:
    """K3 against its plain version on one layout: on the CPU, where
    torch's cumsum adds in K3's order, bit-equal; on the card, rtol 1e-5
    plus 1e-5 times the segment's sum of |.|, counts exact; and against
    itself, a second launch bit-equal. Returns the max abs error against
    the CPU's plain version."""
    cs_k, qs_k, cn_k = segmented_scan(xg, w, b2s, bn=bn)
    cs_p, qs_p, cn_p = ref.segmented_scan_ref(xg, w, b2s, bn)
    again = segmented_scan(xg, w, b2s, bn=bn)
    check(all(bool(torch.equal(a, b))
              for a, b in zip(again, (cs_k, qs_k, cn_k))),
          f"K3 launched twice on {xg.shape[0]} rows, {what}: bit-equal")
    cpu = ref.segmented_scan_ref(xg.cpu(), w.cpu(), b2s.cpu(), bn)
    same = all(bool(torch.equal(a.cpu(), b))
               for a, b in zip((cs_k, qs_k, cn_k), cpu))
    cpu_err = max(float((a.cpu().double() - b.double()).abs().max())
                  for a, b in zip((cs_k, qs_k, cn_k), cpu))
    check(same, f"K3 on {xg.shape[0]} rows, {what}, vs its plain version "
                f"on the CPU: bit-equal ({same}), max abs err "
                f"{cpu_err:.3g}")
    nseg = int(b2s.max()) + 1
    row_seg = torch.repeat_interleave(b2s.long(), bn)
    xw = xg * w[:, None]
    seg_abs_x = torch.zeros(nseg, xg.shape[1], device=xg.device).index_add_(
        0, row_seg, xw.abs())[row_seg]
    seg_abs_q = torch.zeros(nseg, device=xg.device).index_add_(
        0, row_seg, (xw * xg).sum(1))[row_seg]
    err = max(float((cs_k - cs_p).abs().max()),
              float((qs_k - qs_p).abs().max()))
    check(bool(((cs_k - cs_p).abs()
                <= 1e-5 * cs_p.abs() + 1e-5 * seg_abs_x).all())
          and bool(((qs_k - qs_p).abs()
                    <= 1e-5 * qs_p.abs() + 1e-5 * seg_abs_q).all())
          and bool((cn_k == cn_p).all()),
          f"K3 segmented_scan vs plain on {xg.shape[0]} rows, {what}: max "
          f"abs err {err:.3g} (rtol 1e-5, atol 1e-5 * the segment's sum of "
          f"|.|); counts exact")
    return cpu_err


def _cublas_argmin(torch, x, c, chunk: int = 4096):
    """The f32 cuBLAS path the port's nearest-center assignment took
    before K5: ``x_sq - 2 x @ c.T + c_sq`` per 4096-row chunk, then
    ``torch.min``."""
    c_sq = (c * c).sum(1)
    return [torch.min(((xb * xb).sum(1)[:, None] - 2.0 * (xb @ c.T)
                       + c_sq).clamp(min=0.0), dim=1)
            for xb in torch.split(x, chunk)]


def _host_reads(torch, fn) -> int:
    """Device-to-host copies during one call of ``fn``: each drains the
    queue (a .item(), int(), bool() or .tolist() of a CUDA tensor)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("Memcpy DtoH"))


def _neighborhood_min(torch, q, c, nbh, chunk: int = 8192):
    """Plain PyTorch: each query's least squared distance over its
    candidate centers ``nbh`` (m, kn), by the oracle's formula with its
    norms and products rounded once from f64."""
    c64 = c.double()
    csq = (c64 * c64).sum(1).float()
    out = []
    for lo in range(0, q.shape[0], chunk):
        qd = q[lo:lo + chunk].double()
        ids = nbh[lo:lo + chunk]
        cross = torch.gather((qd @ c64.T).float(), 1, ids)
        sq = ((qd * qd).sum(1).float()[:, None] - 2.0 * cross
              + csq[ids]).clamp(min=0.0)
        out.append(sq.min(1).values)
    return torch.cat(out)


def device_ms(fn, torch, reps: int = 20, flush: bool = False) -> float:
    """The profiler's device time of ``fn`` per call in ms (every kernel
    it launches), over ``reps`` calls after a warm-up. With ``flush`` the
    L2 cache is flushed before each call as in :func:`time_ms_cold` (a
    fill kernel, which is not counted: ``fn`` must launch none)."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty((256 << 20) // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if not (flush and "FillFunctor" in e.key)) / 1e3 / reps


def time_ms_cold(fn, torch, reps: int = 10, warmup: int = 2,
                 flush_bytes: int = 256 << 20) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around each
    launch, with the L2 cache flushed (a 256 MiB write, untimed) before
    each, after warm-up."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _lm_serve(torch, dev, serve, check) -> dict:
    """Phase 2e: ``serve.run`` at Qwen3-8B's width, depth cut to
    LM_LAYERS, with every launch count set to 0 just before; prints and
    checks its measurements and returns its result."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    full_depth = get_config(LM_ARCH).n_layers
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                  decode_len=LM_DECODE, fold_every=LM_FOLD, device=dev,
                  seed=SEED, echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated() - base
    st = r["cache"]["stack"]
    fill_after = int(st["ring_fill"].sum())
    tok = r["prompt"][:, -1:]
    pos = LM_PROMPT + LM_DECODE
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, r["params"], r["cache"], tok, pos, 2))
    slots = LM_PROMPT * LM_BATCH * cfg.n_kv_heads * LM_LAYERS
    print(f"phase 2e: {cfg.name} cut to {LM_LAYERS} of {full_depth} layers "
          f"(d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {LM_BATCH} "
          f"requests x {LM_PROMPT} prompt tokens, {LM_DECODE} decode tokens,"
          f" kc {cfg.kv_clusters}, cap {cfg.cluster_cap}, top-p "
          f"{cfg.cluster_top_p}, ring {cfg.cluster_ring}, fold every "
          f"{r['fold_every']}")
    print(f"  prefill {r['t_prefill']:.3f} s; attach (k2-means + repack of "
          f"{LM_LAYERS} layers) {r['t_attach']:.3f} s, tokens dropped by "
          f"full clusters {r['dropped']} of {slots} "
          f"({100.0 * r['dropped'] / slots:.3f}%)")
    print(f"  decode: full {r['t_full'] / LM_DECODE * 1e3:.3f} ms/token, "
          f"clustered {r['t_clus'] / LM_DECODE * 1e3:.3f} ms/token with "
          f"folds ({r['t_clus_loop'] / LM_DECODE * 1e3:.3f} in the loop "
          f"before the tail fold); token agreement {r['agreement']:.4f}")
    print(f"  folds: {r['folded']} ring slots, {r['sizes1'] - r['sizes0']} "
          f"member rows absorbed ({r['sizes0']} -> {r['sizes1']}); "
          f"attention reads/token: full {r['reads_full']}, clustered "
          f"{r['reads_clus']} ({r['reads_full'] / r['reads_clus']:.1f}x "
          f"fewer)")
    print(f"  peak device memory +{peak / 2 ** 30:.2f} GiB; host reads "
          f"{reads} for 2 decode steps; launches {launches}")
    _lm_checks(torch, check, "2e", cfg, r, launches, LM_DECODE, LM_LAYERS,
               reads, fill_after)
    # the clustered decode through the executor envelope (ex.call) against
    # direct calls on the same cache, 8 steps each, in turns
    ex = r["executor"]
    st_ex = ex.stats()
    pos += 2
    reads_ex = _host_reads(torch, lambda: serve.decode(
        cfg, r["params"], r["cache"], tok, pos, 2, executor=ex))
    pos += 2
    per = {}
    for via in (None, ex, ex, None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.decode(cfg, r["params"], r["cache"], tok, pos, 8, executor=via)
        torch.cuda.synchronize()
        per.setdefault("envelope" if via else "direct", []).append(
            (time.perf_counter() - t0) / 8 * 1e3)
        pos += 8
    print(f"  the decode through the executor: {st_ex['admitted']} requests"
          f" admitted in the run ({LM_DECODE} decode steps and "
          f"{st_ex['admitted'] - LM_DECODE} folds), max queue depth "
          f"{st_ex['max_queue_depth']}/{st_ex['queue_bound']}, retries "
          f"{st_ex['retries']}; ms per token through the envelope "
          f"{', '.join(f'{v:.3f}' for v in per['envelope'])}, direct "
          f"{', '.join(f'{v:.3f}' for v in per['direct'])}; host reads "
          f"{reads_ex} for 2 steps")
    check(reads_ex == 2, f"1 host read per step through the executor "
                         f"({reads_ex} for 2)")
    _flat_clustered_decode(torch, serve, check, cfg, r)
    _small_serve_agrees(torch, dev, serve, check)
    _small_serve_agrees(torch, dev, serve, check, kind="flat")
    _envelope_agrees(torch, dev, serve, check)
    return dict(r, cfg=cfg, launches_all=launches)


def _flat_clustered_decode(torch, serve, check, cfg, r) -> None:
    """Phase 2e's flat-cache k²-attention variant: k²-means (kc, cap of
    the config) over every layer's prompt keys kept as member lists
    beside the flat cache (``serve.attach_member_lists``), then
    FLAT_DECODE greedy tokens through ``serve_step`` (the top-p clusters'
    rows gathered from the flat cache, each token filed by
    ``cluster_append``), counts set to 0 just before."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = serve.attach_member_lists(cfg, r["flat_cache"], length=LM_PROMPT)
    torch.cuda.synchronize()
    t_lists = time.perf_counter() - t0
    sizes0 = int(flat["stack"]["sizes"].sum())
    tok = r["prompt"][:, -1:]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits, flat, _, _ = serve.decode(cfg, r["params"], flat, tok,
                                            LM_PROMPT, FLAT_DECODE)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = _build.launches()
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, r["params"], flat, tok, LM_PROMPT + FLAT_DECODE, 2))
    sizes1 = int(flat["stack"]["sizes"].sum())
    agree = float(sum((a == b).mean() for a, b in zip(
        toks, r["clus_toks"][:FLAT_DECODE])) / FLAT_DECODE)
    print(f"  flat-cache k2-attention: member lists of {LM_LAYERS} layers "
          f"{t_lists:.3f} s; {FLAT_DECODE} decode tokens "
          f"{t_dec / FLAT_DECODE * 1e3:.3f} ms/token, token agreement with "
          f"the cluster-major decode's first {FLAT_DECODE} "
          f"{agree:.4f}; member rows {sizes0} -> {sizes1} after "
          f"{FLAT_DECODE + 2} appends; host reads {reads} for 2 steps; "
          f"launches {launches}")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"flat-cache k2-attention logits finite, shape ({LM_BATCH}, "
          f"{cfg.vocab})")
    check(sum(launches.values()) == 0,
          f"flat-cache k2-attention gathers rows: no kernel launched "
          f"(K6 {launches['cluster_attend']})")
    check(reads == 2, f"flat-cache k2-attention: 1 host read per decode "
                      f"step ({reads} for 2)")
    check(sizes0 <= sizes1 <= sizes0 + (FLAT_DECODE + 2) * LM_BATCH
          * cfg.n_kv_heads * LM_LAYERS,
          f"cluster_append filed at most one row a token, layer and kv "
          f"head ({sizes1 - sizes0})")


def _moe_phase(torch, dev, serve, check, cluster_attend_partial,
               ref) -> dict:
    """Phase 2l: ``serve.run`` at Arctic's width, depth cut to MOE_LAYERS,
    counts set to 0 just before; its checks, the GDI router at full width
    and the card against the CPU at small shapes. Returns K6's kernels
    entry on its layer-0 tables (a GQA group of 7)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import capacity, gdi_router_init, route
    from repro_torch.models.transformer import layer_params
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    print(f"phase 2l: {cfg.name} cut to {MOE_LAYERS} of {full.n_layers} "
          f"layers (d_model {d}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"d_head {cfg.d_head}, {E} experts top-{cfg.top_k}, moe_d_ff {f}, "
          f"dense residual d_ff {cfg.d_ff}, vocab {cfg.vocab}), {LM_BATCH} "
          f"requests x {MOE_PROMPT} prompt tokens, {LM_DECODE} decode "
          f"tokens, kc {cfg.kv_clusters}, cap {cfg.cluster_cap}, top-p "
          f"{cfg.cluster_top_p}, ring {cfg.cluster_ring}, fold every "
          f"{LM_FOLD}; allocated at the start {base / 2 ** 30:.2f} GiB")
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=MOE_PROMPT,
                  decode_len=LM_DECODE, fold_every=LM_FOLD, device=dev,
                  seed=SEED, echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    st = r["cache"]["stack"]
    fill_after = int(st["ring_fill"].sum())
    tok = r["prompt"][:, -1:]
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, r["params"], r["cache"], tok, MOE_PROMPT + LM_DECODE, 2))
    if "--profile" in sys.argv[1:]:
        pos = MOE_PROMPT + LM_DECODE + 2
        _profile(torch, "2l full decode x4", lambda: serve.decode(
            cfg, r["params"], r["flat_cache"], tok, MOE_PROMPT, 4))
        _profile(torch, "2l clustered decode x4", lambda: serve.decode(
            cfg, r["params"], r["cache"], tok, pos, 4))
    slots = MOE_PROMPT * LM_BATCH * cfg.n_kv_heads * MOE_LAYERS
    n_params = sum(v.numel() for v in _leaves(r["params"]["stack"]))
    print(f"  init {r['t_init']:.3f} s ({n_params / 1e9:.3f} B layer params);"
          f" prefill {r['t_prefill']:.3f} s; attach (k2-means + repack of "
          f"{MOE_LAYERS} layers) {r['t_attach']:.3f} s, tokens dropped by "
          f"full clusters {r['dropped']} of {slots} "
          f"({100.0 * r['dropped'] / slots:.3f}%)")
    print(f"  decode: full {r['t_full'] / LM_DECODE * 1e3:.3f} ms/token, "
          f"clustered {r['t_clus'] / LM_DECODE * 1e3:.3f} ms/token with "
          f"folds ({r['t_clus_loop'] / LM_DECODE * 1e3:.3f} in the loop "
          f"before the tail fold); token agreement {r['agreement']:.4f}")
    expert_bytes = 3.0 * E * d * f * 2          # wi, wg, wo in bf16
    print(f"  peak device memory {peak / 2 ** 30:.2f} GiB (+"
          f"{(peak - base) / 2 ** 30:.2f} over the start); host reads "
          f"{reads} for 2 decode steps; launches {launches}")
    print(f"  a decode step's expert products read all {E} experts: "
          f"{expert_bytes / 1e9:.2f} GB a layer, bound "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a layer at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the {cfg.top_k} chosen "
          f"experts' {expert_bytes * cfg.top_k / E / 1e9:.3f} GB would take "
          f"{expert_bytes * cfg.top_k / E / HBM_BYTES_PER_S * 1e3:.3f} ms")
    _lm_checks(torch, check, "2l", cfg, r, launches, LM_DECODE, MOE_LAYERS,
               reads, fill_after)
    entry = _k6_entry(torch, check, dict(r, cfg=cfg, launches_all=launches),
                      cluster_attend_partial, ref,
                      name="cluster_attend[arctic]")
    params, prompt = r["params"], r["prompt"]
    del r, st
    torch.cuda.empty_cache()

    # the GDI router at full width, on request 0's embedded prompt (d =
    # 7168: K3 takes its multi-slice branch, 7 slices of 1024 columns);
    # the first and the last round's K3 launches are kept for the checks
    # below. Then aux and the pairs capacity drops for layer 0 on the
    # normed embeddings
    import repro_torch.core.gdi as gdi_mod
    x0 = params["embed"][prompt[0].long()].float()
    kernel, scans = gdi_mod.segmented_scan, []

    def kept_scan(xg, w, b2s, *, bn):
        scans[1:] = [(xg, w, b2s, bn)]
        return kernel(xg, w, b2s, bn=bn)
    gdi_mod.segmented_scan = kept_scan
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        w_gdi = gdi_router_init(x0, E, device=dev,
                                generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
    finally:
        gdi_mod.segmented_scan = kernel
    t_gdi = time.perf_counter() - t0
    gl = _build.launches()
    t0 = time.perf_counter()
    w_cpu = gdi_router_init(x0.cpu(), E, device="cpu",
                            generator=torch.Generator().manual_seed(SEED))
    t_cpu = time.perf_counter() - t0
    check(bool(torch.equal(w_gdi.cpu(), w_cpu)),
          f"2l: GDI router at full width ({MOE_PROMPT} x {d}, E = {E}) from "
          f"one generator: the card's equals the plain CPU path's bit for "
          f"bit (CPU {t_cpu:.1f} s)")
    rounds = (E - 1).bit_length()
    for (xg, w, b2s, bn), at in zip(scans, (1, rounds)):
        _k3_agrees(torch, check, kernel, ref, xg, w, b2s, bn,
                   f"d = {d} ({-(-d // 1024)} column slices), GDI round "
                   f"{at} of {rounds} ({1 << (at - 1)} leaves)")
    del scans, w_cpu
    norms = torch.linalg.norm(w_gdi.double(), dim=0)
    check(tuple(w_gdi.shape) == (d, E)
          and bool(torch.allclose(norms, torch.ones_like(norms), rtol=1e-6,
                                  atol=0.0)),
          f"2l: GDI router {tuple(w_gdi.shape)}, unit columns (largest "
          f"|norm - 1| {float((norms - 1).abs().max()):.3g})")
    check(gl["segmented_scan"] == 2 * rounds and gl["distance_argmin"] == 0,
          f"2l: GDI router: K3 launched {gl['segmented_scan']} times (2 a "
          f"round, {rounds} rounds), K5 {gl['distance_argmin']}")
    p0 = layer_params(params["stack"], 0)
    xn = rmsnorm(p0["ln2"], params["embed"][prompt[0].long()])
    stats = {}
    for label, w in (("random", p0["mlp"]["router"]["w"]), ("GDI", w_gdi)):
        rt = route(w, xn, top_k=cfg.top_k)
        stats[label] = (float(rt["aux"]), int((~rt["kept"]).sum()),
                        rt["C"])
    print(f"  GDI router on request 0's prompt ({MOE_PROMPT} x {d} f32, "
          f"E = {E}): {t_gdi:.3f} s, launches {gl}; layer 0 on the normed "
          f"embeddings as one chunked call (forward_prefill's routing, "
          f"capacity C = {stats['GDI'][2]}): "
          + "; ".join(f"{k} router aux {a:.4f}, {n} of "
                      f"{MOE_PROMPT * cfg.top_k} pairs dropped"
                      for k, (a, n, _) in stats.items())
          + f"; the serve prefill routes each position's {LM_BATCH} tokens "
          f"as one call (C = {capacity(LM_BATCH, E, cfg.top_k)}) and "
          f"drops none under either router")
    check(capacity(LM_BATCH, E, cfg.top_k) >= LM_BATCH,
          "2l: the serve prefill's per-position capacity holds every pair")
    del params, prompt, x0, xn, w_gdi, p0
    torch.cuda.empty_cache()

    # the card against the plain CPU path at small shapes
    xs = torch.randn((3000, 64), generator=torch.Generator().manual_seed(2))
    got = [gdi_router_init(xs.to(where), 16, device=where,
                           generator=torch.Generator().manual_seed(3)).cpu()
           for where in ("cpu", dev)]
    check(bool(torch.equal(got[0], got[1])),
          "2l: GDI router at n=3000, d=64, E=16 from one generator: the "
          "card's equals the CPU's bit for bit")
    _small_serve_agrees(torch, dev, serve, check, arch=MOE_ARCH)
    return entry


def _mla_phase(torch, dev, serve, check) -> None:
    """Phase 2m: ``serve.run`` at DeepSeek-V2-Lite's reference config,
    full width and all 27 layers (no cut), counts set to 0 just before:
    the chunked prefill of 2 x MLA_PROMPT tokens (the dense GQA prefix,
    26 MLA + MoE layers), 64 greedy tokens with full attention over the
    latent cache, and the line that k²-attention does not apply. Checks
    finite logits, 1 host read a step, no kernel launched, the parameter
    count against ``params_estimate`` and the smoke config card = CPU."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    cfg = get_config(MLA_ARCH)
    n_main = cfg.n_layers - cfg.first_dense
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    print(f"phase 2m: {cfg.name}, all {cfg.n_layers} layers ({cfg.first_dense}"
          f" dense GQA prefix, {n_main} MLA + MoE; d_model {d}, "
          f"{cfg.n_heads} heads, kv_lora {cfg.kv_lora}, nope "
          f"{cfg.qk_nope_dim}, rope {cfg.qk_rope_dim}, v {cfg.v_head_dim}, "
          f"{E} experts top-{cfg.top_k}, {cfg.n_shared_experts} shared, "
          f"moe_d_ff {f}, vocab {cfg.vocab}), {LM_BATCH} requests x "
          f"{MLA_PROMPT} prompt tokens, {LM_DECODE} decode tokens; allocated "
          f"at the start {base / 2 ** 30:.2f} GiB")
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=MLA_PROMPT,
                  decode_len=LM_DECODE, device=dev, seed=SEED,
                  echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    params, cache = r["params"], r["flat_cache"]
    tok = r["prompt"][:, -1:]
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, params, cache, tok, MLA_PROMPT, 2))
    if "--profile" in sys.argv[1:]:
        _profile(torch, "2m full decode x4", lambda: serve.decode(
            cfg, params, cache, tok, MLA_PROMPT, 4))
    leaves = {k: sum(t.numel() for t in _leaves(v))
              for k, v in params.items() if k != "embed_f32"}
    n_params = sum(leaves.values())
    est = cfg.params_estimate()
    # the estimate counts the dense first layer as an MLA + MoE layer and
    # leaves out the routers and norms
    dense = dataclasses.replace(cfg, moe=False, mla=False)
    per = lambda c: (c.params_estimate() - c.vocab * d) / c.n_layers  # noqa
    norms = sum(t.numel() for t in _norm_leaves(params))
    want = (est + cfg.first_dense * (per(dense) - per(cfg))
            + n_main * d * E + norms)
    lat_bytes = cache["stack"]["lat"].numel() * 2
    S = cache["stack"]["lat"].shape[2]
    gqa_bytes = (n_main * LM_BATCH * S * cfg.n_heads
                 * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2)
    prefix_bytes = sum(t.numel() * 2 for t in cache["prefix"].values())
    print(f"  init {r['t_init']:.3f} s ({n_params / 1e9:.4f} B parameters: "
          + ", ".join(f"{k} {v / 1e9:.4f} B" for k, v in leaves.items())
          + f"; params_estimate {est / 1e9:.4f} B); prefill "
          f"{r['t_prefill']:.3f} s; decode {r['t_full'] / LM_DECODE * 1e3:.3f}"
          f" ms/token (full attention over {S} latent slots)")
    print(f"  latent cache {lat_bytes / 2 ** 30:.3f} GiB ({n_main} layers x "
          f"{LM_BATCH} x {S} x {cfg.kv_lora + cfg.qk_rope_dim} bf16) against "
          f"{gqa_bytes / 2 ** 30:.3f} GiB for a GQA cache of the same heads "
          f"(k {cfg.qk_nope_dim + cfg.qk_rope_dim}, v {cfg.v_head_dim}); the "
          f"prefix's flat k/v {prefix_bytes / 2 ** 30:.3f} GiB")
    expert_bytes = 3.0 * E * d * f * 2 * n_main       # wi, wg, wo in bf16
    print(f"  peak device memory {peak / 2 ** 30:.2f} GiB (+"
          f"{(peak - base) / 2 ** 30:.2f} over the start); host reads "
          f"{reads} for 2 decode steps; launches {launches}")
    print(f"  a decode step's expert products read all {E} experts of "
          f"{n_main} layers: {expert_bytes / 1e9:.2f} GB, bound "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the {cfg.top_k} chosen "
          f"experts' {expert_bytes * cfg.top_k / E / 1e9:.3f} GB would take "
          f"{expert_bytes * cfg.top_k / E / HBM_BYTES_PER_S * 1e3:.3f} ms")
    check(n_params == want,
          f"2m: {n_params} parameters = params_estimate {int(est)} with the "
          f"dense first layer counted as such, the routers and norms "
          f"({int(want)})")
    check(sum(launches.values()) == 0,
          f"2m: no kernel of K1-K7 launched (MLA and the MoE are plain "
          f"torch): {launches}")
    for name in ("prefill_logits", "full_logits"):
        check(tuple(r[name].shape) == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(r[name]).all()),
              f"2m: {name} finite, shape ({LM_BATCH}, {cfg.vocab})")
    check(r["clus_logits"] is None and len(r["full_toks"]) == LM_DECODE,
          f"2m: {LM_DECODE} full-attention tokens, no clustered decode")
    check(reads == 2, f"2m: host reads: 1 per decode step ({reads} for 2)")
    del r, params, cache
    torch.cuda.empty_cache()
    _small_serve_agrees(torch, dev, serve, check, arch=MLA_ARCH,
                        kind="full")


def _ssm_phase(torch, dev, serve, check, ref, smi_line: str,
               arch: str) -> list:
    """Phases 2n (``rwkv6-3b``) and 2o (``zamba2-7b``): ``serve.run`` at
    the reference config's full width and depth, counts set to 0 just
    before: the chunked prefill (the recurrence one scan launch a layer),
    SSM_DECODE greedy tokens over the recurrent state, and for Zamba2 the
    shared block's cache clustered (kc SSM_KC, cap SSM_CAP) and the same
    tokens decoded with k²-attention (K6 once an application a step).
    Checks the launches, finite logits, 1 host read a step, the parameter
    count against ``params_estimate`` made up, and the prefill's cache
    against a stepped prefill of the first SSM_STEPPED tokens through
    ``serve_step`` (rel 1e-3). Returns the kernels entries: the scan at a
    full-width shape over SSM_SCAN_STEPS steps and at S = 1 (phase 3's
    checks), and for Zamba2 K6 at dh = 112."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ssm_scan
    from repro_torch.models import attention, ssm
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import n_shared_apps
    from repro_torch.models.transformer import layer_params
    cfg = get_config(arch)
    hybrid = bool(cfg.attn_every)
    tag = "2o" if hybrid else "2n"
    prompt_len = SSM_PROMPT[arch]
    if hybrid:
        cfg = dataclasses.replace(cfg, kv_clusters=SSM_KC, cluster_cap=SSM_CAP,
                                  cluster_top_p=SSM_TOP_P)
    scan = "ssd_scan" if hybrid else "wkv6_scan"
    napps = n_shared_apps(cfg) if hybrid else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    print(f"phase {tag}: {cfg.name}, all {cfg.n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, "
          + (f"Mamba2 d_in {cfg.ssm_expand * cfg.d_model}, N "
             f"{cfg.ssm_state}, the shared attention block every "
             f"{cfg.attn_every} layers ({napps} applications, "
             f"{cfg.n_kv_heads} kv-heads of {cfg.d_head}), d_ff {cfg.d_ff}"
             if hybrid else f"RWKV6 heads of {cfg.d_model // cfg.n_heads}, "
             f"d_ff {cfg.d_ff}")
          + f", vocab {cfg.vocab}), {LM_BATCH} requests x {prompt_len} "
          f"prompt tokens, {SSM_DECODE} decode tokens"
          + (f", kc {cfg.kv_clusters}, cap {cfg.cluster_cap}, top-p "
             f"{cfg.cluster_top_p}, ring {cfg.cluster_ring}, no folds"
             if hybrid else "")
          + f"; allocated at the start {base / 2 ** 30:.2f} GiB")
    if hybrid:
        R = cfg.cluster_ring
        tables = (2 * napps * LM_BATCH * cfg.n_kv_heads * cfg.kv_clusters
                  * cfg.cluster_cap * cfg.d_head * 2)
        print(f"  the k²-attention tables: {napps} applications x "
              f"{LM_BATCH} x {cfg.n_kv_heads} kv-heads x {cfg.kv_clusters} "
              f"clusters x {cfg.cluster_cap} slots x {cfg.d_head} x 2 (k, v) "
              f"bf16 = {tables / 1e9:.1f} GB ({cfg.kv_clusters * cfg.cluster_cap}"
              f" slots a head for a {prompt_len}-token prompt; the config's "
              f"kc 2048 x cap 512 would take "
              f"{tables * 2048 * 512 / (SSM_KC * SSM_CAP) / 1e9:.0f} GB); "
              f"ring {R}")
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=prompt_len,
                  decode_len=SSM_DECODE, device=dev, seed=SEED,
                  echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    params, flat = r["params"], r["flat_cache"]
    prompt = r["prompt"]
    tok = prompt[:, -1:]
    pos = prompt_len + SSM_DECODE + 1
    # the decode's host reads, on the flat cache (the last slot left)
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, params, flat, tok, pos - 1, 1))
    if "--profile" in sys.argv[1:]:
        _profile(torch, f"{tag} full decode x1", lambda: serve.decode(
            cfg, params, flat, tok, pos - 1, 1))
    leaves = {k: sum(t.numel() for t in _leaves(v))
              for k, v in params.items() if k != "embed_f32"}
    n_params = sum(leaves.values())
    est = cfg.params_estimate()
    d, L = cfg.d_model, cfg.n_layers
    norms = sum(t.numel() for t in _norm_leaves(params))
    # the estimate leaves out the norms and, per layer, Mamba2's A_log, D
    # and dt_bias, or RWKV6's decay LoRA, token-shift mixes, decay bias
    # and bonus, and counts six d x d matrices where RWKV6 has five
    extra = L * (3 * cfg.n_heads if hybrid
                 else 2 * 64 * d + 5 * d + 2 * d - d * d)
    want_params = est + extra + norms
    per_step = cfg.n_layers
    want = {scan: per_step * (1 + SSM_DECODE * (2 if hybrid else 1))}
    if hybrid:
        want["cluster_attend"] = napps * SSM_DECODE
    print(f"  init {r['t_init']:.3f} s ({n_params / 1e9:.4f} B parameters: "
          + ", ".join(f"{k} {v / 1e9:.4f} B" for k, v in leaves.items())
          + f"; params_estimate {est / 1e9:.4f} B); prefill "
          f"{r['t_prefill']:.3f} s; decode full "
          f"{r['t_full'] / SSM_DECODE * 1e3:.3f} ms/token"
          + (f", clustered {r['t_clus'] / SSM_DECODE * 1e3:.3f} ms/token; "
             f"attach {r['t_attach']:.3f} s, tokens dropped by full "
             f"clusters {r['dropped']} of "
             f"{prompt_len * LM_BATCH * cfg.n_kv_heads * napps}; token "
             f"agreement {r['agreement']:.4f}" if hybrid else "")
          + f" [{smi_line}]")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in flat["stack"].values())
    print(f"  peak device memory {peak / 2 ** 30:.2f} GiB (+"
          f"{(peak - base) / 2 ** 30:.2f} over the start); the recurrent "
          f"state {state_bytes / 2 ** 20:.1f} MiB for {LM_BATCH} requests"
          + (f"; the shared block's flat cache "
             f"{sum(t.numel() * 2 for t in flat['shared'].values()) / 1e9:.2f}"
             f" GB" if hybrid else "")
          + f"; host reads {reads} for 1 decode step; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(n_params == want_params,
          f"{tag}: {n_params} parameters = params_estimate {int(est)} with "
          f"the per-layer terms it leaves out and the norms "
          f"({int(want_params)})")
    got = {k: v for k, v in launches.items() if v}
    check(got == want,
          f"{tag}: launches {got}: {scan} once a layer in the prefill and "
          f"once a layer a decode step"
          + (", K6 once a shared-block application a clustered step"
             if hybrid else "") + f" ({want})")
    for name in ("prefill_logits", "full_logits") + (
            ("clus_logits",) if hybrid else ()):
        check(tuple(r[name].shape) == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(r[name]).all()),
              f"{tag}: {name} finite, shape ({LM_BATCH}, {cfg.vocab})")
    check(reads == 1, f"{tag}: host reads: 1 per decode step ({reads})")
    if hybrid:
        ex_st = r["executor"].stats()
        check(r["folded"] == 0 and ex_st["admitted"] == SSM_DECODE
              and bool((r["cache"]["shared"]["ring_fill"]
                        == SSM_DECODE).all()),
              f"{tag}: every clustered step through ex.call "
              f"({ex_st['admitted']}), no fold, each application's ring "
              f"holds the {SSM_DECODE} decoded tokens")

    entries = []
    if hybrid:
        # K6 at dh = 112: its arguments at one more clustered decode step
        # (after the measurements), recorded from the decode path's call
        rec = []
        real = attention.cluster_attend_partial

        def record(q, kt, vt, sel, **kw):
            if not rec:
                rec.append((q.clone(), kt, vt, sel.clone(), kw["sizes"]))
            return real(q, kt, vt, sel, **kw)
        attention.cluster_attend_partial = record
        try:
            serve.decode(cfg, params, r["cache"], tok, pos, 1)
        finally:
            attention.cluster_attend_partial = real
        torch.cuda.synchronize()
        q, kt, vt, sel, sizes = rec[0]
        entries.append(_k6_entry(
            torch, check, dict(r, cfg=cfg, launches_all=launches), real, ref,
            name="cluster_attend[zamba]",
            inputs=(q.float().contiguous(), kt, vt, sel, sizes)))
        del rec, q, kt, vt, sel, sizes
    del r, flat
    torch.cuda.empty_cache()

    # layer 0's scan inputs over the prompt, recomputed as the prefill
    # made them: the time a layer at the prefill's shape, beside its bound
    p0 = layer_params(params["stack"], 0)
    x = rmsnorm(p0["ln1"], params["embed"][prompt.long()])
    H = cfg.n_heads
    if hybrid:
        z, xin, Bm, Cm, dt = ssm._mamba2_inputs(p0["mix"], x, H)
        P = xin.shape[-1] // H
        args = (xin.reshape(LM_BATCH, prompt_len, H, P).float().contiguous(),
                Bm.contiguous(), Cm.contiguous(),
                torch.exp(-torch.exp(p0["mix"]["A_log"]) * dt), dt,
                p0["mix"]["D"])
        N = Bm.shape[-1]
        state0 = torch.zeros((LM_BATCH, H, P, N), device=dev)
        kern_fn, plain_fn = ssm_scan.ssd_scan, ref.ssd_scan_ref
        del z, xin
    else:
        x_prev = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
        r_, k_, v_, w_, _ = ssm._rwkv6_inputs(p0["mix"], x, x_prev, H)
        args = tuple(t.float().contiguous() for t in (r_, k_, v_, w_)) \
            + (p0["mix"]["u"],)
        dh = d // H
        state0 = torch.zeros((LM_BATCH, H, dh, dh), device=dev)
        kern_fn, plain_fn = ssm_scan.wkv6_scan, ref.wkv6_scan_ref
        del r_, k_, v_, w_, x_prev
    del x

    def scan_bound(a, S):
        """Bytes: the f32 inputs of S steps and the output once, the
        state read and written; operations: 5 FLOPs a state element a
        step (the update's product, decay and sum, the output's multiply
        and add), plus 3 a state row (ssd: dt x and the D skip) or 5 an
        element of a head's row (wkv6: the rank-1 bonus term, v_j times
        sum_i r_i u_i k_i, added to out_j)."""
        if hybrid:
            B_, _, H_, P_ = a[0].shape
            N_ = a[1].shape[-1]
            io = B_ * S * (2 * H_ * P_ + 2 * N_ + 2 * H_) + H_
            st = B_ * H_ * P_ * N_
            ops = B_ * S * H_ * P_ * (5 * N_ + 3)
        else:
            B_, _, H_, dh_ = a[0].shape
            io = B_ * S * H_ * dh_ * 5 + H_ * dh_
            st = B_ * H_ * dh_ * dh_
            ops = B_ * S * H_ * dh_ * (5.0 * dh_ + 5)
        return bound(4.0 * (io + 2 * st), ops)
    st = state0.clone()
    layer_ms = time_ms(lambda: kern_fn(*args, st), torch, reps=3, warmup=1)
    b_ms, b_by = scan_bound(args, prompt_len)
    print(f"  {scan} a layer at the prefill's shape ({tuple(args[0].shape)}"
          f"): {layer_ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms "
          f"({b_by}), {prompt_len} dependent steps: "
          f"{layer_ms / prompt_len * 1e3:.3f} us a step; launches {want[scan]}"
          f" [{smi_line}]")

    # phase 3's checks of the scan, at the full width: SSM_SCAN_STEPS steps
    # of layer 0's inputs from a zero state, then one step from that state
    S = SSM_SCAN_STEPS
    head = tuple(a[:, :S].contiguous() if a.dim() >= 3 else a for a in args)
    one = tuple(a[:, S:S + 1].contiguous() if a.dim() >= 3 else a
                for a in args)
    del args
    after = state0.clone()
    plain_fn(*head, after)
    for label, a, s0 in (("", head, state0), ("[S=1]", one, after)):
        entries.insert(len(entries) - hybrid, _scan_entry(
            torch, check, f"{scan}{label}", kern_fn, plain_fn, a, s0,
            launches[scan], scan_bound(a, a[0].shape[1]),
            keep={3, 4} if hybrid else {3}))
    del head, one, p0
    for kr in entries:
        dev_t = (f" (profiler's device time {kr['device_ms']:.4f} ms)"
                 if "device_ms" in kr else "")
        print(f"phase 3: {kr['name']}: {kr['ms']:.4f} ms{dev_t}, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']}, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), launches "
              f"{kr['launches']} [{smi_line}]")

    # the prefill's cache against a stepped prefill of the first tokens,
    # in bf16 (measured) and with the params in f32 (checked)
    torch.cuda.empty_cache()
    _stepped_agrees(torch, dev, serve, check, cfg, params, prompt, tag)
    del params
    torch.cuda.empty_cache()
    _small_serve_agrees(torch, dev, serve, check, arch=arch,
                        kind="cluster_major" if hybrid else "full")
    return entries


def _lm_lines(tag, cfg, r, n_tok, layers, smi_line) -> None:
    """The prefill, attach, decode and fold lines of a ``serve.run`` with
    a clustered decode (phases 2p and 2q, as phase 2e prints them)."""
    B = r["prompt"].shape[0]
    slots = r["prompt"].shape[1] * B * cfg.n_kv_heads * layers
    enc = (f"encode {r['t_encode']:.3f} s; "
           if r["t_encode"] is not None else "")
    print(f"  init {r['t_init']:.3f} s; {enc}prefill {r['t_prefill']:.3f} "
          f"s; attach (k2-means + repack of {layers} layers) "
          f"{r['t_attach']:.3f} s, tokens dropped by full clusters "
          f"{r['dropped']} of {slots} ({100.0 * r['dropped'] / slots:.3f}%)"
          f" [{smi_line}]")
    print(f"  decode: full {r['t_full'] / n_tok * 1e3:.3f} ms/token, "
          f"clustered {r['t_clus'] / n_tok * 1e3:.3f} ms/token with folds "
          f"({r['t_clus_loop'] / n_tok * 1e3:.3f} in the loop before the "
          f"tail fold); token agreement {r['agreement']:.4f}; folds: "
          f"{r['folded']} ring slots, {r['sizes1'] - r['sizes0']} member "
          f"rows absorbed ({r['sizes0']} -> {r['sizes1']}); attention "
          f"reads/token: full {r['reads_full']}, clustered "
          f"{r['reads_clus']} [{smi_line}]")


def _lm_checks(torch, check, tag, cfg, r, launches, n_tok, layers,
               reads, fill_after) -> None:
    """Phase 2e's checks of a clustered ``serve.run``: K6 once a layer a
    clustered token and nothing else launched, finite logits, the folds
    (``fill_after``: the rings' fill right after the run), one host read
    a step, every step and fold through the executor."""
    B = r["prompt"].shape[0]
    want = layers * n_tok
    check(launches["cluster_attend"] == want
          and r["launches"]["cluster_attend"] == want
          and sum(launches.values()) == want,
          f"{tag}: cluster_attend (K6) launched once per layer per "
          f"clustered token and nothing else launched "
          f"({launches['cluster_attend']} for {want})")
    for name in ("prefill_logits", "full_logits", "clus_logits"):
        check(tuple(r[name].shape) == (B, cfg.vocab)
              and bool(torch.isfinite(r[name]).all()),
              f"{tag}: {name} finite, shape ({B}, {cfg.vocab})")
    check(r["folded"] == n_tok * layers and 0 <= r["sizes1"] - r["sizes0"]
          <= r["folded"] * B * cfg.n_kv_heads and r["dropped"] >= 0
          and fill_after == 0,
          f"{tag}: the folds took {r['folded']} ring slots, one per layer "
          f"per decoded token, and left the ring empty")
    check(reads == 2, f"{tag}: host reads: 1 per decode step ({reads} for 2)")
    st_ex = r["executor"].stats()
    n_folds = n_tok // r["fold_every"] + 1
    check(st_ex["admitted"] == n_tok + n_folds and st_ex["rejected"] == 0,
          f"{tag}: every decode step and fold went through ex.call "
          f"({st_ex['admitted']} admitted for {n_tok} steps and {n_folds} "
          f"folds)")


def _audio_phase(torch, dev, serve, check, cluster_attend_partial, ref,
                 smi_line: str) -> dict:
    """Phase 2p: Whisper-base whole (6 encoder and 6 decoder layers at
    full width) through ``serve.run``, counts set to 0 just before:
    AUDIO_BATCH utterances of AUDIO_FRAMES frames encoded (the cross keys
    and values written into the cache), a prompt of AUDIO_PROMPT tokens,
    AUDIO_DECODE tokens full and clustered at the serving knobs AUDIO_KC
    x AUDIO_CAP x AUDIO_TOP_P, folds every AUDIO_FOLD. Checks the
    launches, finite logits, the folds, one host read a step, the
    parameter count against ``params_estimate`` made up, the cross cache
    kept through the clustering, the chunked prefill of the first
    AUDIO_STEPPED tokens against a stepped one (f32, rel 1e-3) and the
    smoke config card = CPU. Returns K6's entry on its layer-0 tables (dh
    64, a GQA group of 1)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    full = get_config(AUDIO_ARCH)
    cfg = dataclasses.replace(full, kv_clusters=AUDIO_KC,
                              cluster_cap=AUDIO_CAP,
                              cluster_top_p=AUDIO_TOP_P)
    d, L = cfg.d_model, cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    config_tables = (2 * AUDIO_BATCH * cfg.n_kv_heads * full.kv_clusters
                     * full.cluster_cap * cfg.d_head * 2)
    print(f"phase 2p: {cfg.name} whole ({cfg.encoder_layers} encoder and {L}"
          f" decoder layers, d_model {d}, {cfg.n_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{AUDIO_BATCH} utterances x {AUDIO_FRAMES} frames, "
          f"{AUDIO_PROMPT} prompt tokens, {AUDIO_DECODE} decode tokens full "
          f"and clustered at the serving knobs kc {cfg.kv_clusters}, cap "
          f"{cfg.cluster_cap}, top-p {cfg.cluster_top_p} (the config's kc "
          f"{full.kv_clusters} x cap {full.cluster_cap} would take "
          f"{config_tables / 1e9:.1f} GB a layer), ring {cfg.cluster_ring}, "
          f"fold every {AUDIO_FOLD}; allocated at the start "
          f"{base / 2 ** 30:.2f} GiB")
    _build.reset_launches()
    r = serve.run(cfg, batch=AUDIO_BATCH, prompt_len=AUDIO_PROMPT,
                  decode_len=AUDIO_DECODE, fold_every=AUDIO_FOLD,
                  enc_len=AUDIO_FRAMES, device=dev, seed=SEED,
                  echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    params, st = r["params"], r["cache"]["stack"]
    fill_after = int(st["ring_fill"].sum())
    tok = r["prompt"][:, -1:]
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, params, r["cache"], tok, AUDIO_PROMPT + AUDIO_DECODE, 2))
    if "--profile" in sys.argv[1:]:
        _profile(torch, "2p full decode x4", lambda: serve.decode(
            cfg, params, r["flat_cache"], tok, AUDIO_PROMPT, 4))
        _profile(torch, "2p clustered decode x4", lambda: serve.decode(
            cfg, params, r["cache"], tok, AUDIO_PROMPT + AUDIO_DECODE + 2, 4))
    leaves = {k: sum(t.numel() for t in _leaves(v))
              for k, v in params.items() if k != "embed_f32"}
    n_params = sum(leaves.values())
    est = cfg.params_estimate()
    # the estimate leaves out the decoder's cross attention (wq, wk, wv,
    # wo of each layer) and the norms
    xattn = L * (2 * d * cfg.d_q + 2 * d * cfg.n_kv_heads * cfg.d_head)
    norms = sum(t.numel() for t in _norm_leaves(params))
    cross_bytes = sum(st[f].numel() * st[f].element_size()
                      for f in ("xk", "xv"))
    _lm_lines("2p", cfg, r, AUDIO_DECODE, L, smi_line)
    print(f"  {n_params} parameters ("
          + ", ".join(f"{k} {v}" for k, v in leaves.items())
          + f"); params_estimate {int(est)}; the cross K/V cache "
          f"{cross_bytes / 1e9:.3f} GB ({L} layers x 2 x {AUDIO_BATCH} x "
          f"{cfg.n_kv_heads} x {AUDIO_FRAMES} x {cfg.d_head} bf16); peak "
          f"device memory {peak / 2 ** 30:.2f} GiB (+"
          f"{(peak - base) / 2 ** 30:.2f} over the start); host reads "
          f"{reads} for 2 decode steps; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{smi_line}]")
    _lm_checks(torch, check, "2p", cfg, r, launches, AUDIO_DECODE, L, reads,
               fill_after)
    check(n_params == est + xattn + norms,
          f"2p: {n_params} parameters = params_estimate {int(est)} with the "
          f"cross attention ({xattn}) and the norms ({norms})")
    check(st["xk"] is r["flat_cache"]["stack"]["xk"]
          and tuple(st["xk"].shape) == (L, AUDIO_BATCH, cfg.n_kv_heads,
                                        AUDIO_FRAMES, cfg.d_head)
          and bool(torch.isfinite(st["xk"].float()).all())
          and bool((st["xv"] != 0).any()),
          "2p: the encoded cross keys and values fill the cache's "
          f"{AUDIO_FRAMES} slots and stay through the clustering and folds")
    entry = _k6_entry(torch, check, dict(r, cfg=cfg, launches_all=launches),
                      cluster_attend_partial, ref,
                      name="cluster_attend[whisper]")
    prompt, frames = r["prompt"], r["frames"]
    del r, st
    torch.cuda.empty_cache()
    _stepped_agrees(torch, dev, serve, check, cfg, params, prompt, "2p",
                    n=AUDIO_STEPPED, frames=frames)
    del params
    torch.cuda.empty_cache()
    _small_serve_agrees(torch, dev, serve, check, arch=AUDIO_ARCH)
    return entry


def _vlm_phase(torch, dev, serve, check, cluster_attend_partial, ref,
               smi_line: str) -> dict:
    """Phase 2q: InternVL2-76B's LLM at full width, cut to VLM_LAYERS of
    80 layers, through ``serve.run``, counts set to 0 just before:
    LM_BATCH requests of VLM_PROMPT positions whose first 256 are patch
    rows drawn from the seed, LM_DECODE tokens full and clustered at the
    config's kc, cap and top-p, folds every LM_FOLD. Checks as phase 2e,
    the parameter count against ``params_estimate`` with the norms, the
    patched chunked prefill of the first VLM_STEPPED positions against a
    stepped one (f32, rel 1e-3) and the smoke config card = CPU. Returns
    K6's entry on its layer-0 tables (a GQA group of 8)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tables = (2 * VLM_LAYERS * LM_BATCH * cfg.n_kv_heads * cfg.kv_clusters
              * cfg.cluster_cap * cfg.d_head * 2)
    print(f"phase 2q: {cfg.name} cut to {VLM_LAYERS} of {full.n_layers} "
          f"layers (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_patches} patch positions), {LM_BATCH} requests x "
          f"{VLM_PROMPT} prompt positions, {LM_DECODE} decode tokens, kc "
          f"{cfg.kv_clusters}, cap {cfg.cluster_cap}, top-p "
          f"{cfg.cluster_top_p}, ring {cfg.cluster_ring}, fold every "
          f"{LM_FOLD}; the k2-attention tables {tables / 1e9:.1f} GB; "
          f"allocated at the start {base / 2 ** 30:.2f} GiB")
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=VLM_PROMPT,
                  decode_len=LM_DECODE, fold_every=LM_FOLD, device=dev,
                  seed=SEED, echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    params = r["params"]
    fill_after = int(r["cache"]["stack"]["ring_fill"].sum())
    tok = r["prompt"][:, -1:]
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, params, r["cache"], tok, VLM_PROMPT + LM_DECODE, 2))
    if "--profile" in sys.argv[1:]:
        _profile(torch, "2q full decode x4", lambda: serve.decode(
            cfg, params, r["flat_cache"], tok, VLM_PROMPT, 4))
        _profile(torch, "2q clustered decode x4", lambda: serve.decode(
            cfg, params, r["cache"], tok, VLM_PROMPT + LM_DECODE + 2, 4))
    n_params = sum(t.numel() for k, v in params.items() if k != "embed_f32"
                   for t in _leaves(v))
    est = cfg.params_estimate()
    norms = sum(t.numel() for t in _norm_leaves(params))
    _lm_lines("2q", cfg, r, LM_DECODE, VLM_LAYERS, smi_line)
    print(f"  {n_params} parameters (params_estimate {int(est)} and "
          f"{norms} norm scales); the patch rows "
          f"{tuple(r['patches'].shape)} bf16; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (+{(peak - base) / 2 ** 30:.2f} over the "
          f"start); host reads {reads} for 2 decode steps; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{smi_line}]")
    _lm_checks(torch, check, "2q", cfg, r, launches, LM_DECODE, VLM_LAYERS,
               reads, fill_after)
    check(n_params == est + norms,
          f"2q: {n_params} parameters = params_estimate {int(est)} with the "
          f"norms ({norms})")
    entry = _k6_entry(torch, check, dict(r, cfg=cfg, launches_all=launches),
                      cluster_attend_partial, ref,
                      name="cluster_attend[internvl]")
    dev_t = (f"device {entry['device_ms']:.4f} ms (L2 flushed)"
             if "device_ms" in entry else "the profiler's time not kept")
    print(f"  K6 at a GQA group of {cfg.n_heads // cfg.n_kv_heads} on layer "
          f"0's tables: {dev_t}, events {entry['ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) [{smi_line}]")
    prompt, patches = r["prompt"], r["patches"]
    del r
    torch.cuda.empty_cache()
    _stepped_agrees(torch, dev, serve, check, cfg, params, prompt, "2q",
                    n=VLM_STEPPED, patches=patches)
    del params
    torch.cuda.empty_cache()
    _small_serve_agrees(torch, dev, serve, check, arch=VLM_ARCH)
    return entry


def _scan_entry(torch, check, name, kern_fn, plain_fn, args, state0,
                launches, bound_ms_by, keep) -> dict:
    """A scan kernel against its plain version on the same inputs from
    the same state: the final state bit-equal (the same products and
    sums, each rounded), the outputs within 1e-5 of their sum of absolute
    terms plus 1e-6 (the plain version on |args|, the arguments at
    indices ``keep``, positive decays, as they are; the kernel sums in
    another order), a second launch bit-identical; both timed with CUDA
    events."""
    s_k, s_p = state0.clone(), state0.clone()
    got = kern_fn(*args, s_k)
    want = plain_fn(*args, s_p)
    absargs = tuple(a if i in keep else a.abs() for i, a in enumerate(args))
    scale = plain_fn(*absargs, state0.abs())
    err = (got - want).abs()
    ok = bool((err <= 1e-5 * scale + 1e-6).all())
    s_again = state0.clone()
    again = kern_fn(*args, s_again)
    check(ok and bool(torch.equal(s_k, s_p)),
          f"{name} {tuple(args[0].shape)} vs plain: final state bit-equal "
          f"({bool(torch.equal(s_k, s_p))}), outputs within 1e-5 of their "
          f"sum of |terms| ({ok}), max abs err {float(err.max()):.3g}")
    check(bool(torch.equal(got, again)) and bool(torch.equal(s_k, s_again)),
          f"{name}: launched twice, bit-identical")
    st = state0.clone()
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces=("src/repro/models/ssm.py:165" if name.startswith("ssd")
                  else "src/repro/models/ssm.py:83"),
        launches=launches, max_abs_err=float(err.max()),
        ms=time_ms(lambda: kern_fn(*args, st), torch),
        plain_ms=time_ms(lambda: plain_fn(*args, st), torch, reps=3,
                         warmup=1),
        bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1], library_ms=None)


def _stepped_agrees(torch, dev, serve, check, cfg, params, prompt, tag,
                    n: int = 0, frames=None, patches=None) -> None:
    """The serve prefill (one chunked forward) of the first ``n``
    (SSM_STEPPED) prompt tokens against ``serve_step`` stepped over them
    from an empty cache, every cache field (each layer's state or keys
    and values, RWKV6's ``xprev``, the shared block's keys and values at
    those slots, Whisper's cross keys and values). Whisper's ``frames``
    are encoded once and the cross keys and values written into both
    caches; a VLM's ``patches`` take the first positions in both (the
    stepped one through ``serve_step(patches=)``). In the model's types
    (bf16): layer 0's fields and the shared block's first application's
    within 2e-2 (the tests' ``BF16_REL``) of their largest magnitude, the
    deeper ones measured (the chunked and stepped products round bf16 at
    other places, and the gap grows from layer to layer); with the params
    and caches in f32, every field within 1e-3 of its largest
    magnitude."""
    from repro_torch.models.model import encode, init_cache, serve_step
    n = n or SSM_STEPPED
    toks = prompt[:, :n].contiguous()
    B = toks.shape[0]
    enc_len = frames.shape[1] if frames is not None else 1

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else
                (v.float() if v.is_floating_point() else v)
                for k, v in tree.items()}

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())
    worst = None
    for label, p, cast in (("bf16", params, lambda c: c),
                           ("f32", None, f32)):
        if p is None:
            p = f32(params)
        caches = []
        for _ in range(2):
            caches.append(cast(init_cache(cfg, B, n + 1, clustered=False,
                                          enc_len=enc_len, device=dev)))
        chunked, stepped = caches
        cross = None
        if frames is not None:
            cross = encode(cfg, p, frames)[1]
            for f in ("xk", "xv"):
                stepped["stack"][f].copy_(cross[f])
        serve.prefill_into_cache(cfg, p, chunked, toks, cross=cross,
                                 patches=patches)
        del cross
        for i in range(n):
            serve_step(cfg, p, stepped, toks[:, i:i + 1], i, patches=patches)
        del p
        errs, first = {}, {}
        for part, fields in stepped.items():
            for f, want in fields.items():
                errs[f"{part}.{f}"] = rel(chunked[part][f], want)
                first[f"{part}.{f}[0]"] = rel(chunked[part][f][0], want[0])
        main = "state" if "state" in stepped["stack"] else "k"
        st_c, st_s = chunked["stack"][main], stepped["stack"][main]
        by_layer = [rel(st_c[i], st_s[i]) for i in range(st_s.shape[0])]
        print(f"  {tag}: the serve prefill of the first {n} tokens against "
              f"serve_step stepped over them, {label}: max rel err by field "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + "; layer 0 and the first application: "
              + ", ".join(f"{k} {v:.3g}" for k, v in first.items())
              + f"; the {main} by layer: "
              + " ".join(f"{v:.2g}" for v in by_layer))
        if "shared" in stepped:
            sh_c, sh_s = chunked["shared"], stepped["shared"]
            print(f"  {tag}: {label}: the shared block's keys, values by "
                  f"application: " + " ".join(
                      f"{rel(sh_c['k'][a], sh_s['k'][a]):.2g},"
                      f"{rel(sh_c['v'][a], sh_s['v'][a]):.2g}"
                      for a in range(sh_s["k"].shape[0])))
        if label == "bf16":
            check(max(first.values()) <= 2e-2,
                  f"{tag}: the prefill's layer 0 and first shared "
                  f"application equal a stepped prefill of {n} tokens in "
                  f"bf16 within rel 2e-2 ({max(first.values()):.3g})")
        worst = max(errs.values())
        del chunked, stepped, caches
        torch.cuda.empty_cache()
    check(worst <= 1e-3,
          f"{tag}: the prefill's cache equals a stepped prefill of {n} "
          f"tokens in f32 within rel 1e-3 ({worst:.3g})")


def _norm_leaves(tree):
    """The rmsnorm scales (``g``) of a params tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _norm_leaves(v)
        elif k == "g":
            yield v


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _envelope_agrees(torch, dev, serve, check) -> None:
    """A short run (the smoke config, 12 clustered steps, a fold every 4)
    on the card through the executor envelope and through direct calls,
    from copies of one cluster-major cache: the same tokens, logits and
    tables."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_cache, init_params
    cfg = get_smoke_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(6)
    params = init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (2, 48), generator=gen, device=dev,
                           dtype=torch.int32)
    cache = init_cache(cfg, 2, 48 + 13, clustered=False, device=dev)
    _, cache = serve.prefill_into_cache(cfg, params, cache, prompt)
    cache = serve.attach_clusters(cfg, cache, length=48)
    out = []
    for ex in (None, serve.serve_executor(cfg, params)):
        c = {"stack": {k: v.clone() for k, v in cache["stack"].items()}}
        c.update({k: v for k, v in cache.items() if k != "stack"})
        counts = c["stack"]["sizes"].float()
        toks, logits, c, _, folded = serve.decode(
            cfg, params, c, prompt[:, -1:], 48, 12, fold_every=4,
            counts=counts, executor=ex)
        out.append((toks, logits, c, folded))
    (t0, l0, c0, f0), (t1, l1, c1, f1) = out
    same = (all((a == b).all() for a, b in zip(t0, t1))
            and bool(torch.equal(l0, l1)) and f0 == f1
            and all(bool(torch.equal(c0["stack"][k], c1["stack"][k]))
                    for k in ("kt", "vt", "cent", "sizes")))
    check(same, "a short clustered decode (smoke config, 12 steps, folds "
                "every 4) through the executor envelope equals the direct "
                "calls: tokens, logits and tables")


def _small_serve_agrees(torch, dev, serve, check, arch: str = LM_ARCH,
                        kind: str = "cluster_major") -> None:
    """``arch``'s smoke config's serve path in f32 on the card against the
    plain CPU path on the same params and prompt: the prefill, then
    (``kind``) the cluster-major tables and 4 teacher-forced k²-attention
    decode steps (K6), the flat cache's member lists and 8 flat
    k²-attention steps (``"flat"``), or 8 full-attention steps
    (``"full"``, the MLA configs); logits within 1e-4 of their largest
    magnitude (f32, sums in other orders)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_cache, init_params, serve_step
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    steps = 4 if kind == "cluster_major" else 8

    def f32(t, where):
        if isinstance(t, dict):
            return {k: f32(v, where) for k, v in t.items()}
        return (t.float() if t.is_floating_point() else t).to(where)
    prompt = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(4))
    toks = torch.randint(0, cfg.vocab, (steps, 2, 1),
                         generator=torch.Generator().manual_seed(5))
    # Whisper's 24 encoder frames, or a VLM's patch rows
    extra = torch.randn((2, 24 if cfg.family == "audio" else cfg.n_patches,
                         cfg.d_model),
                        generator=torch.Generator().manual_seed(6))
    out = {}
    for where in ("cpu", dev):
        p = f32(params, where)
        cache = f32(init_cache(cfg, 2, 48 + steps + 1, clustered=False,
                               enc_len=24, device="cpu"), where)
        kw = ({"frames": extra.to(where)} if cfg.family == "audio" else
              {"patches": extra.to(where)} if cfg.n_patches else {})
        logits, cache = serve.prefill_into_cache(cfg, p, cache,
                                                 prompt.to(where), **kw)
        if kind == "cluster_major":
            cache = serve.attach_clusters(cfg, cache, length=48)
        elif kind == "flat":
            cache = serve.attach_member_lists(cfg, cache, length=48)
        logged = [logits]
        for i in range(steps):
            logits, cache = serve_step(cfg, p, cache, toks[i].to(where),
                                       48 + i)
            logged.append(logits)
        out[str(where)] = [s.cpu() for s in logged]
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(out[str(dev)], out["cpu"]))
    check(err <= 1e-4, f"small serve ({cfg.name} in f32, {cfg.n_layers} "
                       f"layers, {kind}, prefill and {steps} steps) on the "
                       f"card agrees with the plain CPU path: logits max "
                       f"rel err {err:.3g} (<= 1e-4)")


def k6_inputs(torch, lm):
    """K6's arguments on layer 0's cluster-major tables at a decode step
    of phase 2e or 2l (``lm``: ``serve.run``'s result with its ``cfg``): the
    layer's query for the last decoded token, f32 (B*H, dh), the tables
    (B*Hkv*kc, cap, dh), its top-p selection (B*H, p) and the sizes."""
    from repro_torch.kernels.cluster_attend import select_clusters
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import layer_params
    cfg, params, st = lm["cfg"], lm["params"], lm["cache"]["stack"]
    B, Hkv, _, cap, dh = st["kt"].shape[1:]
    H, p = cfg.n_heads, cfg.cluster_top_p
    p0 = layer_params(params["stack"], 0)
    h = params["embed"][lm["prompt"][:, -1:].long()]
    pos = torch.full((B, 1), lm["prompt"].shape[1] + LM_DECODE,
                     device=h.device)
    q, _, _ = attn.gqa_project(p0["attn"], rmsnorm(p0["ln1"], h), H, Hkv, dh,
                               pos, cfg.rope_theta, cfg.qk_norm)
    sel = select_clusters(q[:, 0], st["cent"][0], p)  # the decode path's
    qf = q[:, 0].reshape(B * H, dh).float().contiguous()
    kt = st["kt"][0].reshape(-1, cap, dh)
    vt = st["vt"][0].reshape(-1, cap, dh)
    sizes = st["sizes"][0].reshape(-1)
    return qf, kt, vt, sel, sizes


def _k6_entry(torch, check, lm, cluster_attend_partial, ref,
              name: str = "cluster_attend", inputs=None) -> dict:
    """K6 on layer 0's cluster-major tables at a decode step (the layer's
    query for the last decoded token, its top-p selection; or ``inputs``,
    K6's arguments (q, k_table, v_table, sel, sizes) recorded at a decode
    step) against its plain version, launched twice and held
    bit-identical to itself; its bound and SDPA over the pre-gathered
    blocks."""
    import torch.nn.functional as F
    qf, kt, vt, sel, sizes = inputs or k6_inputs(torch, lm)
    B, H, p = lm["prompt"].shape[0], lm["cfg"].n_heads, sel.shape[1]
    cap, dh = kt.shape[1:]

    def kern():
        return cluster_attend_partial(qf, kt, vt, sel, sizes=sizes)

    def plain():
        return ref.cluster_attend_ref(qf, kt, vt, sel, sizes=sizes)
    (m, l, acc), (m_p, l_p, acc_p) = kern(), plain()
    acc_abs = ref.cluster_attend_ref(qf, kt, vt.abs(), sel, sizes=sizes)[2]
    empty = torch.isinf(m_p)
    live = ~empty
    res = torch.exp(m[live] - m_p[live])
    ok = bool(torch.equal(torch.isinf(m), empty)) \
        and bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all()) \
        and torch.allclose(m[live], m_p[live], rtol=1e-5, atol=1e-6) \
        and torch.allclose(l[live] * res, l_p[live], rtol=1e-5, atol=0.0) \
        and bool(((acc[live] * res[:, None] - acc_p[live]).abs()
                  <= 1e-5 * acc_abs[live] + 1e-6).all())
    out_k = acc / torch.clamp(l, min=1e-30)[:, None]
    out_p = acc_p / torch.clamp(l_p, min=1e-30)[:, None]
    err = float((out_k - out_p).abs().max())
    check(ok, f"{name}: K6 on layer 0's tables ({tuple(kt.shape)} bf16, "
              f"dh={dh}, {B * H} rows, p={p}) vs plain: m, l within rtol 1e-5 (rescaled to "
              f"the plain max), acc within atol 1e-5 of the row's sum of "
              f"w|v|, empty rows exact; "
              f"attention output max abs err {err:.3g}")
    again = kern()
    same = all(bool(torch.equal(a, b)) for a, b in zip((m, l, acc), again))
    check(same, f"{name}: K6 launched twice on layer 0's tables: "
                f"bit-identical ({same})")
    # bound: the distinct selected blocks' live rows of K and V (bf16),
    # q, sel and the sizes read, the outputs written; 4 dh FLOPs per
    # (query row, live row) pair; an id -1 (a cluster another shard holds,
    # phase 2t) selects nothing
    s = sel.long()
    here = s >= 0
    s = s.clamp(min=0)
    ids = torch.unique(s[here])
    live_rows = int(sizes.long()[ids].sum())
    pair_rows = int((sizes.long()[s] * here).sum())
    n_bytes = (live_rows * dh * 2 * 2 + qf.numel() * 4 + sel.numel() * 4
               + ids.numel() * 4 + B * H * (dh + 2) * 4)
    b_ms, b_by = bound(n_bytes, 4.0 * dh * pair_rows)
    # SDPA over the pre-gathered blocks with the validity mask (the gather
    # is outside the timed call)
    kk = kt[s].reshape(B * H, 1, p * cap, dh)
    vv = vt[s].reshape(B * H, 1, p * cap, dh)
    mask = ((torch.arange(cap, device=qf.device)
             < sizes.long()[s][..., None]) & here[..., None]).reshape(
        B * H, 1, 1, p * cap)
    qb = qf.to(torch.bfloat16).reshape(B * H, 1, 1, dh)
    print(f"  K6 at the decode step: {live_rows} distinct live rows in "
          f"{ids.numel()} selected blocks, {pair_rows} (row, block) reads, "
          f"mean block size {float(sizes.float().mean()):.2f} of {cap}")
    entry = dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/cluster_attend.cu",
        replaces="src/repro/kernels/cluster_attend.py:67",
        launches=lm["launches_all"]["cluster_attend"], max_abs_err=err,
        ms=time_ms_cold(kern, torch),
        plain_ms=time_ms_cold(plain, torch), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms_cold(lambda: F.scaled_dot_product_attention(
            qb, kk, vv, attn_mask=mask), torch))
    # the profiler's time is kept only where it is not below the bytes
    # bound: below it the tables were read from L2 in spite of the flush
    dev_ms = device_ms(kern, torch, flush=True)
    if dev_ms >= b_ms:
        entry["device_ms"] = dev_ms
    else:
        print(f"  {name}: the profiler's device time {dev_ms:.4f} ms is "
              f"below the bytes bound {b_ms:.4f} ms, which a read from HBM "
              f"cannot be: not kept")
    return entry


def _fixture_agrees(torch, dev, check, rounding_fixture, K2Step,
                    center_knn_graph, pad_candidates, candidate_tables,
                    candidate_assign_tiled, candidate_assign_rowwise,
                    distance_argmin, center_sqdist, ref) -> None:
    """K5, K1 and K7 against their plain versions on rows whose products
    with their own centers sit just above f32 rounding midpoints (f64
    sums in different orders round them apart), and K2 on those rows and
    centers taken together as one center set: bit-equal."""
    k, kn = 64, 8
    x, c, a = rounding_fixture(k * 40, k, D, seed=17, device=dev)
    same5 = all(bool(torch.equal(g, w)) for g, w in zip(
        distance_argmin(x, c), ref.distance_argmin_ref(x, c)))
    st = K2Step(k=k, kn=kn, bkn=BKN).init_resident(
        x, torch.ones(x.shape[0], device=dev), c, a)
    nb = st.b2c.shape[0]
    bn = st.pid.shape[0] // nb
    graph = center_knn_graph(c, kn)
    cidx = pad_candidates(graph, BKN).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    zi = torch.zeros(st.pid.shape[0], dtype=torch.int32, device=dev)
    zf = torch.zeros(st.pid.shape[0], device=dev)
    noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
    args = (st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf)
    same1 = all(bool(torch.equal(g, w)) for g, w in zip(
        candidate_assign_tiled(*args, bn=bn, bkn=BKN),
        ref.candidate_assign_tiled_ref(*args, bn)))
    args7 = (st.xg, c, graph[rowsel.long()].contiguous(), noskip, zi, zf)
    same7 = all(bool(torch.equal(g, w)) for g, w in zip(
        candidate_assign_rowwise(*args7, bn=bn),
        ref.candidate_assign_ref(*args7, bn)))
    check(same5 and same1 and same7,
          f"K5, K1 and K7 on the rounding fixture ({x.shape[0]} rows at f32 "
          f"rounding midpoints, k={k}, d={D}) vs plain: bit-equal "
          f"({same5}, {same1}, {same7})")
    cs = torch.cat([x, c]).contiguous()
    got, want = center_sqdist(cs), ref.center_sqdist_ref(cs)
    check(bool(torch.equal(got, want)),
          f"K2 on the rounding fixture's rows and centers ({cs.shape[0]} x "
          f"{D}, products at f32 midpoints) vs plain: bit-equal, max abs err "
          f"{float((got - want).abs().max()):.3g}")


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def _int8_fit_phase(torch, dev, x, res, check) -> dict:
    """Phase 2g: the int8 fit arena. ``fit(..., precision="int8")`` from
    phase 2's generator seed (GDI on the card is reproducible, so from
    phase 2's init), counts set to 0 just before: bit-identical to phase
    2's f32 fit, with the scan on the int8 lanes and moved rows at
    d + 16 bytes against 4 (d + 3). Returns its result and launches."""
    from repro_torch.core import fit, fit_k2means, initialize, OpCounter
    from repro_torch.kernels import _build
    c0, a0 = initialize(x, K, "gdi",
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        OpCounter())
    fit_k2means(x, c0, a0, kn=KN, max_iters=2, precision="int8",
                device=dev)                                     # warm-up
    del c0, a0
    torch.cuda.synchronize()
    _build.reset_launches()
    r8 = fit(x, K, method="k2means", init="gdi", kn=KN, max_iters=MAX_ITERS,
             precision="int8", device=dev, profile=True,
             generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    launches = _build.launches()
    p8, pf = r8.profile, res.profile
    ms8 = p8["iterate_s"] / max(r8.iterations, 1) * 1e3
    ms32 = pf["iterate_s"] / max(res.iterations, 1) * 1e3
    k4 = launches["candidate_assign_int8_tiled"]
    print(f"phase 2g: int8 fit n={N} d={D} k={K} kn={KN}: {r8.iterations} "
          f"iterations, {ms8:.2f} ms/iteration (phase 2's f32 fit "
          f"{ms32:.2f}), GDI {p8['init_s']:.3f} s, energy {r8.energy:.6g}; "
          f"K4 launches {k4} ({k4 / max(r8.iterations, 1):.2f} per "
          f"iteration), launches {launches}")
    print(f"  counted f32 distances {p8['distances']:.6g} (f32 fit "
          f"{pf['distances']:.6g}), int8 ops {p8['int8_ops']:.6g}, scan "
          f"bytes {p8['bytes_scanned']:.6g} (f32 {pf['bytes_scanned']:.6g},"
          f" ratio {p8['bytes_scanned'] / pf['bytes_scanned']:.4f}), layout "
          f"bytes gathered {p8['bytes_gathered']:.6g} (f32 "
          f"{pf['bytes_gathered']:.6g}, ratio "
          f"{p8['bytes_gathered'] / max(pf['bytes_gathered'], 1):.4f})")
    same = (bool(torch.equal(r8.assignment, res.assignment))
            and bool(torch.equal(r8.centers, res.centers))
            and r8.energy == res.energy and r8.iterations == res.iterations)
    check(same, f"the int8 fit is bit-identical to phase 2's f32 fit: "
                f"{int((r8.assignment != res.assignment).sum())} assignments"
                f" differ, centers equal "
                f"{bool(torch.equal(r8.centers, res.centers))}, energy "
                f"{r8.energy:.9g} vs {res.energy:.9g}, iterations "
                f"{r8.iterations} vs {res.iterations}")
    check(k4 == r8.iterations and launches["candidate_assign_tiled"] == 0,
          f"K4 launched once per int8 iteration and K1 not at all ({k4} "
          f"for {r8.iterations}, K1 {launches['candidate_assign_tiled']})")
    check(p8["int8_ops"] > 0 and pf["int8_ops"] == 0
          and p8["distances"] < pf["distances"],
          f"int8 ops counted ({p8['int8_ops']:.6g}) and fewer f32 distances"
          f" than the f32 fit ({p8['distances']:.6g} < "
          f"{pf['distances']:.6g})")
    check(all(p8[lane] * 4 * (D + 3) == pf[lane] * (D + 16)
              for lane in ("bytes_gathered", "bytes_scattered")),
          f"moved rows cost d + 16 = {D + 16} bytes against 4 (d + 3) = "
          f"{4 * (D + 3)}: bytes_gathered {p8['bytes_gathered']:.6g} vs "
          f"{pf['bytes_gathered']:.6g}, bytes_scattered "
          f"{p8['bytes_scattered']:.6g} vs {pf['bytes_scattered']:.6g}")
    return dict(launches=launches, ms=ms8, iterations=r8.iterations)


def k4_fit_inputs(torch, x, c, assignment):
    """K4's arguments over the int8 fit arena of ``x`` under
    ``assignment`` and the centers ``c`` (bn = 32, 92,000 slots at the
    fit's shape), no block skipped, with the re-rank's f32 masters and
    slab tables, and its bound: (args, bn, (bound ms, what bounds it),
    (xf, ctab, csqtab, rowsel) for ``slab_sqdist``)."""
    from repro_torch.core import K2Step, center_knn_graph
    from repro_torch.kernels import quant
    from repro_torch.kernels.candidate_assign import (candidate_tables,
                                                      pad_candidates)
    dev = x.device
    st = K2Step(k=K, kn=KN, bkn=BKN, precision="int8").init_resident(
        x, torch.ones(x.shape[0], device=dev), c, assignment)
    nb, rows = st.b2c.shape[0], st.pid.shape[0]
    bn = rows // nb
    xf = torch.where((st.pid >= 0)[:, None],
                     x[st.pid.clamp(min=0).long()], 0.0).contiguous()
    cidx = pad_candidates(center_knn_graph(c, KN), BKN).contiguous()
    knp = cidx.shape[1]
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
    args = (st.xg, st.xsc, quant.residual_norm(xf, st.xg, st.xsc),
            *quant.quantized_candidate_slabs(quant.center_quant(c), cidx),
            rowsel, noskip)
    slabs = int(torch.unique(rowsel).numel())
    ctab, csqtab = candidate_tables(c, cidx)
    return args, bn, bound(
        rows * (D + 8.0) + slabs * knp * (D + 12.0) + nb * 8.0
        + rows * (4.0 * 8 + 8.0), 2.0 * rows * knp * D, INT8_OP_PER_S), \
        (xf, ctab, csqtab, rowsel)


def _guard_clean(torch, x, res, sb_kw, n):
    """The guard's counters over the arena a fit's result rebuilds
    (non-finite rows quarantined at weight 0)."""
    from repro_torch.core import K2Step
    from repro_torch.ft.invariants import make_guard
    sb = K2Step(**sb_kw)
    w = torch.isfinite(x).all(1).to(torch.float32)
    xs = torch.where(w[:, None] > 0, x, 0.0)
    st = sb.init_resident(xs, w, res.centers, res.assignment)
    return make_guard(sb, n)(st).cpu().tolist()


def _ft_phase(torch, dev, x, check) -> dict:
    """Phase 2h: fault tolerance at the mnist shape, from phase 2's GDI
    init. (a) a rebuild fit checkpointing every 3 iterations, killed by a
    ``FaultInjector(preempt_at=5)``, resumed: equal to the uninterrupted
    fit, one restore. (b) a guarded resident fit under NaN rows, a
    poisoned center and poisoned slots: regroup and split each heal, the
    result guard-clean and finite. (c) (b)'s schedule at a small shape
    (ROADMAP §3 entry 9's integer blobs) on the card and on the CPU: the
    same events, repairs and final assignment."""
    import shutil
    from repro_torch.core import OpCounter, fit_k2means, initialize
    from repro_torch.ft import FaultInjector, Preemption
    from repro_torch.kernels import _build
    c0, a0 = initialize(x, K, "gdi",
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        OpCounter())
    out = {}
    # (a) kill and resume, rebuild residency
    ckpt = ROOT / "build" / "fit_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(kn=KN, max_iters=MAX_ITERS, residency="rebuild", device=dev)
    t0 = time.perf_counter()
    base = fit_k2means(x, c0, a0, **kw)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    preempted = False
    try:
        with FaultInjector(seed=0, preempt_at=5):
            fit_k2means(x, c0, a0, ckpt_dir=str(ckpt), ckpt_every=3, **kw)
    except Preemption:
        preempted = True
    ctr = OpCounter()
    t0 = time.perf_counter()
    resumed = fit_k2means(x, c0, a0, ckpt_dir=str(ckpt), ckpt_every=3,
                          resume=True, counter=ctr, **kw)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    same = bool(torch.equal(resumed.assignment, base.assignment))
    print(f"phase 2h: (a) rebuild fit {base.iterations} iterations in "
          f"{t_base:.3f} s; killed before iteration 5, resumed from the "
          f"step-3 checkpoint: {resumed.iterations} more iterations in "
          f"{t_res:.3f} s (checkpoint read included), repairs "
          f"{ctr.repairs}")
    check(preempted and same and ctr.repairs["restore"] == 1
          and base.iterations >= 5
          and resumed.iterations == base.iterations - 3,
          f"kill and resume: preempted {preempted}, the resumed fit's "
          f"assignment equals the uninterrupted one "
          f"({int((resumed.assignment != base.assignment).sum())} differ), "
          f"restores {ctr.repairs['restore']}")
    del base, resumed
    # (b) a chaos fit with guards, resident f32
    sched = dict(nan_rows={2: 16}, poison_centers={4: 3},
                 poison_slots={6: 16})
    torch.cuda.synchronize()
    _build.reset_launches()
    ctr = OpCounter()
    t0 = time.perf_counter()
    with FaultInjector(seed=SEED, **sched) as inj:
        r = fit_k2means(x, c0, a0, kn=KN, max_iters=MAX_ITERS, guards=True,
                        counter=ctr, key=SEED, device=dev)
    torch.cuda.synchronize()
    t_chaos = time.perf_counter() - t0
    launches = _build.launches()
    vio = _guard_clean(torch, x, r, dict(k=K, kn=KN, bkn=BKN), N)
    print(f"  (b) guarded chaos fit ({sched}): {r.iterations} iterations in "
          f"{t_chaos:.3f} s, events {inj.events}, repairs {ctr.repairs}, "
          f"quarantined rows {int(ctr.sanitized_rows)}, energy "
          f"{r.energy:.6g}, guard on the result {vio}, launches {launches}")
    check(ctr.repairs["regroup"] >= 1 and ctr.repairs["split"] >= 1
          and ctr.sanitized_rows == 16,
          f"the chaos fit healed by regroup ({ctr.repairs['regroup']}) and "
          f"split ({ctr.repairs['split']}) and quarantined the 16 NaN rows "
          f"({int(ctr.sanitized_rows)})")
    check(_finite(r.energy) and bool(torch.isfinite(r.centers).all())
          and sum(vio) == 0,
          f"the chaos fit ends finite and guard-clean (energy "
          f"{r.energy:.6g}, guard {vio})")
    check(launches["segmented_scan"] > 0
          and launches["candidate_assign_tiled"] > 0,
          f"the split rung ran K3 ({launches['segmented_scan']}) and the fit"
          f" K1 ({launches['candidate_assign_tiled']})")
    out["chaos_launches"] = launches
    del r, c0, a0
    # (c) the schedule at a small shape, card against CPU
    xs, init = _entry9_blobs(torch)
    a_s = torch.cdist(xs, init).argmin(1).to(torch.int32)
    small = dict(nan_rows={2: 8}, poison_centers={4: 2}, poison_slots={6: 5})
    got = {}
    for where in ("cpu", dev):
        ctr = OpCounter()
        with FaultInjector(seed=5, **small) as inj:
            rs = fit_k2means(xs, init, a_s, kn=8, max_iters=20, guards=True,
                             counter=ctr, key=1, device=where)
        got[str(where)] = (rs.assignment.cpu(), ctr.repairs, inj.events,
                           int(ctr.sanitized_rows))
    (ac, rc, ec, sc), (ag, rg, eg, sg) = got["cpu"], got[str(dev)]
    print(f"  (c) small chaos fit (n=3000, d=16, k=48, {small}): repairs "
          f"{rg} (CPU {rc}), events {eg}")
    check(ec == eg and rc == rg and sc == sg and bool(torch.equal(ac, ag))
          and rg["regroup"] >= 1 and rg["split"] >= 1,
          f"the small chaos fit on the card equals the CPU's: events "
          f"{ec == eg}, repairs {rc == rg}, quarantined {sg} vs {sc}, "
          f"assignments {int((ac != ag).sum())} differ")
    return out


def _entry9_blobs(torch):
    """ROADMAP §3 entry 9's integer blobs (n=3000, d=16, 12 components,
    every fifth row a duplicate) and 48 of their rows as centers, on the
    CPU: their sums are exact in any order."""
    rng = torch.Generator().manual_seed(2)
    mus = torch.round(torch.randn(12, 16, generator=rng) * 12)
    xs = torch.round(mus[torch.randint(0, 12, (3000,), generator=rng)]
                     + torch.randn(3000, 16, generator=rng) * 1.5)
    xs[::5] = xs[1::5][:len(xs[::5])]
    return xs, xs[torch.randperm(3000, generator=rng)[:48]]


def _exec_run(torch, dev, res, trace, sched, pool_rows):
    """One executor run over the predict-only model built from ``res``
    (fresh, so a replay starts from the same state) under a chaos
    schedule (transient failures retried after 0.05 and 0.1 s)."""
    from repro_torch.core import KMeansModel, OpCounter
    from repro_torch.ft import FaultInjector
    from repro_torch.kernels import _build
    from repro_torch.serve import (ServeConfig, ServeExecutor,
                                   requests_from_trace)
    model = KMeansModel.from_result(res, kn=KN, device=dev)
    ex = ServeExecutor(model, ServeConfig(retries=3), OpCounter())
    ex.warmup()
    reqs = requests_from_trace(trace, pool_rows)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with FaultInjector(seed=SEED, **sched) as inj:
        resps = ex.run_trace(reqs)
    torch.cuda.synchronize()
    return dict(model=model, ex=ex, reqs=reqs, resps=resps, inj=inj,
                wall=time.perf_counter() - t0, launches=_build.launches())


def _serve_phase(torch, dev, res, queries, check) -> dict:
    """Phase 2i: the serving plane over phase 2's model. A Poisson trace
    of the held-out queries (requests of 256 rows) with a burst at 4x the
    sustainable rate, under poisoned queries, a slow consumer and
    transient ``serve_predict`` failures, replayed twice: identical
    responses and rung transcripts; FULL and INT8_SCAN answers equal
    ``model.predict``'s; every request answered or typed; the ladder
    climbs and recovers; retries and quarantined rows counted."""
    from repro_torch.core import KMeansModel
    from repro_torch.ft import poisson_trace
    from repro_torch.serve import (FULL, INT8_SCAN, ROUTE_ONLY, Overloaded,
                                   ServeConfig, ServeExecutor)
    rows = 256
    probe = ServeExecutor(KMeansModel.from_result(res, kn=KN, device=dev),
                          ServeConfig())
    qps = probe.sustainable_qps()
    del probe
    rate = 0.5 * qps / rows                      # requests/s, calm
    horizon = NQ / rows / rate / 2.3             # about the pool, burst in
    trace = poisson_trace(SEED, rate=rate, horizon=horizon, rows=rows,
                          deadline=0.005,
                          bursts=((0.3 * horizon, 0.5 * horizon, 8.0),))
    sched = dict(poison_queries={5: 7, 40: 3}, slow_consumer={12: 0.02},
                 fail_calls={"serve_predict": (3, 30)})
    pool = queries.cpu().numpy()
    runs = [_exec_run(torch, dev, res, trace, sched, pool)
            for _ in range(2)]
    r1, r2 = runs
    ex, resps, reqs = r1["ex"], r1["resps"], r1["reqs"]
    same = len(r1["resps"]) == len(r2["resps"]) and all(
        (a.rid, a.status, a.rung, a.t_done, a.reason)
        == (b.rid, b.status, b.rung, b.t_done, b.reason)
        and (a.result is None) == (b.result is None)
        and (a.result is None or (a.result == b.result).all())
        for a, b in zip(r1["resps"], r2["resps"]))
    same = same and ex.ladder.transcript == r2["ex"].ladder.transcript \
        and r1["inj"].events == r2["inj"].events
    st = ex.stats()
    n_rows = sum(r.rows for r in reqs)
    print(f"phase 2i: executor over phase 2's model, {len(reqs)} requests x "
          f"{rows} rows ({n_rows} rows) at {rate * rows:.0f} rows/s, burst "
          f"x8 over [{0.3 * horizon:.4f}, {0.5 * horizon:.4f}] s; "
          f"sustainable {qps:.0f} rows/s; {st['batches']} batches; virtual "
          f"clock {ex.now:.4f} s ({ex.now / max(st['batches'], 1) * 1e3:.3f} "
          f"ms a batch), wall {r1['wall']:.3f} s "
          f"({ex.wall_s / max(st['batches'], 1) * 1e3:.3f} ms a batch in "
          f"the executed batches, replay {r2['wall']:.3f} s)")
    print(f"  responses ok {st['responses_ok']}, overloaded "
          f"{st['responses_overloaded']}, rejected {st['responses_rejected']};"
          f" degrades {st['degrades']}; retries {st['retries']}, quarantined "
          f"rows {st['sanitized_rows']}; rung transitions "
          f"{len(ex.ladder.transcript)}: "
          f"{[(o, n) for _, o, n, _ in ex.ladder.transcript]}; launches "
          f"{r1['launches']}")
    check(same, "two replays of the trace give identical responses, rung "
                "transcripts and events")
    answered = len(resps) == len(reqs) and all(
        r.status in ("ok", "rejected")
        or (r.status == "overloaded" and isinstance(r, Overloaded))
        for r in resps)
    check(answered, f"every request answered ok, rejected or typed "
                    f"Overloaded ({len(resps)} responses for {len(reqs)})")
    moves = [(o, n) for _, o, n, _ in ex.ladder.transcript]
    top = max((n for _, n in moves), default=0)
    peak = max((i for i, (_, n) in enumerate(moves) if n == top), default=0)
    back = any(n == FULL for _, n in moves[peak:])
    check(top >= ROUTE_ONLY and back,
          f"the ladder climbed to rung {top} (>= ROUTE_ONLY) under the "
          f"burst and came back to FULL after it ({back})")
    check(st["retries"] >= 2 and st["sanitized_rows"] == 10,
          f"retries ({st['retries']}) and quarantined rows "
          f"({st['sanitized_rows']}) counted")
    want = r1["model"].predict(queries, batch_size=BATCH).cpu().numpy()
    poisoned = set(sched["poison_queries"])
    checked = differ = 0
    for r, q in zip(resps, reqs):
        if r.ok and r.rung in (FULL, INT8_SCAN) and q.rid not in poisoned:
            checked += 1
            differ += int((r.result != want[q.meta]).sum())
    check(checked > 0 and differ == 0,
          f"FULL and INT8_SCAN answers equal model.predict's ({checked} "
          f"requests, {differ} rows differ)")
    lc = r1["launches"]
    check(lc["candidate_assign_tiled"] > 0
          and lc["candidate_assign_int8_tiled"] > 0,
          f"the executor's FULL rung ran K1 ({lc['candidate_assign_tiled']})"
          f" and its int8 rungs K4 ({lc['candidate_assign_int8_tiled']})")
    return dict(launches=lc, max_rung=top, shed=st["degrades"]["shed"])


def _small_fit_agrees(torch, dev, fit_k2means, check) -> None:
    """A small fit through the kernels against the plain PyTorch path on
    the CPU, from one init: same iteration count, assignments and
    energies (rel 1e-5)."""
    g = torch.Generator().manual_seed(7)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    init = x[torch.randperm(3000, generator=g)[:24]]
    a0 = torch.cdist(x, init).argmin(1).to(torch.int32)
    r_gpu = fit_k2means(x, init, a0, kn=8, max_iters=30, device=dev)
    r_cpu = fit_k2means(x, init, a0, kn=8, max_iters=30, device="cpu")
    same = bool((r_gpu.assignment.cpu() == r_cpu.assignment).all())
    rel = abs(r_gpu.energy - r_cpu.energy) / abs(r_cpu.energy)
    check(same and r_gpu.iterations == r_cpu.iterations and rel <= 1e-5,
          f"small fit (n=3000, d=16, k=24) on the card equals the plain "
          f"CPU path: assignments {same}, iterations {r_gpu.iterations} "
          f"vs {r_cpu.iterations}, energy rel diff {rel:.2g}")


def _small_gdi_fit_agrees(torch, dev, fit_k2means, check) -> None:
    """The small fit's rows again, from GDI (the same uniform draws on
    both devices) at k = 24 on 16 blobs, so that GDI splits blobs where
    rows score within rounding of each other: the card's GDI and
    k²-means against the plain CPU path, same GDI assignment, same
    iteration count and assignments, energies within rel 1e-5."""
    from repro_torch.core.gdi import gdi_device_init
    g = torch.Generator().manual_seed(7)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    draws = [(torch.rand(3000, generator=g), torch.rand(3000, generator=g))
             for _ in range(64)]
    out = {}
    for where in ("cpu", dev):
        c0, a0 = gdi_device_init(x, 24, draws=draws, device=where)
        out[str(where)] = (a0.cpu(), fit_k2means(x, c0, a0, kn=8,
                                                 max_iters=30, device=where))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out["cpu"], out[str(dev)]
    same_init = bool(torch.equal(a_cpu, a_gpu))
    same = bool((r_gpu.assignment.cpu() == r_cpu.assignment).all())
    rel = abs(r_gpu.energy - r_cpu.energy) / abs(r_cpu.energy)
    check(same_init and same and r_gpu.iterations == r_cpu.iterations
          and rel <= 1e-5,
          f"small fit from GDI (n=3000, d=16, k=24) on the card equals the "
          f"plain CPU path: GDI assignments {same_init}, k2-means "
          f"assignments {same}, iterations {r_gpu.iterations} vs "
          f"{r_cpu.iterations}, energy rel diff {rel:.2g}")


def _methods_phase(torch, dev, x, res, check) -> None:
    """Phase 2j: the ungrouped xla backend from host GDI, then from phase
    2's GDI init against the kernels path; gdi_parallel_init, MiniBatch
    and AKM at the mnist shape; and the host-drawn methods card = CPU at
    a small shape (module docstring)."""
    from repro_torch.core import (OpCounter, fit, fit_akm, fit_k2means,
                                  fit_minibatch, gdi_parallel_init,
                                  initialize)
    from repro_torch.kernels import _build

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 1)
    ms2 = res.profile["iterate_s"] / max(res.iterations, 1) * 1e3
    # (a) host GDI then xla rebuild k²-means, twice
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        _build.reset_launches()
        r = fit(x, K, backend="xla", init="gdi", kn=KN, max_iters=MAX_ITERS,
                device=dev, profile=True, generator=gen())
        torch.cuda.synchronize()
        runs.append((r, _build.launches()))
    (rx, lx), (rx2, _) = runs
    hist = [e for _, e in rx.history]
    print(f"phase 2j: (a) fit(backend='xla', init='gdi'): host GDI "
          f"{rx.profile['init_s']:.3f} s, {rx.iterations} iterations, "
          f"{rx.profile['iterate_s'] / max(rx.iterations, 1) * 1e3:.2f} "
          f"ms/iteration (phase 2's kernels fit {ms2:.2f}), energy "
          f"{rx.energy:.6g} (phase 2 {res.energy:.6g}), counted ops "
          f"{rx.ops:.6g}, launches {lx}")
    check(lx["segmented_scan"] > 0 and lx["center_sqdist"] == rx.iterations
          and lx["candidate_assign_tiled"] == 0,
          f"the xla fit from host GDI launched K3 ({lx['segmented_scan']}) "
          f"and K2 once per iteration ({lx['center_sqdist']} for "
          f"{rx.iterations}), K1 never ({lx['candidate_assign_tiled']})")
    check(len(hist) == rx.iterations and all(map(_finite, hist))
          and all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
          "the xla fit's energy history finite and non-increasing "
          "(rel 1e-6)")
    same = (bool(torch.equal(rx.assignment, rx2.assignment))
            and bool(torch.equal(rx.centers, rx2.centers))
            and rx.energy == rx2.energy and rx.iterations == rx2.iterations)
    check(same, f"the xla fit from host GDI again is bit-identical: "
                f"{int((rx.assignment != rx2.assignment).sum())} "
                f"assignments differ, iterations {rx.iterations} vs "
                f"{rx2.iterations}")
    del rx2, runs
    # (b) from phase 2's GDI init: xla against kernels in each residency
    c0, a0 = initialize(x, K, "gdi", gen(), OpCounter())
    pairs = {}
    for residency in ("resident", "rebuild"):
        out = []
        for backend in ("xla", "kernels"):
            if backend == "kernels" and residency == "resident":
                out.append((res, None, ms2))   # phase 2's fit
                continue
            ctr = OpCounter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fit_k2means(x, c0, a0, kn=KN, max_iters=MAX_ITERS,
                            backend=backend, residency=residency,
                            counter=ctr, device=dev)
            torch.cuda.synchronize()
            out.append((r, ctr, (time.perf_counter() - t0)
                        / max(r.iterations, 1) * 1e3))
        pairs[residency] = out
        (r1, c1, ms_x), (r2, _, ms_k) = out
        rel = abs(r1.energy - r2.energy) / abs(r2.energy)
        print(f"  (b) {residency}: xla {r1.iterations} iterations at "
              f"{ms_x:.2f} ms/iteration, energy {r1.energy:.9g}, counted "
              f"distances {c1.distances:.6g}; kernels {r2.iterations} at "
              f"{ms_k:.2f} ms/iteration, energy {r2.energy:.9g}")
        check(bool(torch.equal(r1.assignment, r2.assignment))
              and bool(torch.equal(r1.centers, r2.centers))
              and r1.iterations == r2.iterations and rel <= 1e-6,
              f"xla {residency} equals kernels {residency} from phase 2's "
              f"init: {int((r1.assignment != r2.assignment).sum())} "
              f"assignments differ, centers equal "
              f"{bool(torch.equal(r1.centers, r2.centers))}, iterations "
              f"{r1.iterations} vs {r2.iterations}, energy rel diff "
              f"{rel:.2g}")
    del pairs
    # (c) gdi_parallel_init at k = 1000, then MiniBatch at its default
    ctr = OpCounter()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cp, ap = gdi_parallel_init(x, K, generator=torch.Generator().manual_seed(
        SEED + 3), counter=ctr, device=dev)
    torch.cuda.synchronize()
    t_par = time.perf_counter() - t0
    lp = _build.launches()
    e_par = float(torch.sum((x - cp[ap.long()]) ** 2))
    print(f"  (c) gdi_parallel_init k={K}: {t_par:.3f} s, energy "
          f"{e_par:.6g}, counted ops {ctr.total:.6g}, K3 "
          f"{lp['segmented_scan']}, K5 {lp['distance_argmin']}")
    rounds = (K - 1).bit_length()           # ceil(log2 K)
    check(lp["segmented_scan"] == 2 * rounds and lp["distance_argmin"] == 1
          and cp.shape == (K, D) and 0 <= int(ap.min())
          and int(ap.max()) < K and _finite(e_par),
          f"gdi_parallel_init: K3 twice in each of {rounds} rounds "
          f"({lp['segmented_scan']}), K5 once for the dropped leaves "
          f"({lp['distance_argmin']}), a finite k-way init")
    ctr = OpCounter()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rm = fit_minibatch(x, cp, generator=torch.Generator().manual_seed(
        SEED + 4), counter=ctr, device=dev)
    torch.cuda.synchronize()
    t_mb = time.perf_counter() - t0
    lm = _build.launches()
    evals = len(rm.history)
    print(f"  (c) MiniBatch: {rm.iterations} batches of 100 in {t_mb:.3f} s "
          f"({t_mb / rm.iterations * 1e3:.3f} ms/batch), energy "
          f"{rm.energy:.6g} (from {e_par:.6g}), counted ops {rm.ops:.6g}, "
          f"K5 {lm['distance_argmin']} ({evals} evaluations)")
    check(lm["distance_argmin"] == rm.iterations + evals
          and rm.iterations == 2 * N // 100
          and all(_finite(e) for _, e in rm.history),
          f"MiniBatch: K5 once a batch and once an evaluation "
          f"({lm['distance_argmin']} for {rm.iterations} + {evals}), a "
          f"finite history")
    # (d) AKM at m = 30 from phase 2's GDI init, capped at 20 iterations
    ctr = OpCounter()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ra = fit_akm(x, c0, generator=torch.Generator().manual_seed(SEED + 5),
                 m=30, max_iters=20, counter=ctr, device=dev)
    torch.cuda.synchronize()
    t_akm = time.perf_counter() - t0
    la = _build.launches()
    ha = [e for _, e in ra.history]
    print(f"  (d) AKM m=30: {ra.iterations} iterations in {t_akm:.3f} s "
          f"({t_akm / ra.iterations * 1e3:.2f} ms/iteration), energy "
          f"{ra.energy:.6g}, counted ops {ra.ops:.6g}, K5 "
          f"{la['distance_argmin']}, exact_rowdot {la['exact_rowdot']}")
    check(la["distance_argmin"] == 5 * ra.iterations
          and all(map(_finite, ha))
          and all(b <= a * (1 + 1e-6) for a, b in zip(ha, ha[1:])),
          f"AKM: K5 five times an iteration ({la['distance_argmin']} for "
          f"{ra.iterations}: 4 grouping steps and the routing), history "
          f"finite and non-increasing (rel 1e-6)")
    _small_methods_agree(torch, dev, check)


def _small_methods_agree(torch, dev, check) -> None:
    """Phase 2j (e): gdi_parallel_init then MiniBatch, and AKM, at n =
    3000, d = 16, k = 48 on the card and on the CPU from one generator
    seed: identical assignments and centers."""
    from repro_torch.core import fit_akm, fit_minibatch, gdi_parallel_init
    g = torch.Generator().manual_seed(11)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    out = {}
    for where in ("cpu", dev):
        cp, ap = gdi_parallel_init(x, 48, generator=torch.Generator()
                                   .manual_seed(1), device=where)
        rm = fit_minibatch(x, cp, generator=torch.Generator().manual_seed(2),
                           device=where)
        ra = fit_akm(x, cp, generator=torch.Generator().manual_seed(3),
                     m=30, max_iters=20, device=where)
        out[str(where)] = [v.cpu() for v in (cp, ap, rm.centers,
                                             rm.assignment, ra.centers,
                                             ra.assignment)]
    diff = [name for name, a, b in zip(
        ("gdi_parallel centers", "gdi_parallel assignment",
         "MiniBatch centers", "MiniBatch assignment", "AKM centers",
         "AKM assignment"), out["cpu"], out[str(dev)])
        if not torch.equal(a, b)]
    check(not diff, f"gdi_parallel_init, MiniBatch and AKM (n=3000, d=16, "
                    f"k=48) on the card equal the CPU's bit for bit "
                    f"(differing: {diff or 'none'})")


def _stream_phase(torch, dev, res, x, queries, check) -> dict:
    """Phase 2f: the streaming served model at the mnist shape. Builds it
    from phase 2's fit (capacity 2n, window 4 epochs, half-life 8, count
    floor 0.25, refresh every 4 batches, drift guard on) and streams the
    held-out rows through ``partial_fit`` in batches of BATCH, counts set
    to 0 before each batch; then the same in int8, ``predict(stream=)``
    cold and warm, a checkpoint round trip onto the card, and a small
    stream on the card against the CPU. Returns the launch counts of the
    f32 stream and the inputs of the eviction delta's kernel check."""
    import shutil
    from repro_torch.core import KMeansModel, OpCounter
    from repro_torch.ft.invariants import (resident_violations,
                                           streaming_violations)
    from repro_torch.kernels import _build
    from repro_torch.core import engine as eng

    kw = dict(kn=KN, capacity=2 * N, window=STREAM_WINDOW,
              half_life=STREAM_HALF_LIFE, count_floor=STREAM_FLOOR,
              refresh_every=STREAM_REFRESH, drift_guard=True, device=dev)
    batches = [queries[lo:lo + BATCH] for lo in range(0, NQ, BATCH)]
    evict_calls = []
    real_evict = eng.segment_sum_blocks

    def record(*args, **kwargs):
        if not evict_calls and kwargs.get("w") is not None:
            evict_calls.append((tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args),
                {k: v.clone() for k, v in kwargs.items()}))
        return real_evict(*args, **kwargs)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = KMeansModel.from_result(res, x, **kw)
    legs = {}
    for prec, kernel in (("f32", "candidate_assign_tiled"),
                         ("int8", "candidate_assign_int8_tiled")):
        m = model if prec == "f32" else KMeansModel.from_result(
            res, x, precision="int8", **kw)
        rows = []
        eng.segment_sum_blocks = record
        try:
            for b, xb in enumerate(batches):
                if prec == "int8":     # both paths on the pre-fold state
                    pre = [(m._predict_batch(xb, precision=p)[0],
                            *m.route_batch(xb, precision=p)[:2])
                           for p in ("int8", "f32")]
                counter = OpCounter()
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.perf_counter()
                a = m.partial_fit(xb, counter=counter)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                got = _build.launches()
                rows.append(dict(a=a, secs=secs, launches=got,
                                 resorted=counter.bytes_sorted > 0,
                                 evicted=counter.evicted_rows))
                if prec == "int8":
                    (a8, r8, u8), (a32, r32, u32) = pre
                    differ = a8 != a32
                    rows[-1].update(
                        own=bool(torch.equal(a, a8)),
                        differ=int(differ.sum()),
                        nearer=bool((r8[differ] != r32[differ]).all()
                                    and (u8[differ] <= u32[differ]).all()))
                lo = max(0, b - STREAM_WINDOW + 1)   # oldest live epoch
                want_live = (N if lo == 0 else 0) + BATCH * (b - lo + 1)
                vio = resident_violations(m.state, n=m.capacity,
                                          owned=m.w_pts > 0).tolist()
                svio = streaming_violations(
                    m.state, m.e_pts, m.w_pts, m.batches_seen - 1,
                    m.count_floor, window=m.window).tolist()
                refresh = m.batches_seen % m.refresh_every == 0
                check(vio == [0, 0, 0, 0] and svio == [0, 0, 0]
                      and m.live_rows() == want_live
                      and float(m.counts.min()) >= STREAM_FLOOR * (1 - 1e-6)
                      and got[kernel] > 0
                      and (got["center_sqdist"] > 0) == refresh
                      and (got["segment_sum_blocks"] > 0)
                      == (b >= STREAM_WINDOW),
                      f"stream {prec} batch {b}: invariants {vio}, stream "
                      f"{svio}, live rows {m.live_rows()} (window's "
                      f"{want_live}), least count {float(m.counts.min()):.4g}"
                      f" (floor {STREAM_FLOOR}), {kernel} {got[kernel]}, "
                      f"center_sqdist {got['center_sqdist']} (refresh "
                      f"{refresh}), segment_sum_blocks "
                      f"{got['segment_sum_blocks']}")
        finally:
            eng.segment_sum_blocks = real_evict
        legs[prec] = (m, rows)
    m32, rows32 = legs["f32"]
    m8, rows8 = legs["int8"]
    peak = torch.cuda.max_memory_allocated() - base
    # the int8 route re-ranks every survivor of the probed lists, while the
    # f32 route prunes with closure bounds built at the last refresh,
    # which go stale as folds move the centers (ROADMAP §3 entry 13): the
    # two paths agree on a fresh model and part only where the f32 route
    # pruned a nearer center
    differ = [r["differ"] for r in rows8]
    check(all(r["own"] and r["nearer"] for r in rows8) and differ[0] == 0,
          f"int8 stream: each fold assigns what the int8 path gives on its "
          f"state; the f32 path on the same state differs in {differ} rows "
          f"per batch (none on the fresh model), each routed by int8 to a "
          f"center at least as near as the f32 route's")
    n_differ = sum(int((r["a"] != q["a"]).sum())
                   for r, q in zip(rows32, rows8))
    print(f"  f32 and int8 streams: {n_differ} of {NQ} assignments differ "
          f"once the two trajectories part")
    want_ev = N + BATCH * (len(batches) - STREAM_WINDOW)
    check(m32.evicted_rows == m8.evicted_rows == want_ev,
          f"evicted rows {m32.evicted_rows}, {m8.evicted_rows} (training "
          f"rows and batches older than the window: {want_ev})")
    launches, launches_int8 = {}, {}
    for rows, tot in ((rows32, launches), (rows8, launches_int8)):
        for r in rows:
            for k, v in r["launches"].items():
                tot[k] = tot.get(k, 0) + v
    for prec, rows in (("f32", rows32), ("int8", rows8)):
        app = [r["secs"] for r in rows if not r["resorted"]]
        srt = [r["secs"] for r in rows if r["resorted"]]
        total = sum(r["secs"] for r in rows)
        print(f"  partial_fit {prec}: {total / len(rows) * 1e3:.3f} ms per "
              f"{BATCH}-row batch ({len(batches)} batches; append batches "
              + ", ".join(f"{s * 1e3:.3f}" for s in app) + " ms; re-sort "
              f"batches " + ", ".join(f"{s * 1e3:.3f}" for s in srt)
              + f" ms), {NQ / total:.1f} rows/s, evicted "
              f"{sum(r['evicted'] for r in rows):.0f} rows, re-sorts "
              f"{len(srt)}")
    print(f"  phase 2f launches (f32 stream, all batches): {launches}; "
          f"per batch: " + "; ".join(
              f"b{b} K1 {r['launches']['candidate_assign_tiled']} K2 "
              f"{r['launches']['center_sqdist']} K3 "
              f"{r['launches']['segmented_scan']} sums "
              f"{r['launches']['segment_sum_blocks']}"
              for b, r in enumerate(rows32)))
    print(f"  int8 stream launches per batch: K4 " + ", ".join(
        str(r["launches"]["candidate_assign_int8_tiled"]) for r in rows8))
    print(f"  peak device memory +{peak / 2 ** 20:.1f} MiB (both models)")
    del m8, legs, rows8

    # predict(stream=): cold, then warm on the same batch, and plain
    qb = batches[0]
    cold_c, warm_c = OpCounter(), OpCounter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_cold = m32.predict(qb, batch_size=BATCH, stream="s", counter=cold_c)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    a_warm = m32.predict(qb, batch_size=BATCH, stream="s", counter=warm_c)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a_plain = m32.predict(qb, batch_size=BATCH)
    # a row is warm when its bounds prove its center (u < lo): rows whose
    # two best candidates tie in f32 stay cold and pay the cold charge
    rec = m32._streams[("s", 0)]
    warm = rec["u"] < rec["lo"]
    n_warm = int(warm.sum())
    want_c = n_warm + int(m32._predict_batch(qb)[3][~warm].sum())
    print(f"  predict(stream=) on {BATCH} rows: cold {BATCH / (t1 - t0):.1f} "
          f"queries/s charging {cold_c.distances / BATCH:.3f} distances a "
          f"row, warm {BATCH / (t2 - t1):.1f} queries/s charging "
          f"{warm_c.distances / BATCH:.3f} ({n_warm} rows warm at 1 "
          f"distance, {BATCH - n_warm} with tied best two cold)")
    check(bool(torch.equal(a_cold, a_plain)) and bool(torch.equal(
        a_warm, a_plain)) and warm_c.distances == want_c
          and n_warm >= BATCH * 0.99,
          f"predict(stream=) cold and warm equal a cold predict "
          f"({int((a_warm != a_plain).sum())} warm rows differ); warm "
          f"charge {warm_c.distances:.0f} = 1 a warm row + the cold charge "
          f"of the {BATCH - n_warm} tied rows ({want_c})")

    # save, restore onto the card, and the next two batches on both
    ckpt = ROOT / "build" / "stream_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m32.save(str(ckpt), step=m32.batches_seen)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
        t0 = time.perf_counter()
        back = KMeansModel.restore(str(ckpt), device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  checkpoint: save {t_save:.3f} s, restore onto the card "
          f"{t_restore:.3f} s, {nbytes} bytes")
    reads = []
    for b, xb in enumerate(batches[:2]):
        a1 = m32.partial_fit(xb)
        holder = {}
        reads.append(_host_reads(torch, lambda: holder.setdefault(
            "a", back.partial_fit(xb))))
        a2 = holder["a"]
        same = (bool(torch.equal(a1, a2))
                and all(bool(torch.equal(getattr(m32.state, f),
                                         getattr(back.state, f)))
                        for f in ("sums", "counts", "c"))
                and bool(torch.equal(m32.e_pts, back.e_pts)))
        check(back.centers.device.type == "cuda" and same,
              f"restored model on the card and the original take batch "
              f"{len(batches) + b} alike: assignments, sums, counts, "
              f"centers and e_pts bit-identical ({same})")
    print(f"  host reads per partial_fit call: {reads}")
    if "--profile" in sys.argv[1:]:
        _profile(torch, "partial_fit (one 8192-row batch)",
                 lambda: m32.partial_fit(batches[2]))
    del back, m32
    _small_stream_agrees(torch, dev, check)
    return dict(launches=launches, launches_int8=launches_int8,
                evict=evict_calls[0] if evict_calls else None)


def _small_stream_agrees(torch, dev, check) -> None:
    """A small windowed stream with the drift guard on and drifting
    batches (tests/test_streaming.py's shape: n=256, d=8, k=8, capacity
    1024, window 6, half-life 8, floor 0.25; 40 batches of 32), so that
    centers are re-seated: the card against the plain CPU path, same
    assignments, repairs and evictions, and counts, sums and centers bit
    for bit. K3 must launch in the card's run (the splits)."""
    from repro_torch.core import KMeansModel, fit_k2means
    from repro_torch.kernels import _build
    g = torch.Generator().manual_seed(5)
    mus = torch.randn(8, 8, generator=g) * 8
    x = torch.round(mus[torch.randint(0, 8, (256,), generator=g)]
                    + torch.randn(256, 8, generator=g) * 2)
    ramp = torch.linspace(0.0, 30.0, 40)
    batches = [torch.round(torch.randn(32, 8, generator=g) * 4) + ramp[i]
               for i in range(40)]
    init = x[:8]
    a0 = torch.cdist(x, init).argmin(1).to(torch.int32)
    res = fit_k2means(x, init, a0, kn=4, max_iters=10, device="cpu")
    out = {}
    for where in ("cpu", dev):
        m = KMeansModel.from_result(res, x, kn=4, capacity=1024, window=6,
                                    half_life=8.0, count_floor=0.25,
                                    drift_guard=True, device=where)
        _build.reset_launches()
        a = [m.partial_fit(xb, on_full="degrade").cpu() for xb in batches]
        out[str(where)] = (a, m, _build.launches())
    (a_c, m_c, _), (a_g, m_g, got) = out["cpu"], out[str(dev)]
    same_a = all(bool(torch.equal(p, q)) for p, q in zip(a_c, a_g))
    same = all(bool(torch.equal(getattr(m_g.state, f).cpu(),
                                getattr(m_c.state, f)))
               for f in ("counts", "sums", "c"))
    check(same_a and same and m_c.repaired_centers > 0
          and m_g.repaired_centers == m_c.repaired_centers
          and m_g.evicted_rows == m_c.evicted_rows
          and got["segmented_scan"] > 0,
          f"small stream (n=256, d=8, k=8, 40 drifting batches) on the card "
          f"equals the plain CPU path: assignments {same_a}, counts, sums "
          f"and centers {same}, repaired centers {m_g.repaired_centers} vs "
          f"{m_c.repaired_centers}, evicted {m_g.evicted_rows} vs "
          f"{m_c.evicted_rows}, K3 launches {got['segmented_scan']}")


def _small_predict_agrees(torch, dev, fit_k2means, KMeansModel, OpCounter,
                          check) -> None:
    """A small served model through the kernels against the same model on
    the CPU's plain path: assignments, distances and counted charges in
    both precisions."""
    g = torch.Generator().manual_seed(11)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    q = mus[torch.randint(0, 16, (1000,), generator=g)] \
        + torch.randn(1000, 16, generator=g)
    init = x[torch.randperm(3000, generator=g)[:24]]
    a0 = torch.cdist(x, init).argmin(1).to(torch.int32)
    res = fit_k2means(x, init, a0, kn=8, max_iters=30, device="cpu")
    out = {}
    for where in ("cpu", dev):
        model = KMeansModel.from_result(res, x, kn=8, device=where)
        for prec in ("f32", "int8"):
            counter = OpCounter()
            a, d = model.predict(q, counter=counter, return_sqdist=True,
                                 batch_size=256, precision=prec)
            out[str(where), prec] = (a.cpu(), d.cpu(), counter.distances,
                                     counter.int8_ops, counter.bytes_scanned)
    for prec in ("f32", "int8"):
        cpu, gpu = out["cpu", prec], out[str(dev), prec]
        same = bool(torch.equal(cpu[0], gpu[0])) \
            and bool(torch.equal(cpu[1], gpu[1]))
        check(same and cpu[2:] == gpu[2:],
              f"small predict {prec} (n=1000, d=16, k=24) on the card equals "
              f"the plain CPU path: assignments and distances {same}, "
              f"charges {gpu[2:]} vs {cpu[2:]}")


# --- phase 2k: the mesh ---------------------------------------------------


def _mesh_x(torch, dev):
    """Phase 2's training rows, drawn again from the seed on ``dev``."""
    from repro_torch.data import gmm_blobs
    allx = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    return allx[:N].clone()


def _mesh_small(torch, mesh) -> dict:
    """Phase 2k (d) on one rank: entry 9's blobs, the sharded kernels fit
    fault-free and with rank 1 lost before iteration 5."""
    from repro_torch.core import OpCounter
    from repro_torch.core.distributed import fit_distributed_k2means
    from repro_torch.ft import FaultInjector
    xs, init = _entry9_blobs(torch)      # on the host, as a user's rows
    kw = dict(init_centers=init, max_iters=20, backend="kernels")
    base = fit_distributed_k2means(xs, 48, 8, mesh, **kw)
    cnt = OpCounter()
    with FaultInjector(seed=0, drop_host={5: 1}):
        drop = fit_distributed_k2means(xs, 48, 8, mesh, counter=cnt, **kw)
    return {"a": base.assignment.cpu().numpy(),
            "c": base.centers.cpu().numpy(), "energy": base.energy,
            "iterations": base.iterations,
            "drop_a": drop.assignment.cpu().numpy(),
            "drop_c": drop.centers.cpu().numpy(),
            "restores": cnt.repairs["restore"]}


def _mesh_rank_card(mesh, c0) -> dict:
    """Phase 2k on one of the gloo ranks sharing the card: (a)
    ``fit(mesh=, init="gdi")`` with the launches counted from 0, then the
    sharded fit from phase 2's GDI init centers ``c0``, (b) that fit
    again, its traffic per iteration and (rank 0) the host reads of a
    3-iteration fit; the card's memory a rank's fit takes; (d) the small
    fits. The rows are handed to the fits on the host, as a user's data
    larger than a card would be: each rank's card takes its shard."""
    import torch
    from repro_torch.core import fit
    from repro_torch.core.distributed import fit_distributed_k2means
    from repro_torch.kernels import _build
    dev = mesh.device
    x = _mesh_x(torch, dev)
    out = {"x_sum": float(x.double().sum())}
    x = x.cpu()
    c0 = torch.from_numpy(c0).to(dev)
    fit_distributed_k2means(x, K, KN, mesh, init_centers=c0, max_iters=2)
    torch.cuda.synchronize()
    _build.reset_launches()
    r = fit(x, K, mesh=mesh, init="gdi", kn=KN, max_iters=MAX_ITERS,
            profile=True, generator=torch.Generator(device=dev).manual_seed(
                SEED + 1))
    torch.cuda.synchronize()
    out["launches"] = _build.launches()
    out["gdi"] = {"init_s": r.profile["init_s"],
                  "iterate_s": r.profile["iterate_s"],
                  "iterations": r.iterations, "energy": r.energy,
                  "history": [e for _, e in r.history]}
    del r
    # the traffic of the iterations after the first: a whole fit's gathers
    # less a one-iteration fit's (the same set-up and final gather)
    g0, b0 = mesh.gathers, mesh.gathered_bytes
    fit_distributed_k2means(x, K, KN, mesh, init_centers=c0, max_iters=1)
    g_one, b_one = mesh.gathers - g0, mesh.gathered_bytes - b0
    runs = []
    for _ in range(2):
        g0, b0 = mesh.gathers, mesh.gathered_bytes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rr = fit_distributed_k2means(x, K, KN, mesh, init_centers=c0,
                                     max_iters=MAX_ITERS, profile=True)
        torch.cuda.synchronize()
        runs.append({"peak_bytes": torch.cuda.max_memory_allocated(dev)
                     - base,"a": rr.assignment.cpu().numpy(),
                     "c": rr.centers.cpu().numpy(), "energy": rr.energy,
                     "iterations": rr.iterations,
                     "iterate_s": rr.profile["iterate_s"],
                     "gathers": (mesh.gathers - g0 - g_one)
                     / max(rr.iterations - 1, 1),
                     "bytes": (mesh.gathered_bytes - b0 - b_one)
                     / max(rr.iterations - 1, 1)})
    out["runs"] = runs
    if mesh.index == 0:
        g0 = mesh.gathers
        out["dtoh"] = _host_reads(torch, lambda: fit_distributed_k2means(
            x, K, KN, mesh, init_centers=c0, max_iters=3))
        out["staged"] = mesh.gathers - g0
    else:
        fit_distributed_k2means(x, K, KN, mesh, init_centers=c0, max_iters=3)
    out["small"] = _mesh_small(torch, mesh)
    return out


def _mesh_rank_cpu(mesh) -> dict:
    """Phase 2k (d) on one of four gloo ranks on the CPU."""
    import torch
    return _mesh_small(torch, mesh)


def _mesh_rank_nccl(mesh, c0) -> dict:
    """Phase 2k (c): a one-rank NCCL mesh from phase 2's GDI init centers
    against the single-device fit from the same centers."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import assign_nearest, fit_k2means
    from repro_torch.core.distributed import fit_distributed_k2means
    dev = mesh.device
    x = _mesh_x(torch, dev)
    c0 = torch.from_numpy(c0).to(dev)
    r = fit_distributed_k2means(x, K, KN, mesh, init_centers=c0,
                                max_iters=MAX_ITERS)
    s = fit_k2means(x, c0, assign_nearest(x, c0), kn=KN,
                    max_iters=MAX_ITERS, device=dev)
    return {"backend": dist.get_backend(),
            "differ": int((r.assignment != s.assignment).sum()),
            "centers_equal": bool(torch.equal(r.centers, s.centers)),
            "energy": (r.energy, s.energy),
            "iterations": (r.iterations, s.iterations)}


def _mesh_phase(torch, dev, x, res, check) -> list:
    """Phase 2k: the sharded fit. (a) four gloo ranks sharing the card at
    the mnist shape (15,000 rows a shard): ``fit(mesh=, init="gdi")``,
    then the sharded kernels fit from phase 2's GDI init centers against
    phase 2's single-card fit; K1, K2 and K3 launched on every rank, the
    host read as often as one device's; (b) that fit twice, bit-identical;
    (c) a one-rank NCCL mesh equal to the single-device fit bit for bit;
    (d) at entry 9's small shape, four ranks on the card equal to four
    ranks on the CPU bit for bit, with a host lost before iteration 5
    keeping the fault-free result. Returns each rank's launches in (a)'s
    ``fit(mesh=)``."""
    import numpy as np
    from repro_torch.core import (OpCounter, assign_nearest, fit_k2means,
                                  initialize)
    from repro_torch.launch.mesh import run_local
    c0, _ = initialize(x, K, "gdi",
                       torch.Generator(device=dev).manual_seed(SEED + 1),
                       OpCounter())
    c0_h = c0.cpu().numpy()
    a0 = assign_nearest(x, c0)
    one_reads = _host_reads(torch, lambda: fit_k2means(
        x, c0, a0, kn=KN, max_iters=3, device=dev))
    # the single-card fit from the same start as the sharded one (phase
    # 2's starts from GDI's own assignment, not the nearest centers)
    # its memory: the rows it was given on the card, and its own peak
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    like = fit_k2means(x, c0, a0, kn=KN, max_iters=MAX_ITERS, device=dev)
    torch.cuda.synchronize()
    like_bytes = x.numel() * x.element_size() \
        + torch.cuda.max_memory_allocated(dev) - base
    card = run_local(_mesh_rank_card, MESH_RANKS, c0_h, device="cuda",
                     timeout=600)
    one = run_local(_mesh_rank_nccl, 1, c0_h, backend="nccl",
                    device="cuda", timeout=300)[0]
    cpu = run_local(_mesh_rank_cpu, MESH_RANKS, device="cpu", timeout=300)
    lead, g = card[0], card[0]["gdi"]
    print(f"phase 2k: (a) fit(mesh=) over {MESH_RANKS} gloo ranks sharing "
          f"the card ({N // MESH_RANKS} rows a shard), init='gdi' (the "
          f"sharded seed): seed {g['init_s']:.3f} s, {g['iterations']} "
          f"iterations, {g['iterate_s'] / max(g['iterations'], 1) * 1e3:.2f}"
          f" ms/iteration, energy {g['energy']:.6g} (phase 2's single-card "
          f"fit from its replicated GDI {res.energy:.6g}); launches per "
          f"rank {[r['launches'] for r in card]}")
    check(all(r["x_sum"] == float(x.double().sum()) for r in card),
          "every rank drew phase 2's rows again from the seed")
    for name in ("center_sqdist", "candidate_assign_tiled",
                 "segmented_scan", "segment_sum_blocks"):
        got = [r["launches"][name] for r in card]
        check(all(v > 0 for v in got),
              f"{name} launched on every rank by fit(mesh=) ({got})")
    hist = g["history"]
    check(all(map(_finite, hist)) and all(
        b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
        "the sharded fit's energy history finite and non-increasing")
    r1, r2 = lead["runs"]
    a1 = torch.from_numpy(r1["a"])
    differ = int((a1 != res.assignment.cpu()).sum())
    differ_like = int((a1 != like.assignment.cpu()).sum())
    ratio, ratio_like = r1["energy"] / res.energy, r1["energy"] / like.energy
    print(f"  from phase 2's GDI init centers: {r1['iterations']} "
          f"iterations (phase 2 {res.iterations}), "
          f"{r1['iterate_s'] / max(r1['iterations'], 1) * 1e3:.2f} "
          f"ms/iteration, energy ratio to phase 2's fit {ratio:.9f}, "
          f"{differ} of {N} assignments differ; against the single-card "
          f"fit from the same start ({like.iterations} iterations): ratio "
          f"{ratio_like:.9f}, {differ_like} differ; each rank sent "
          f"{r1['bytes']:.0f} bytes an iteration in {r1['gathers']:.2f} "
          f"gathers")
    peaks = [r["runs"][0]["peak_bytes"] for r in card]
    print(f"  the card's memory a fit takes (peak allocation above what was "
          f"there before, the rows included): each rank's sharded fit "
          f"{[round(b / 2**20, 3) for b in peaks]} MiB; the single-card "
          f"fit {like_bytes / 2**20:.3f} MiB ({x.numel() * 4 / 2**20:.3f} "
          f"MiB of it the rows)")
    check(max(peaks) < like_bytes / 2,
          f"each rank's sharded fit holds its shard, not every row: its "
          f"peak ({max(peaks)} bytes) under half the single-card fit's "
          f"({like_bytes} bytes)")
    check(abs(ratio_like - 1.0) <= 1e-4,
          f"the sharded fit's energy within rel 1e-4 of the single-card "
          f"fit's from the same start ({ratio_like:.9f})")
    check(all(np.array_equal(r["runs"][0]["a"], r1["a"])
              and np.array_equal(r["runs"][0]["c"], r1["c"])
              for r in card), "every rank returns the same result")
    reads = lead["dtoh"] - lead["staged"]
    print(f"  host reads of a 3-iteration sharded fit on rank 0: {reads} "
          f"({lead['dtoh']} device-to-host copies, {lead['staged']} of "
          f"them gloo's staging of the gathers); the single-card fit: "
          f"{one_reads}")
    check(reads == one_reads, f"the sharded fit reads the host as often "
                              f"as the single-card fit ({reads} vs "
                              f"{one_reads} for 3 iterations)")
    same = (np.array_equal(r1["a"], r2["a"])
            and np.array_equal(r1["c"], r2["c"])
            and r1["energy"] == r2["energy"]
            and r1["iterations"] == r2["iterations"])
    check(same, "(b) the sharded fit again is bit-identical")
    print(f"  (c) one-rank {one['backend']} mesh against the single-device "
          f"fit: {one['differ']} assignments differ, centers equal "
          f"{one['centers_equal']}, energy {one['energy']}, iterations "
          f"{one['iterations']}")
    check(one["backend"] == "nccl" and one["differ"] == 0
          and one["centers_equal"] and one["energy"][0] == one["energy"][1]
          and one["iterations"][0] == one["iterations"][1],
          "(c) the one-rank NCCL mesh equals the single-device fit bit for "
          "bit")
    small = [r["small"] for r in card] + cpu
    ref_small = cpu[0]
    same_small = all(
        np.array_equal(s["a"], ref_small["a"])
        and np.array_equal(s["c"], ref_small["c"])
        and np.array_equal(s["drop_a"], ref_small["a"])
        and np.array_equal(s["drop_c"], ref_small["c"])
        and s["restores"] == 1 for s in small)
    print(f"  (d) entry 9's blobs (n=3000, d=16, k=48) over four ranks: "
          f"{ref_small['iterations']} iterations, energy "
          f"{ref_small['energy']:.6g}; rank 1 lost before iteration 5")
    check(same_small, "(d) four ranks on the card equal four on the CPU bit"
                      " for bit, and the host drop keeps the fault-free "
                      "result (one restore)")
    return [r["launches"] for r in card]


# --- phases 2t and 2u: the LM's placement over gloo ranks sharing the card -

def _lmm_cfg(layers: int):
    """Qwen3-8B at full width, cut to ``layers`` of its 36 layers."""
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=layers)


class _AttnTap:
    """Wraps ``attention.cluster_major_decode_attention`` to keep each
    layer's output (on the host, f32) while ``on`` is set."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod = attention
        self.orig = attention.cluster_major_decode_attention
        self.outs, self.on = [], False

        def tap(*a, **kw):
            out = self.orig(*a, **kw)
            if self.on:
                self.outs.append(out.float().cpu())
            return out
        attention.cluster_major_decode_attention = tap

    def close(self):
        self.mod.cluster_major_decode_attention = self.orig


def _forced_decode(torch, cfg, params, cache, toks, mesh=None, tap=None):
    """The clustered decode teacher-forced over ``toks`` (each (B, 1), the
    first at slot LMM_PROMPT) from the cache as ``attach_clusters`` left
    it (the ring emptied first; the tables are read-only): each step's
    logits on the host, (steps, B, vocab) f32."""
    from repro_torch.models.model import serve_step
    st = cache["stack"]
    for f in ("ring_k", "ring_v", "ring_fill"):
        st[f].zero_()
    out = []
    for i, t in enumerate(toks):
        if tap is not None:
            tap.on = i == 0
        logits, cache = serve_step(cfg, params, cache, t, LMM_PROMPT + i,
                                   mesh=mesh)
        out.append(logits.float().cpu())
    if tap is not None:
        tap.on = False
    return torch.stack(out)


class _StackMesh:
    """Stands in for a mesh whose shards' partial states are ``parts``:
    ``gather`` returns them stacked, as ``Mesh.gather`` would."""

    def __init__(self, torch, parts):
        self.g = torch.stack([torch.cat([m[:, None], l[:, None], acc], 1)
                              for m, l, acc in parts])

    def gather(self, t):
        return self.g


def _quarters_partial(orig, torch, kc, P, q, kt, vt, sel, *, sizes):
    """K6 over one device's whole tables as P shards run it: the selected
    clusters of shard j alone (the others' ids -1) for each j, the states
    merged as ``attention._merge_shards`` merges the ranks'."""
    from repro_torch.models.attention import _merge_shards
    shard = (sel % kc) // (kc // P)
    parts = [orig(q, kt, vt, torch.where(shard == j, sel, -1).to(
        torch.int32), sizes=sizes) for j in range(P)]
    return _merge_shards(_StackMesh(torch, parts), *parts[0])


def _bf16_ulps(torch, a, b) -> float:
    """The largest |a - b| in bf16 ulps of max(|a|, |b|)."""
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def _lmm_rank(mesh, toks) -> dict:
    """Phase 2t on one of the gloo ranks sharing the card:
    ``serve.run(mesh=)`` (prefill, full decode, the clustering with this
    rank's clusters packed, the sharded clustered decode), then the
    clustered decode teacher-forced over ``toks`` twice with the launches,
    the bytes sent and (the first step) each layer's attention output
    recorded, and one step's host reads."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models.model import serve_step
    cfg, dev = _lmm_cfg(LMM_LAYERS), mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    r = serve.run(cfg, batch=LMM_BATCH, prompt_len=LMM_PROMPT,
                  decode_len=LMM_DECODE, device=dev, seed=SEED, mesh=mesh,
                  echo=lambda *a: None)
    out = {k: r[k] for k in ("t_prefill", "t_attach", "t_full", "t_clus",
                             "agreement", "sizes0")}
    out["run_launches"] = r["launches"]["cluster_attend"]
    params, cache = r["params"], r["cache"]
    out["kt_shape"] = tuple(cache["stack"]["kt"].shape)
    del r
    toks = [torch.from_numpy(t).to(dev)[:, None] for t in toks]
    tap = _AttnTap()
    _build.reset_launches()
    b0 = mesh.sent_bytes
    try:
        logits = _forced_decode(torch, cfg, params, cache, toks, mesh, tap)
    finally:
        tap.close()
    out["launches"] = _build.launches()["cluster_attend"]
    out["sent"] = (mesh.sent_bytes - b0) / len(toks)
    out["attn"] = [o.numpy() for o in tap.outs]
    again = _forced_decode(torch, cfg, params, cache, toks, mesh)
    out["same"] = bool(torch.equal(logits, again))
    out["logits"] = logits.numpy()
    del again
    g0 = mesh.gathers
    pos = LMM_PROMPT + len(toks)
    out["dtoh"] = _host_reads(torch, lambda: torch.argmax(serve_step(
        cfg, params, cache, toks[-1], pos, mesh=mesh)[0], -1).cpu())
    out["staged"] = mesh.gathers - g0
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


class _rank_alloc_env:
    """Spawned ranks sharing the card map their memory in growing segments
    (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``, which they
    inherit): four caching allocators side by side otherwise each hold
    gigabytes reserved but unused, and together run out of memory."""

    def __enter__(self):
        self.old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = self.old


def _lmm_one_device(torch, dev, check, ref, cluster_attend_partial,
                    cfg) -> dict:
    """Phase 2t's parent, before the ranks: one device's clustered decode
    (free-running, each step's logits and the first step's attention
    outputs kept on the host), the same decode teacher-forced with the
    merge reordered as the shards merge it, and K6 on a rank's local
    tables with its remote selections. Returns host data only, so every
    tensor it made on the card is freed when it returns (a small one left
    alive would pin its cached segment against ``empty_cache``)."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models.model import init_cache, init_params, serve_step
    B, S, n, P = LMM_BATCH, LMM_PROMPT, LMM_DECODE, MESH_RANKS
    H, Hkv, kc = cfg.n_heads, cfg.n_kv_heads, cfg.kv_clusters
    # one device's clustered decode, free-running
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    cache = init_cache(cfg, B, S + n + 1, clustered=False, device=dev)
    _, cache = serve.prefill_into_cache(cfg, params, cache, prompt)
    cache2 = serve.attach_clusters(cfg, cache, length=S)
    del cache
    tap = _AttnTap()
    toks, one = [prompt[:, -1:]], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(n):
            tap.on = i == 0
            lg, cache2 = serve_step(cfg, params, cache2, toks[-1], S + i)
            one.append(lg.float().cpu())
            toks.append(torch.argmax(lg, -1)[:, None].to(torch.int32))
    finally:
        tap.close()
    t_one = (time.perf_counter() - t0) / n
    one, one_attn, toks = torch.stack(one), tap.outs, toks[:n]
    one_reads = _host_reads(torch, lambda: torch.argmax(serve_step(
        cfg, params, cache2, toks[-1], S + n)[0], -1).cpu())
    # the merge reordered as the shards merge it, on one device
    orig = attention.cluster_attend_partial
    attention.cluster_attend_partial = functools.partial(
        _quarters_partial, orig, torch, kc, P)
    try:
        emul = _forced_decode(torch, cfg, params, cache2, toks)
    finally:
        attention.cluster_attend_partial = orig
    scale = one.abs().amax(dim=(1, 2))
    gap = ((emul - one).abs().amax(dim=(1, 2)) / scale).tolist()
    # K6 on a rank's inputs: shard 1's tables of layer 0, its selections
    # of the last step's query with the other shards' clusters at -1
    lm = {"cfg": cfg, "params": params, "cache": cache2, "prompt": prompt}
    qf, kt, vt, sel, sizes = k6_inputs(torch, lm)
    lo, kl = kc // P, kc // P
    loc = lambda t: t.reshape(B * Hkv, kc, *t.shape[1:])[:, lo:lo + kl] \
        .reshape(-1, *t.shape[1:]).contiguous()   # noqa: E731
    c = sel % kc - lo
    here = (c >= 0) & (c < kl)
    sel_l = torch.where(here, sel // kc * kl + c, -1).to(torch.int32)
    natural = int((~here).all(dim=1).sum())
    if not natural:
        sel_l[0] = -1
    entry = _k6_entry(torch, check, dict(lm, launches_all={
        "cluster_attend": 0}), cluster_attend_partial, ref,
        name="cluster_attend[2t shard]",
        inputs=(qf, loc(kt), loc(vt), sel_l, loc(sizes[:, None])[:, 0]))
    print(f"  K6 on shard 1's layer-0 tables ({B * Hkv * kl} blocks): "
          f"{natural} of {B * H} heads select no cluster the shard holds"
          + ("" if natural else "; head 0's selection set wholly remote"))
    return {"entry": entry, "logits": one, "attn": one_attn, "emul": emul,
            "scale": scale, "gap": gap, "reads": one_reads, "t_one": t_one,
            "toks": np.stack([t[:, 0].cpu().numpy() for t in toks])}


def _lm_mesh_phase(torch, dev, check, ref, cluster_attend_partial,
                   smi_line: str) -> dict:
    """Phase 2t: the sharded k²-attention decode. Qwen3-8B at full width
    cut to LMM_LAYERS layers, random weights from the seed, LMM_BATCH
    prompts of LMM_PROMPT tokens, the config's kc 2048 x cap 512 x top-p
    16; one device's clustered decode (the parent, before the ranks), the
    same decode with the merge reordered as the shards merge it (its gap
    to one device sets the tolerance), K6 on a rank's local tables with
    its remote selections; then MESH_RANKS gloo ranks sharing the card
    (``_lmm_rank``). Returns the K6 entry of the rank's inputs."""
    import numpy as np
    from repro_torch.launch.dryrun import decode_merge_bytes
    from repro_torch.launch.mesh import run_local
    cfg = _lmm_cfg(LMM_LAYERS)
    B, S, n, P = LMM_BATCH, LMM_PROMPT, LMM_DECODE, MESH_RANKS
    L, H, Hkv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kc, cap, R = cfg.kv_clusters, cfg.cluster_cap, cfg.cluster_ring
    n_par = L * (cfg.params_estimate() - cfg.vocab * cfg.d_model) \
        / cfg.n_layers + cfg.vocab * cfg.d_model
    tables = L * B * Hkv * kc * cap * dh * 2 * 2
    flat = L * B * Hkv * (S + n + 1) * dh * 2 * 2
    small = L * B * Hkv * (kc + 2 * R) * dh * 2
    unembed = cfg.vocab * cfg.d_model * 4
    print(f"phase 2t: {cfg.name} cut to {L} of 36 layers, {B} x {S}-token "
          f"prompts, kc {kc} x cap {cap} x top-p {cfg.cluster_top_p} over "
          f"{P} gloo ranks sharing the card, {n} tokens full then clustered,"
          f" no folds; reckoned a rank: params {n_par * 2 / 1e9:.2f} GB bf16 "
          f"+ the f32 unembedding {unembed / 1e9:.2f} GB, flat cache "
          f"{flat / 1e9:.3f} GB, its tables {tables / P / 1e9:.3f} GB (one "
          f"device's {tables / 1e9:.3f}), centroids and ring "
          f"{small / 1e9:.3f} GB")
    one = _lmm_one_device(torch, dev, check, ref, cluster_attend_partial,
                          cfg)
    torch.cuda.empty_cache()
    print(f"  the parent before the ranks: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved")
    entry, toks = one["entry"], one["toks"]
    t0 = time.perf_counter()
    with _rank_alloc_env():
        ranks = run_local(_lmm_rank, P, toks, device="cuda", timeout=900)
    t_ranks = time.perf_counter() - t0
    lead = ranks[0]
    entry["launches"] = lead["launches"]
    one_attn, scale, gap = one["attn"], one["scale"], one["gap"]
    one_reads, t_one = one["reads"], one["t_one"]
    emul, one = one["emul"], one["logits"]
    ulps = [max(_bf16_ulps(torch, torch.from_numpy(a), b)
                for a, b in zip(r["attn"], one_attn)) for r in ranks]
    errs = [[float(x) for x in (torch.from_numpy(r["logits"]) - one).abs()
             .amax(dim=(1, 2)) / scale] for r in ranks]
    tol = [max(2e-2, 1.5 * g) for g in gap]
    nxt = torch.from_numpy(toks[1:])
    agree = float((torch.from_numpy(lead["logits"][:-1]).argmax(-1)
                   == nxt).float().mean())
    same_emul = bool(np.array_equal(lead["logits"], emul.numpy()))
    want_bytes = decode_merge_bytes(cfg, B, P)
    print(f"  one device: {t_one * 1e3:.1f} ms a clustered token (logits "
          f"read each step); the ranks: {t_ranks:.1f} s in all; rank 0 "
          f"prefill {lead['t_prefill']:.3f} s, attach {lead['t_attach']:.3f}"
          f" s (tables {lead['kt_shape']}), {n} tokens full "
          f"{lead['t_full']:.2f} s, clustered {lead['t_clus']:.2f} s "
          f"({P} ranks on one card), serve.run's token agreement "
          f"{lead['agreement']:.4f}, member rows {lead['sizes0']} "
          f"[{smi_line}]")
    print(f"  peak device memory a rank "
          f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB; K6 launches "
          f"a rank in the forced decode {[r['launches'] for r in ranks]} "
          f"({L} layers x {n} tokens), in serve.run's "
          f"{[r['run_launches'] for r in ranks]}; bytes sent a token "
          f"{[r['sent'] for r in ranks]} (the dry run's {want_bytes})")
    print(f"  the first step's attention outputs against one device: "
          f"{ulps} bf16 ulps at most (rank by rank); logits' error over "
          f"their largest, the worst step of each rank "
          f"{[max(e) for e in errs]}; the reordered merge's gap on one "
          f"device {min(gap):.3g}..{max(gap):.3g} (tolerance "
          f"max(2e-2, 1.5 x gap)); rank 0 = the reordered merge bit for "
          f"bit: {same_emul}; free-running agreement (the ranks' argmax "
          f"against one device's next token) {agree:.4f}")
    reads = [r["dtoh"] - r["staged"] for r in ranks]
    print(f"  host reads a step: one device {one_reads}, the ranks "
          f"{reads} (less gloo's {lead['staged']} staging copies)")
    check(all(u <= 1.0 for u in ulps),
          f"2t: each layer's attention output at the first step equal to "
          f"one device's or within one bf16 ulp ({max(ulps)})")
    check(all(e <= t for es in errs for e, t in zip(es, tol)),
          "2t: every step's logits within max(2e-2, 1.5 x the reordered "
          "merge's gap) of their largest, on every rank")
    check(all(r["launches"] == L * n and r["run_launches"] == L * n
              for r in ranks), f"2t: K6 once a layer a token on each rank "
                               f"({L * n})")
    check(all(x == one_reads for x in reads),
          f"2t: host reads a step as one device's ({one_reads}), gloo's "
          f"staging apart")
    check(all(r["sent"] == want_bytes for r in ranks),
          f"2t: the merge's bytes a rank a token equal the dry run's "
          f"({want_bytes})")
    check(all(r["same"] for r in ranks) and all(
        np.array_equal(r["logits"], lead["logits"]) for r in ranks),
        "2t: two runs bit-identical, every rank the same logits")
    return entry


def _zero_rank(mesh, ref_path: str) -> dict:
    """Phase 2u on one of the gloo ranks sharing the card: ZERO_STEPS
    ZeRO-1 steps from the seed's init (the bytes sent, the step times),
    the first step again from the init (bit-identical to the first run's),
    then one compressed step; rank 0 holds its params after ZERO_STEPS
    against the parent's one-device and reordered runs saved at
    ``ref_path``."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim import tree_leaves
    cfg, dev = _lmm_cfg(ZERO_LAYERS), mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    batcher = train.batcher_for(cfg, MESH_RANKS, ZERO_SEQ, seed=SEED,
                                mesh=mesh)
    step = train.MetricsStep(train.make_train_step(
        cfg, remat="dots", q_chunk=512, mesh=mesh))
    out, first = {"runs": []}, None
    for run, n in enumerate((ZERO_STEPS, 1)):
        state = train.init_state(cfg, seed=SEED, device=dev, mesh=mesh)
        sent, times = [], []
        for s in range(n):
            b0, t0 = mesh.sent_bytes, time.perf_counter()
            state = step(state, batcher.batch_at(s))
            times.append(time.perf_counter() - t0)
            sent.append(mesh.sent_bytes - b0)
            if s == 0 and run == 0:
                first = [t.clone() for t in tree_leaves(state[0])]
        out["runs"].append({"hist": list(step.history[-n:]),
                            "sent": sent, "times": times})
        if run == 0:
            final = list(tree_leaves(state[0]))
            out["sums"] = [float(t.double().sum()) for t in final]
            if mesh.index == 0:
                want = torch.load(ref_path)
                rel = lambda a, b: float(  # noqa: E731
                    (a.float() - b.to(a.device).float()).abs().max()
                    / b.float().abs().max())
                out["err_one"] = max(rel(a, b) for a, b in zip(
                    final, want["one"]))
                out["err_emul"] = max(rel(a, b) for a, b in zip(
                    final, want["emul"]))
                del want
            del final, state
    out["same"] = all(bool(torch.equal(a, b))
                      for a, b in zip(first, tree_leaves(state[0])))
    del first
    cstep = train.make_train_step(cfg, remat="dots", q_chunk=512,
                                  compress=True, mesh=mesh)
    state, m = cstep(state, batcher.batch_at(ZERO_STEPS))
    out["compressed"] = torch.stack([m["loss"], m["grad_norm"]]).tolist()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def _zero_phase(torch, dev, check, smi_line: str) -> None:
    """Phase 2u: ZeRO-1 training of Qwen3-8B at full width cut to
    ZERO_LAYERS layers, MESH_RANKS gloo ranks sharing the card, 1 x
    ZERO_SEQ tokens a rank, remat "dots". The parent first runs one
    device's steps over the shards' batches concatenated in shard order,
    and the same steps with the batch's gradient taken as MESH_RANKS
    shard gradients added in shard order (the sharded step's reordering,
    whose gap to one device sets the tolerance), saves both runs' params
    for rank 0 and frees them."""
    import math
    from repro_torch.data import ShardedBatcher
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import zero_step_bytes
    from repro_torch.launch.mesh import run_local
    from repro_torch.optim import (adamw_update, clip_by_global_norm,
                                   tree_leaves, tree_map)
    cfg, P = _lmm_cfg(ZERO_LAYERS), MESH_RANKS
    shards = [ShardedBatcher(P, ZERO_SEQ, cfg.vocab, num_shards=P,
                             shard_id=s, seed=SEED) for s in range(P)]
    batches = [[b.batch_at(s) for b in shards] for s in range(ZERO_STEPS)]
    step = train.make_train_step(cfg, remat="dots", q_chunk=512)
    state = train.init_state(cfg, seed=SEED, device=dev)
    one_loss = []
    for parts in batches:
        batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, batch)
        one_loss.append(float(m["loss"]))
    one = [t.cpu() for t in tree_leaves(state[0])]
    del state
    state = train.init_state(cfg, seed=SEED, device=dev)
    emul_loss = []
    for parts in batches:
        acc, loss = None, None
        for p in parts:
            met, g = train.loss_and_grads(cfg, state[0], p, remat="dots")
            acc = g if acc is None else tree_map(lambda a, b: a + b, acc, g)
            met = met["loss"].detach()
            loss = met if loss is None else loss + met
            del g
        acc = tree_map(lambda a: a / P, acc)
        acc, _ = clip_by_global_norm(acc)
        with torch.no_grad():
            state = adamw_update(acc, state[1], state[0])
        del acc
        emul_loss.append(float(loss / P))
    emul = [t.cpu() for t in tree_leaves(state[0])]
    del state
    torch.cuda.empty_cache()
    gap = max(float((a.float() - b.float()).abs().max() / b.float().abs()
                    .max()) for a, b in zip(emul, one))
    gap_loss = max(abs(a - b) / abs(b) for a, b in zip(emul_loss, one_loss))
    path = ROOT / "build" / "zero_ref.pt"
    torch.save({"one": one, "emul": emul}, path)
    del one, emul
    want_bytes = zero_step_bytes(cfg, P)
    print(f"  the parent before the ranks: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved")
    t0 = time.perf_counter()
    try:
        with _rank_alloc_env():
            ranks = run_local(_zero_rank, P, str(path), device="cuda",
                              timeout=900)
    finally:
        path.unlink(missing_ok=True)
    t_ranks = time.perf_counter() - t0
    lead = ranks[0]
    hist = lead["runs"][0]["hist"]
    steady = [t for r in ranks for t in r["runs"][0]["times"][1:]]
    ms = sum(steady) / len(steady) * 1e3
    print(f"phase 2u: {cfg.name} cut to {ZERO_LAYERS} of 36 layers trained "
          f"under ZeRO-1 over {P} gloo ranks sharing the card, 1 x "
          f"{ZERO_SEQ} tokens a rank, remat 'dots', {ZERO_STEPS} steps, the "
          f"first again and one compressed; the ranks {t_ranks:.1f} s in "
          f"all; "
          f"{ms:.1f} ms a step (steps 1.., host clock, {P} ranks on one "
          f"card), {P * ZERO_SEQ / ms * 1e3:.0f} tokens/s [{smi_line}]")
    print(f"  losses one device {one_loss}, reordered {emul_loss}, ranks "
          f"{[h['loss'] for h in hist]}; gradient norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; params' error over "
          f"each leaf's largest: rank 0 against one device "
          f"{lead['err_one']:.3g}, against the reordered run "
          f"{lead['err_emul']:.3g}, the reordered run's gap {gap:.3g} (loss "
          f"gap {gap_loss:.3g}); tolerance 1.5 x the gap")
    print(f"  bytes a rank a step {[r['runs'][0]['sent'] for r in ranks]} "
          f"(the dry run's {want_bytes}); peak device memory a rank "
          f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB; the "
          f"compressed step's loss and norm {lead['compressed']}")
    check(lead["err_one"] <= 1.5 * gap and all(
        abs(h["loss"] - w) <= max(1.5 * gap_loss, 2 ** -22) * abs(w)
        for h, w in zip(hist, one_loss)),
        f"2u: losses and params within 1.5 x the reordered run's gap of one "
        f"device's on the concatenated batch (params {lead['err_one']:.3g} "
        f"<= 1.5 x {gap:.3g}; losses within max(1.5 x {gap_loss:.3g}, "
        f"2^-22) relative)")
    check(all(s == want_bytes for r in ranks for rr in r["runs"]
              for s in rr["sent"]),
          f"2u: the bytes a rank sends a step equal the dry run's "
          f"({want_bytes})")
    check(all(r["same"] and r["runs"][0]["hist"][:1] == r["runs"][1]["hist"]
              and r["sums"] == lead["sums"] for r in ranks),
          "2u: the first step run again bit-identical, every rank the same "
          "params")
    check(all(math.isfinite(v) for r in ranks for v in r["compressed"]),
          "2u: the compressed step's loss and gradient norm finite")


if __name__ == "__main__":
    sys.exit(main())
