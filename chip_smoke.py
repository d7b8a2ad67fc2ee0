#!/usr/bin/env python3
"""Drive the PyTorch port of the FACADE reproduction on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on the path itself and
imports only ``repro_torch``, torch and numpy. Phases, in order (any
failure raises and exits non-zero, before the last line is printed):

1. the card: ``nvidia-smi`` name and power limit;
2. kernels: build every CUDA source of the port with ``nvcc`` (all started
   together), then hold each kernel against its plain PyTorch version on
   the card and time kernel, plain version and library yardstick with CUDA
   graphs (each graph and its memory released after its timing, which
   must leave the device memory as it found it), beside the kernel's
   bound:
   - head select at the reference kernel tests' shapes (fp32 and bf16,
     ~10% of labels excluded; in bf16 they take the tensor-core body, in
     fp32 the fp32 tiled body) and
     at the FACADE path's shape in fp32 and in bf16 (the FMA body; D 513),
     tolerance 2e-5 relative and equal argmins, timed at the FACADE path's
     shape and at ``HS_SHAPES[2]``;
     and at the FACADE path's shape on non-finite inputs, as an unguarded
     faulty round gives them (a token of NaN features, a head of NaN
     weights, a +inf bias weight, a head of +inf weights): NaN and +inf
     at the plain version's places, the finite losses within 2e-5 and
     equal argmins (a row's first NaN), and its tensor-core body the same
     way at an LM-regime shape (``HS_LM_NON_FINITE``, bf16);
     yardstick: a matmul and ``cross_entropy``; beside it the launch
     floor, one tiny in-place PyTorch op timed the same way. Then its
     tensor-core body (the LM regime, two device launches a call) at the
     LM FACADE paths' shapes (n·K 4, T 1024, D 2048, V 128,256 for
     llama3.2-1b and V 65,536 for rwkv6-1.6b, bf16) and two ragged ones
     (T 1000 with V 1000, T 200 with V 65,536), a node with every label
     excluded giving 0.0, the same tolerance, identical heads giving
     identical losses; timed at both paths' shapes (at llama's, its two
     launches, the tile kernel and the merge, also apart by
     ``torch.profiler`` after the last phase), with the tile kernel's
     registers and spills from the build log; yardstick: per (node, head)
     a bf16 matmul and ``cross_entropy`` on fp32 logits;
   - head select's wider paths (``head_select_wide_phase``): the wrapper's
     dispatch rule (``ops.body_for``) against the source's ``hs_body`` on
     every shape the script and the archs give K1; both fp32 bodies, the
     SIMT one and the tensor cores' (3xTF32), forced at ``HS_SHAPES``, V
     128 (``HS_F32_EDGE``), a four-card FACADE rank's step 2c
     (``HS_F32_CHECK``: n·K 2, T 512, D 2048, V 128,256) and
     ``HS_F32_TIMED``, and the tensor-core body on a ragged V at
     hymba-1.5b's and whisper-tiny's vocabularies (``HS_PADDED``), each
     with a node of excluded labels giving 0.0 and identical heads
     identical losses, the fp32 tensor cores also against a float64
     witness (within ``HS_TC32_FACTOR`` times the plain fp32 version's
     distance, or ``HS_TC32_FLOOR``) and the same bits twice; all three
     on non-finite inputs (the fp32 tensor cores there with the same
     gates, ``hs_tc32_non_finite_check``); then timed beside bound, plain
     version and library call: the two fp32 bodies in turns and the FMA
     body at ``HS_SHAPES`` and V 128, the two fp32 bodies in turns around
     the rule's D 192 and at the smoke LM step 2c (``HS_TC32_SWEEP``; the
     thresholds' readings), and beside both bounds (the fp32 pipes' and
     three TF32 products') at T 512, 2048 and the fp32 llama round's n·K
     4, T 1024 (``HS_F32_TIMED``), the padded calls with the heads' copy
     timed apart (``hs_pad_rows``);
   - flash attention at the reference tests' ``FA_SHAPES``, a ragged
     S = 200, llama3.2-1b's serving shape (B 4, S 512, Hq 32, Hkv 8, D 64)
     and a long one (B 1, S 4096), each in fp32 and bf16, the LM FACADE
     feature pass's shape in bf16 (B 4, S 256, from the config and
     ``LM_FACADE``), windows 32 and
     128 in both, and the bf16 tensor-core kernel's own paths
     (``FA_BF16_CASES``: D 32 and 128, ``causal=False``, ragged S against
     its 64-row tiles, large scores); stablelm-12b's serving shape
     (``FA_D160``: D 160) in both dtypes, and D 160 non-causal at a ragged
     S in bf16; MLA at minicpm3-4b's width
     (``FA_MLA``: B 4, H 40, S 512, q.k 96 and v 64) through
     ``attention.mla_attention`` (zero-padded to D 128, the output sliced
     back), in both dtypes against the plain ``sdpa`` on the unpadded
     tensors in fp32, with the same gates. fp32 output is held against the
     plain version at 2e-6 (absolute plus relative); bf16 output against
     the plain version run in fp32 on the same bf16 values, within one
     bf16 ulp of the answer (relative 2^-8, plus 1e-6), since the kernel
     keeps fp32 scores and statistics, carries P V as three bf16 terms of P
     and rounds once; timed at the serving shape, the long one and
     stablelm-12b's, and after the last phase at the LM feature pass's;
     the hybrid, audio and VLM families' full-width shapes
     (``FA_FAMILIES``: hymba-1.5b at B 4, S 2048, Hq 25, Hkv 5, D 64 with
     its window of 1024; whisper-tiny's encoder at S 1500, Hq = Hkv 6, D
     64, non-causal; llava-next-34b's image prefix and prompt at S 3392,
     Hq 56, Hkv 8, D 128), each in both dtypes with the same gates and
     timed beside its bound and SDPA (with a boolean window mask at
     hymba's shape);
     MLA's call timed with its pads, the kernel alone on padded tensors,
     the plain ``sdpa`` and SDPA on the unpadded tensors, its bound from the
     unpadded work; yardstick: ``scaled_dot_product_attention`` (causal,
     GQA; for MLA with its v head dim of 64);
   - wkv at the reference tests' ``RW_SHAPES``, a ragged S = 100, the
     kernel's own paths (``RW_CASES``: S 1, 31 and 33 around its 16-step
     chunks, strong and weak decay, B * H = 264 blocks), the RWKV FACADE
     round's shape (B 4, S 256, H 32, hd 64) and rwkv6-1.6b's serving
     shape (B 4, S 512), tolerance 1e-5 on y and on the final state; no
     single PyTorch call computes it; timed at both shapes;
   - wkv's backward kernel (``wkv_backward``, ``wkv_backward_phase``) at
     ``RW_BWD_CASES`` (the round's shape, S 1, S 33 at hd 64 and 32,
     ragged last chunks at S 100, w near 0 and near 1), with y's gradient
     alone and with the final state's: dr, dk, dv, dw and du against a
     float64 witness (the plain loop in float64 on the same inputs),
     each within ``RW_BWD_FACTOR`` times the plain fp32 loop's own
     distance from it (or ``RW_BWD_FLOOR``) and within 1e-5, relative to
     the leaf's largest |gradient|, the same bits twice, and the kernel's
     order in plain PyTorch (``wkv_backward_scan``) within 1e-5 too;
     timed at the round's shape beside its bound and the plain version
     (autograd through ``wkv_scan``), and one ``wkv_train`` backward as
     training runs it (events and host clock); no single PyTorch call
     computes it;
3. the FACADE path: ``run_experiment`` for FACADE and the baselines EL,
   D-PSGD, DEPRL and DAC at paper scale (full-width GN-LeNet, 32 nodes in
   clusters 24:8, degree 4, H = 10, B = 8) on its default driver, the
   segment engine (each round a replay of one captured CUDA graph, K1
   inside FACADE's); checks finite parameters, one head-select launch
   per FACADE round and per eager warm-up call before its capture
   (``FACADE_LAUNCHES``), none elsewhere, and each algorithm's bytes per
   round against its formula;
3a. the engine (``engine_phase``, same data): for the five algorithms the
   engine against the per-round loop bit for bit (every parameter leaf and
   history; FACADE with 2 warmup rounds, so both of its graphs), the loop
   against itself; the steady state, 40 rounds with an eval every 20
   through one ``EngineCache``, the second run (seed 1) timed for both
   drivers (rounds per second, peak allocated and reserved memory), the
   capture seconds a graph, a ``compile_count`` that stays flat and the
   run length from which the captures have paid for themselves;
   after the last phase (``engine_profile_phase``), a ``torch.profiler``
   run of one replayed 20-round FACADE segment (device-busy share,
   largest kernels) that must hold 20 K1 executions by kernel name and
   by counter;
3a'. the engine's drivers (same data, 40 rounds with an eval every 10,
   FACADE's first 2 rounds in its warmup phase, so both of its graphs):
   - ``pipeline_phase``: for the five algorithms ``pipeline=True``
     against ``pipeline=False`` bit for bit (every parameter leaf, the
     histories, the cluster ids, the bytes) on seeds 0 and 1 through one
     ``EngineCache``, seed 1 timed for both drivers (rounds per second);
     each pipelined run must have overlapped at least one segment (the
     next segment's end event still pending when a segment's host work
     ended); K1 once a replayed round; then a ``target_acc`` exit on
     FACADE (reached at round 10) on both drivers, the same run, K1 10
     serialized and 20 pipelined (the segment dispatched past the hit
     ran);
   - ``resume_phase``: FACADE and DAC pipelined with a checkpoint under
     ``build/``, killed at the third segment dispatch and resumed by the
     same call through a fresh cache, against an uninterrupted
     serialized run: the same run bit for bit, equal final checkpoints,
     another seed refused; K1 the replayed rounds plus one warm-up call
     a captured round;
   - ``sweep_phase``: ``run_sweep`` of cells FACADE and EL over seeds 0,
     1 and 2 with a ``ckpt_dir`` under ``build/``: ``compile_count``
     flat after each cell's first seed, each seed's run a fresh
     ``run_experiment`` call's bit for bit, a rerun that skips both cells
     (no run; its wall time), rounds per second on the warm seeds;
3a''. network simulation (``netsim_phase``, same data, 8 rounds with an
   eval every 4): the five algorithms under ``edge-v2`` (bursty links,
   core/edge tiers, async stale gossip) and ``edge-churn``, FACADE and EL
   under ``bursty-wan``, ``core-edge``, ``async-edge`` and ``hostile``,
   each on the engine (the netsim round inside the captured graph, K1 one
   a replayed round plus one warm-up call) against the loop bit for bit,
   simulated seconds included, each run's bytes recounted on the host
   (whole delivering edges times the payload, at most n·degree of them,
   DAC's symmetrised graph twice that) and its seconds finite, not
   negative and positive in total; ``ideal`` against ``net=None`` (the
   same trajectory) for FACADE and EL; ``edge-churn`` with async gossip
   at ``max_staleness=0`` against the synchronous run, bit for bit, for
   the five; FACADE's steady engine rate (20 rounds, seed 1 of one cache)
   under ``net=None`` and each of the nine presets, with capture seconds
   and peak memory;
3a'''. node faults (``faults_phase``, same data and schedule, under
   ``edge-v2``): the five algorithms under the reference's example faults
   (crash 0.05, restart 0.5, NaN corruption 0.05, the guard on), FACADE
   and DAC under ``reset`` restarts (crash 0.4, restart 0.6), FACADE under
   noise corruption (crash 0.3, restart 0.5, corruption 0.3): the engine
   (K1 one a replayed round plus one warm-up call) against the loop bit
   for bit, bytes recounted, parameters finite; ``FaultConfig()`` and
   ``FaultConfig(robust=False)`` against the fault-free run for FACADE and
   EL; a NaN storm (corruption 0.1) on FACADE, the guarded run finite and
   the unguarded one recorded; a ``reset`` FACADE run (4 segments) killed
   at its third segment dispatch and resumed, against the uninterrupted
   one; FACADE's steady rate (20 rounds) under no faults, the example's
   and the noise faults, with capture seconds, peak memory and the host
   seconds of a round's network and fault draws;
3a''''. the adaptive topology policy (``topo_phase``, same data and
   schedule; ``TopoConfig(policy, decay=0.7, min_inclusion=0.25,
   ref_payload_bytes=5e4)``, the reference benchmark's): the five
   algorithms under ``reliability`` and ``core-edge``, FACADE and EL under
   ``bandwidth`` on ``core-edge`` and ``reliability`` on ``bursty-wan``
   and ``edge-v2`` and without ``net``: the engine (the policy's sampler
   inside the captured round, its EWMAs in static buffers; K1 one a
   replayed round plus one warm-up call) against the loop bit for bit,
   bytes recounted on the host, parameters finite; ``TopoConfig()``
   against ``topo=None`` for the five; the fairness floor on the card
   (``inclusion_stats`` on ``core-edge``, 32 nodes, degree 4, 400 rounds:
   every node's inclusion and participation at least 0.25 less three
   standard errors); a FACADE run (4 segments) killed at its third
   segment dispatch and resumed, against the uninterrupted one; FACADE's
   steady rate (20 rounds) under a comm-bound ``core-edge``
   (``compute_s_per_step=0.002``) with no policy, ``reliability`` and
   ``bandwidth``, with capture seconds, peak memory, simulated seconds
   and bytes;
3a'''''. run telemetry (``obs_phase``, same data and schedule): the five
   algorithms under ``core-edge`` with ``Obs(ObsConfig(), jsonl=...,
   out_dir=...)`` under ``build/obs``: the observed engine (the frame
   computed inside the captured round; K1 one a replayed round plus one
   warm-up call) against the unobserved run and the observed loop, the
   same run and the same frames bit for bit, each round's
   ``delivered_edges`` times the payload against its drained bytes and
   the tier split against them within 1e-6, ``stale_hist`` summing to
   n, verdicts ``ok``, the manifest and JSONL on disk; FACADE under
   ``edge-v2`` (stale nodes in the histogram); an unguarded NaN storm on
   FACADE judged ``fail`` (``nonfinite``) and its report rendered;
   FACADE's steady rate observed and unobserved (20 rounds, seed 1 of
   one cache each, OBS_RATE_REPS runs in turns, medians and quartiles),
   peak memory and capture seconds;
3a. the node mesh (``mesh_phase``, same data and schedule) on the
   driver's one card: ``mesh=(1,)`` (a one-rank NCCL group that
   ``run_experiment`` starts itself; each round captured with its
   all-gather of the sent tree inside) against ``mesh=None`` for the five
   algorithms, without a medium and under ``edge-v2`` with the
   reference's NaN-corrupting faults (``MESH_FAULTS``) and
   ``Obs(ObsConfig())``: the same run and the same frames bit for bit,
   K1 one a replayed FACADE round plus its warm-up call; FACADE's steady
   rate with ``mesh=(1,)`` and with ``mesh=None`` (20 rounds, seed 1 of
   one cache each, ``MESH_RATE_REPS`` runs in turns); the process group
   destroyed at the end; the phase's seconds. The four-card run is
   ``tools/mesh_run.py`` under ``torchrun``;
3b. the launcher's paper mode (``launch.train.paper_main``) on full-width
   ResNet8 (64×64 images, 41 classes; ``RESNET8_PAPER``: 32 nodes in
   clusters 24:8, degree 4, H = 10, B = 8, 8 rounds) for the five
   algorithms on the engine, the data made once for the five
   (``one_dataset``): ``FACADE_LAUNCHES`` head-select launches in
   FACADE's run and none elsewhere,
   bytes per round exactly ``RESNET8_BYTES``, finite parameters,
   accuracies in [0, 1], rounds per second with set-up; after each run
   the per-round loop on the same run, which the engine's must equal bit
   for bit, timed, and the run length from which the capture has paid
   for itself; then head select
   on the operands step 2c of such a round builds (``HS_RESNET8``: one
   stream per (node, head), n·K 64, T 8, D 65, V 41, fp32) against its
   plain version (2e-5 relative, equal argmins) and the round's own
   selection losses, timed beside its bound, the library call and the
   launch floor;
3c. a small FACADE/EL input on GN-LeNet and on ResNet8, on the card and on
   the CPU from the same seed, which must agree;
4. FACADE on llama3.2-1b at full width (bf16, heads untied): 2 nodes in
   clusters 1:1, k 2, degree 1, H 2, B 4, S 256, lr 5e-3, head jitter
   1e-3, clustered token streams, 3 rounds driven through
   ``runner.LMFacade`` (``facade_round``), then one more under
   ``torch.profiler`` (the device's activity; hymba-1.5b one round, the
   profiled one); before round 1, K1 against
   its plain version on the
   operands the LM binding builds for that round (2e-5 relative, equal
   argmins, and equal to the round's own selection losses); checks one
   head-select call and 16 flash-attention launches per node a round (all
   from step 2c's no-grad feature pass: training attention is the plain
   differentiable ``sdpa``), no wkv launch, round-1 selection losses in
   [11, 13], the bytes per round from the config alone and finite
   parameters; prints the round times and peak memory;
4a'. hymba-1.5b the same way in bf16 (one round, run under the
   profiler): step 2c on the tensor cores through
   the padded copy of its V 32,001, K2 with its window in all 64
   feature-pass layers, selection losses in [9.8, 11.8], the bytes from
   the config (the mamba branch's fp32 leaves at 4 bytes); and one
   llama3.2-1b round with the config in fp32 (step 2c at n·K 4, T 1024 on
   the fp32 tensor-core body), then profiled; in every LM profile K1's
   kernels by name (``lm_k1_by_name``: its body's tile kernel, the merge,
   the features' split and the copies once each, no other body's);
4a. the same on rwkv6-1.6b at full width (3 rounds and one profiled):
   one head-select call, 144 wkv launches a round (24 a node in step
   2c's feature pass and 24 a node in each local step's forward, through
   ``wkv_train``) and 96 of its backward kernel (24 a node and local
   step), by counter and, in the profiled round, by kernel name; no
   flash attention, round-1 selection losses in [10.5, 12.5], the bytes
   per round from the config (RWKV's fp32 leaves at 4 bytes); the
   profiled round also gives the host time in ``wkv_train``'s 96
   backward calls (a host clock around ``WkvFunction.backward``,
   ``host_seconds_in``);
4b. the smoke LM FACADE rounds (fp32) of ``SMOKE_LM_ARCHS`` (llama3.2-1b,
   rwkv6-1.6b, minicpm3-4b's MLA, deepseek-moe-16b's MoE and hymba-1.5b's
   hybrid, K1 on their feature passes) on the card and on the CPU from the same draws:
   selection losses and parameters within 1e-4, cluster ids and bytes
   equal;
4c. the launcher's lm mode (``launch.train.main``) on both LM smoke configs
   (``LM_MODE``: 20 AdamW steps) with ``--ckpt`` in a temporary directory
   under ``build/``: finite losses, the checkpoint loads back bit-equal to
   the final parameters, one wkv launch and one of its backward per layer
   and step for RWKV and no other kernel launch;
5. the serving path: ``serve`` for llama3.2-1b and then rwkv6-1.6b at full
   width (bf16, parameters from the port's init on the card), 8 requests
   in batches of 4, prompt length 512, 32 generated tokens, greedy, seed
   0, after an untimed warm-up; checks one flash-attention (llama) or wkv
   (RWKV) launch per layer and batch, none from decode steps, and finite
   logits; prints prefill and decode tokens per second, and a
   ``torch.profiler`` breakdown of one prefill and 8 decode steps (device
   busy share, largest kernels); then the same serve under both of the
   CLI's overlays (``net=edge-v2`` and a JSONL tracer, ``traced_serve``):
   the same tokens and launches, a ``prefill`` and a ``decode`` span and
   a ``queue.wait`` event a batch and one ``slo`` event, its prefill
   rate beside the untraced one; then ``SERVE_MORE`` the same way,
   untraced, with K2 in every prefill layer: qwen3-8b, stablelm-12b (D
   160), minicpm3-4b (MLA's padded call), deepseek-moe-16b and
   grok-1-314b (MoE) cut to 2 of its 64 layers at every published width
   (the whole model does not fit on one card; the cut is in its record),
   hymba-1.5b (attention and the plain mamba scan in parallel, its window
   of 1024) and llava-next-34b (text only, as ``serve`` takes it) cut to
   16 of its 60 layers, each with its parameters' bytes, the init's peak
   memory (the layers filled in place) and the phase's seconds, freed
   before the next;
5a. llava-next-34b's image-prefix prefill on its served slice
   (``vlm_prefill``, ``VLM_PREFILL``): 4 requests of 2880 seeded patch
   embeddings and a 512-token prompt in one prefill (K2 once a layer at S
   3392), 32 greedy decode steps after the prefix (no kernel), finite
   logits; prefill tokens per second over image and text positions,
   decode tokens per second, its profile and peak;
5b. whisper-tiny at full width (``whisper_phase``, ``WHISPER``, bf16):
   frames [4, 1500, 384] from a seed, ``encode`` (K2 once an encoder
   layer), the teacher-forced ``forward`` of a 64-token prompt (8 K2
   launches), ``init_cache`` (4), the prompt decoded step by step and 32
   greedy steps (none), finite; encode seconds, decode tokens per second,
   peak;
5c. the smoke configs of ``SMOKE_SERVE_ARCHS`` (the nine decoder archs,
   fp32; the VLM text only) served on the card and on the CPU with the
   same parameters, and hymba-smoke once more at a 96-token prompt past
   its window of 64 (``SMOKE_SERVE_LONG``: K2's window and the ring-buffer
   decode): greedy tokens equal, prefill logits within 1e-4; then
   whisper-smoke (``smoke_whisper``): ``encode`` and the forward's logits
   within 1e-4, the prompt decoded step by step and 8 greedy steps, tokens
   equal, and on the card the decode logits at the prompt's positions
   within 1e-4 of the teacher-forced forward's;
5d. the step builders of ``launch/steps.py`` (``steps_phase``) at full
   width with real tensors from seed 0 (``STEP_CASES``): llama3.2-1b at
   ``prefill_32k``, ``decode_32k`` (a filled 32,768-slot cache),
   ``long_500k`` (its 8,192-slot window, position 524,287), ``train_4k``
   (remat, AdamW) and FACADE's step (2 nodes, S 4096, remat); rwkv6-1.6b
   at the four, ``train_4k`` at all 24 layers (K3 twice and its backward
   once a layer);
   whisper-tiny at ``prefill_32k`` and ``decode_32k``; each at the
   largest batch that fits (halving from the first tried on an
   out-of-memory error; the halvings and cuts are in its record), a
   warm-up and ``STEP_CALLS`` timed calls (1 where the warm-up took over
   ``STEP_LONG_S``): launches a call (``step_launches``), finite outputs,
   a first training or FACADE loss within ``STEP_LOSS_SPAN`` of ln V,
   seconds, tokens per second, peak memory and the roofline terms of
   ``roofline/analysis.py`` at the run's batch (traced on fake tensors in
   worker processes beside the card's work) beside the measured time;
   FACADE's step run again on the same
   inputs and compared bit for bit (and, where it differs, twice under
   ``device.deterministic()``). K2 and K3 at S 32,768 and K1 at the FACADE
   step's T held against their plain versions there (K2 on one batch row
   and one KV group, Hq 4 and Hkv 1; K1's plain version and library call
   made in 2,048-token chunks) and timed beside their bounds and library
   calls; K3's backward against the float64 witness at S 4096 on one
   batch row and timed at ``train_4k``'s batch; the smoke configs' steps (``STEPS_SMOKE``) on the card and on
   the CPU;
5e. the language models' mesh on one card (``lm_mesh_phase``,
   ``LM_MESH_CASES``): ``make_debug_mesh((1, 1))`` over a one-rank NCCL
   group, llama3.2-1b's ``prefill_32k`` and ``train_4k`` and rwkv6-1.6b's
   ``prefill_32k`` at cut batches through ``steps.build_case(mesh=...)``
   (DTensor arguments, the reference's hooks): every output bit for bit
   the ``mesh=None`` step's, K2 (16 a prefill) and K3 (24) launched on
   the DTensor path by the launch counters and by the profiler's kernel
   names, and the phase's seconds; and llama3.2-1b's FACADE step on the
   multi-pod layout at ``make_debug_mesh((1, 1, 1), ("pod", "data",
   "model"))`` (``LM_MESH_FACADE``: bf16, a node's batch 1 of 256
   tokens), bit for bit the ``mesh=None`` step's, its step 2c through K1's
   DTensor branch (once, by counter and by the LM body's kernel name) and
   K2 32 times;
5f. the six examples (``examples_phase``): each ``examples/torch_*.py``
   loaded with ``importlib`` and its ``run`` called on the card, the
   quickstart, fairness_eval, obs_demo and netsim_demo at the reference's
   own settings (48 rounds, obs_demo 24; GN-LeNet smoke, 8 nodes),
   serve_batched with llama3.2-1b's full config and facade_lm_pretrain
   with it at ``EXAMPLES_LM`` (nodes 3 and 1, 4 rounds, eval every 2),
   both with their weights drawn on the card (``CardInitDraws``):
   EL's and FACADE's per-round bytes as ``round_bytes`` counts them (the
   same model bytes, FACADE's 4-byte cluster id a push beside them), K1
   exactly once a round and once before each capture in every FACADE
   run, K2 16 times a prefill, K1 and K2 against their plain versions
   (``HS_TOL``, ``FA_TOL``) on seeded inputs at every signature each
   example gave them (seen by a pass-through, ``inputs_seen``; in the LM
   examples K1's LM body at 8 (node, head) pairs of T 256, D 2048, V
   128,256, K2 in bf16 at B 1 and 7 of S 32 in the prefills, B 4 of S 64
   in the feature passes and B 8 of S 64 in the evaluations), obs_demo's
   own dp/eo identity and its report, the robust run's finite node
   accuracies, every returned tensor on the card; in the LM example K1
   once a round and K2
   in each feature pass and evaluation, and one more round at full
   width profiled in a process of its own, K1's LM body by kernel name;
   each example's wall time and peak memory; then the quickstart at
   ``EXAMPLES_CARD_CPU`` on the card and on the CPU from the same draws,
   with its heads decorrelated (``EXAMPLES_CARD_CPU_JITTER``): bytes and
   cluster ids equal, accuracies within 0.1;
6. a ``kernels`` JSON line (each kernel's launches on its path, error,
   times and bound; K1 once for each of its bodies: the FMA body on the
   FACADE path, the tensor cores at llama's LM round and, with the padded
   copy, at hymba's, the two fp32 bodies at the fp32 llama round's shape,
   each with its launches on the fp32 LM paths, the llama round and the
   smoke LM rounds, that take it (none for the SIMT one since PR 35); K2's
   launches in each full-width serve, in llava's
   image-prefix prefill and in a whisper forward under
   ``"launches_by_arch"`` and its D 160, MLA and ``FA_FAMILIES`` shapes'
   errors, times, bounds and SDPA times under ``"shapes"``; head select's ResNet8 step
   2c under ``"resnet8"``,
   its launches on the driver phases under ``"driver_launches"``, the
   telemetry phase's under ``"obs"``, the node mesh's under ``"mesh"``;
   K1's, K2's and K3's on the language models' mesh (``"lm_mesh"``);
   K3's backward (``wkv_backward``, its own entry: the gradient of
   ``wkv_kernel``, which the TPU kernel lacks) with its launches in the
   RWKV FACADE rounds, in lm mode and in the steps;
   K1's and K2's in the examples phase (``"examples"``);
   K2's and K3's in the traced serves under ``"traced_serve_launches"``; each kernel's check, times, bound
   and launches at the steps' lengths under ``"steps"``),
   the total time, then the last line ``{"ok": true, "device": {...}}``.

Every kernel's launch count is set to 0 just before each path is driven
and read just after (``counted``), each phase reading only its own. The
counts are what the card ran: the segment engine takes a capture's calls
back and adds them once per replay. After the timed phases, K1's LM-body
split runs in this process and, where the profiler records none of its
launches there (as late in this process it has, also before the segment
engine's phases were added), once more in a process of its own. TF32 is off for every matmul and
convolution of the run. A JSON record of every number goes to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import inspect
import json
import multiprocessing
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.configs.facade_paper import lenet, resnet8  # noqa: E402
from repro_torch.core import facade, split  # noqa: E402
from repro_torch.core.bindings import make_binding  # noqa: E402
from repro_torch.core.cache import EngineCache, EngineSpec  # noqa: E402
from repro_torch.core.engine import (WARMUP_ROUNDS, SegmentEngine,  # noqa: E402
                                     segment_plan)
from repro_torch.core.runner import (ALGOS, LMFacade, TorchDraws,  # noqa: E402
                                     run_experiment)
from repro_torch.core.state import init_facade_state  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.head_select import head_losses, head_losses_ref  # noqa: E402
from repro_torch.kernels.head_select import ops as hs_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import (wkv, wkv_backward,  # noqa: E402
                                      wkv_backward_scan, wkv_scan,
                                      wkv_train)
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ops import WkvFunction  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.launch import dryrun, steps, train  # noqa: E402
from repro_torch.launch.mesh import (HW, MESH_NAME,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.launch.serve import make_requests, serve  # noqa: E402
from repro_torch.models import api, attention, transformer, whisper  # noqa: E402
from repro_torch.models.base import get_config, list_archs  # noqa: E402
from repro_torch.netsim import (PRESETS, NetSchedule,  # noqa: E402
                                NetworkConfig)
from repro_torch.obs import (JsonlSink, Obs, ObsConfig, Tracer,  # noqa: E402
                             read_jsonl)
from repro_torch.obs.report import build_report  # noqa: E402
from repro_torch.resil import FaultConfig, noise_spec  # noqa: E402
from repro_torch.roofline import analyze_step, count_step  # noqa: E402
from repro_torch.sweep import SweepCell, run_sweep  # noqa: E402
from repro_torch.sweep import driver as sweep_driver  # noqa: E402
from repro_torch.topo import TopoConfig, inclusion_stats  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM data sheet, fp32 outside tensor cores
BF16_FLOPS = 989e12           # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS = 495e12           # H100 SXM data sheet, dense TF32 tensor cores
FMA_LATENCY_CYCLES = 4        # dependent fp32 FMA latency on Hopper
KERNELS = (head_losses, flash_attention, wkv, wkv_backward)
# (K, T, D, V): the reference kernel tests' HS_SHAPES (tests/test_kernels.py)
HS_SHAPES = [(2, 128, 64, 256), (3, 256, 64, 512), (5, 128, 128, 1024)]
MAIN_SHAPE = (32, 2, 8, 513, 10)        # n, K, T = B, D = 512 + bias, V
# relative (against max(|loss|, 1)): the same values on both sides, fp32
# sums in other orders; also for the tensor-core body (bf16 values read
# exactly, fp32 products and sums)
HS_TOL = 2e-5
# K1 in the LM regime (the tensor-core body), (n·K, 1, T, D, V) as the LM
# binding hands step 2c over: FACADE on llama3.2-1b (n 2, k 2, T = B·S =
# 1024, D 2048, V 128,256), then T off the 64-token tiles with V = 1000
# and with rwkv6-1.6b's V = 65,536
HS_LM_SHAPE = (4, 1, 1024, 2048, 128256)
# ... and FACADE on rwkv6-1.6b (the same n, k and T; V 65,536)
HS_LM_RWKV = (4, 1, 1024, 2048, 65536)
HS_LM_RAGGED = [(2, 2, 1000, 2048, 1000), (4, 1, 200, 2048, 65536)]
# K1's fp32 bodies (the SIMT one and the tensor cores', fp32 at an LM's
# shapes): held at HS_SHAPES and at a four-card FACADE rank's step 2c (n·K
# 2, T 512, D 2048, V 128,256), and held and timed there, at T 2048 (the
# reference's B 8 of S 256 a node) and at the one-card fp32 llama round's
# n·K 4, T 1024; HS_F32_EDGE puts V at the tiled bodies' threshold (one
# 128-column tile)
HS_F32_CHECK = (2, 1, 512, 2048, 128256)
HS_F32_TIMED = [(2, 1, 2048, 2048, 128256), (4, 1, 1024, 2048, 128256)]
HS_F32_EDGE = (1, 2, 128, 64, 128)
# the tensor-core body on a ragged V (its heads copied into rows of V8 =
# V rounded up to 8): hymba-1.5b's LM FACADE step 2c (n·K 4, T 1024, D
# 1600, V 32,001) and whisper-tiny's vocabulary (n·K 2, T 256, D 384, V
# 51,865)
HS_PADDED = {"hymba": (4, 1, 1024, 1600, 32001),
             "whisper": (2, 1, 256, 384, 51865)}
# the two on non-finite inputs (hs_lm_non_finite_case's placement): the fp32
# body at T 256, D 2048, V 4,096 and the tensor-core body with both D and V
# ragged (both copies)
HS_F32_NON_FINITE = (4, 2, 256, 2048, 4096)
HS_PADDED_NON_FINITE = (4, 2, 256, 2044, 4099)
# K1's fp32 tensor-core body (3xTF32) against a float64 witness (the plain
# version's steps in float64 on the same inputs), each loss relative to
# max(|loss|, 1): its distance within HS_TC32_FACTOR times the plain fp32
# version's own distance (the control), or within HS_TC32_FLOOR (four
# halves of an fp32 ulp, where both sit at the losses' own rounding).
# Readings: the CPU model (tests/test_torch_head_select_tc32.py's witness
# test, D 2048, heads at 0.02 and 0.05) 1.04 and 3.44 times the control
# (8.1e-8 and 1.7e-7, under the floor); the card (an H100, this script's
# fp32 shapes) 0 to 1.37 times, 1.0e-7 at most
HS_TC32_FACTOR = 4.0
HS_TC32_FLOOR = 2.0 ** -22
# K1's two fp32 bodies (hs_ops.BODIES), each held and timed at every fp32
# shape above whichever the rule gives it
F32_BODIES = ("fp32_tiled", "fp32_tensor_core")
# ... and timed in turns around the rule's D threshold (hs_ops.F32_TC_MIN_D)
# at HS_SHAPES' T and V, and at the smoke LM FACADE step 2c (n·K 4, T 64, D
# 256, V 512)
HS_TC32_SWEEP = ([(1, 3, 256, d, 512) for d in (128, 192, 256, 512)]
                 + [(1, 5, 128, d, 1024) for d in (192, 256, 512)]
                 + [(4, 1, 64, 256, 512)])
PAPER = dict(k=2, degree=4, local_steps=10, batch_size=8, lr=0.05, seed=0)
ROUNDS, EVAL_EVERY = 8, 4
# a FACADE run through the segment engine captures one round (warmup 0) and
# warms it up first: K1 runs once a warm-up call and once a replayed round
FACADE_LAUNCHES = ROUNDS + WARMUP_ROUNDS
# the engine phase: parity runs as above with FACADE's first 2 rounds in
# its warmup phase (both of its rounds captured); steady state over 40
# rounds with an eval every 20, the second run (seed 1) of one EngineCache
# timed; the profile over one replayed 20-round FACADE segment
PARITY_WARMUP = 2
ENGINE_ROUNDS, ENGINE_EVAL_EVERY = 40, 20
K1_KERNEL = "head_losses_kernel"      # K1's FMA body, by name in a profile
K1_LM_KERNEL = "head_losses_lm_kernel"  # its LM body's tile kernel
K1_LM_MERGE = "head_losses_lm_merge"    # ... and its merge (both tiled bodies)
K1_F32_KERNEL = "head_losses_f32_kernel"  # its fp32 tiled body's tile kernel
K1_PAD_KERNEL = "head_losses_pad_kernel"  # the tensor cores' ragged copy
K1_F32TC_KERNEL = "head_losses_f32tc_kernel"  # fp32 on the tensor cores
K1_SPLIT_KERNEL = "head_losses_tf32_split_kernel"  # ... its features' split
# each body's tile kernel by name (hs_ops.BODIES)
K1_BODY_KERNEL = {"fma": K1_KERNEL, "fp32_tiled": K1_F32_KERNEL,
                  "tensor_core": K1_LM_KERNEL,
                  "fp32_tensor_core": K1_F32TC_KERNEL}
K1_NAMES = (K1_KERNEL, K1_F32_KERNEL, K1_LM_KERNEL, K1_LM_MERGE,
            K1_PAD_KERNEL, K1_F32TC_KERNEL, K1_SPLIT_KERNEL)
# NCCL's device kernels by name in a profile (not the profiler's "nccl:"
# annotations, CUDA events too, each over its kernel)
NCCL_KERNEL = "ncclDevKernel"
# the driver phases (pipelined, checkpoint/resume, sweep) on the same data:
# 40 rounds with an eval every 10, FACADE's first PARITY_WARMUP rounds in
# its warmup phase; the sweep over three seeds, FACADE and EL
DRIVER_ROUNDS, DRIVER_EVAL_EVERY = 40, 10
SWEEP_SEEDS = (0, 1, 2)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
SMALL_TOL = 0.1     # accuracy across devices (reference precedent)
# the netsim phase (same data, ROUNDS rounds with an eval every EVAL_EVERY):
# the five algorithms under NET_ALL, FACADE and EL under NET_TWO, engine
# against loop; then FACADE's steady rate under every preset and net=None,
# NET_RATE_ROUNDS rounds (one segment) of seed 1 after seed 0 captured
NET_ALL = ("edge-v2", "edge-churn")
NET_TWO = ("bursty-wan", "core-edge", "async-edge", "hostile")
NET_RATE_ROUNDS = 20
# the faults phase (same data, ROUNDS rounds with an eval every EVAL_EVERY,
# all under edge-v2): the reference's own example (resil/__init__.py), its
# tests' reset restarts, noise-mode corruption and a NaN storm; FaultConfig
# fields as the reference's (tests/test_resil.py)
FAULTS_NAN = FaultConfig(crash_rate=0.05, restart_rate=0.5,
                         corrupt_rate=0.05, corrupt_mode="nan")
FAULTS_RESET = FaultConfig(crash_rate=0.4, restart_rate=0.6,
                           restart_mode="reset")
FAULTS_NOISE = FaultConfig(crash_rate=0.3, restart_rate=0.5,
                           corrupt_rate=0.3)
FAULTS_STORM = FaultConfig(corrupt_rate=0.1, corrupt_mode="nan")
FAULTS_RESUME_EVAL_EVERY = 2          # 4 segments: the kill at the third
# the topo phase (same data and schedule): the reference benchmark's
# policies (benchmarks/topo_adapt.py), its comm-bound presets for the
# rates, and the floor measured as its tests measure it (tests/test_topo.py)
TOPO_KW = dict(decay=0.7, min_inclusion=0.25, ref_payload_bytes=5e4)
TOPO_REL = TopoConfig(policy="reliability", **TOPO_KW)
TOPO_BW = TopoConfig(policy="bandwidth", **TOPO_KW)
TOPO_FLOOR_ROUNDS = 400
# the telemetry phase: FACADE's observed rate in turns with the unobserved
# one, OBS_RATE_REPS timed runs each (NET_RATE_ROUNDS rounds, seed 1)
OBS_RATE_REPS = 5
# the node-mesh phase: the reference's full stack (tests/test_mesh.py),
# and FACADE's rate with mesh=(1,) in turns with mesh=None
MESH_FAULTS = FaultConfig(crash_rate=0.1, restart_rate=0.5,
                          corrupt_rate=0.2, corrupt_mode="nan")
MESH_RATE_REPS = 3
# the paper's Flickr-Mammals experiment through the launcher's paper_main:
# full-width ResNet8 (64×64 images, 41 classes), 32 nodes in clusters 24:8
# rotated rot0/rot180, k 2, degree 4, H 10, B 8, lr 0.05, 8 rounds with an
# eval every 4, data and run seed 3 (paper_main uses one seed for both)
RESNET8_PAPER = dict(
    mode="paper", model="resnet8", smoke=False, clusters=[24, 8],
    transforms=["rot0", "rot180"], k=2, rounds=ROUNDS, degree=4,
    local_steps=10, warmup_rounds=0, eval_every=EVAL_EVERY, target_acc=None,
    n_classes=41, image_size=64, samples_per_class=32, test_per_class=16,
    batch=8, lr=0.05, seed=3, out=None, device="cuda")
# bytes per round at that scale: 128 pushes of the core (5,136 fp32
# parameters, 20,544 bytes), one head (74,729, 298,916 bytes) and the
# 4-byte cluster id (FACADE), the core alone (DEPRL) or the model (79,865,
# 319,460 bytes)
RESNET8_BYTES = {"facade": 40891392.0, "el": 40890880.0,
                 "dpsgd": 40890880.0, "deprl": 2629632.0, "dac": 40890880.0}
# step 2c of that run: one stream per (node, head), (n·k, K', T, D, V) =
# (64, 1, 8, 64 + bias, 41), fp32
HS_RESNET8 = (64, 1, 8, 65, 41)
# the launcher's lm mode on both LM smoke configs (fp32): steps, batch, seq
LM_MODE = dict(steps=20, batch=4, seq=64)
# (B, Hq, Hkv, S, D): the reference kernel tests' FA_SHAPES
# (tests/test_kernels.py), then llama3.2-1b's serving shape and a long one
FA_SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
             (2, 2, 2, 512, 64)]
FA_SERVE = (4, 32, 8, 512, 64)
FA_LONG = (1, 32, 8, 4096, 64)
# bf16 cases of the tensor-core kernel's own paths: (B, Hq, Hkv, S, D),
# causal, window, std of q and k (3.0: scores of tens, which exercise the
# running-max rescaling)
FA_BF16_CASES = [((2, 8, 2, 77, 32), True, 0, 0.3),
                 ((1, 4, 2, 300, 128), True, 0, 0.3),
                 ((1, 4, 2, 130, 32), False, 0, 0.3),
                 ((1, 4, 2, 130, 64), False, 0, 0.3),
                 ((1, 4, 2, 130, 128), False, 0, 0.3),
                 ((2, 4, 2, 65, 64), True, 0, 0.3),
                 ((2, 8, 2, 256, 64), True, 0, 3.0),
                 ((4, 32, 8, 512, 64), True, 0, 3.0)]
# (atol, rtol) against the plain version in fp32: fp32 output as the
# reference kernel tests hold it; bf16 output is one rounding of an fp32
# computation, so within one bf16 ulp (2^-8 of its value)
FA_TOL = {torch.float32: (2e-6, 2e-6), torch.bfloat16: (1e-6, 2.0 ** -8)}
# stablelm-12b's serving shape, (B, Hq, Hkv, S, D): its head dim is
# 5120 / 32 = 160, the kernel's D 160 instance
FA_D160 = (4, 32, 8, 512, 160)
# minicpm3-4b's MLA attention at the serving batch, (B, H, S, q.k dim, v
# dim) = (4, 40, 512, 64 + 32, 64): attention.mla_attention pads q, k and
# v to the kernel's D 128 and slices the output back to 64
FA_MLA = (4, 40, 512, 96, 64)
# (B, S, H, hd): the reference kernel tests' RW_SHAPES, then a ragged S and
# rwkv6-1.6b's serving shape
RW_SHAPES = [(1, 64, 1, 32), (2, 128, 2, 32), (1, 256, 4, 64)]
RW_RAGGED = (2, 100, 2, 64)
RW_SERVE = (4, 512, 32, 64)
# the RWKV FACADE round's training forward and step 2c (LM_FACADE's B and S,
# rwkv6-1.6b's heads)
RW_TRAIN = (4, 256, 32, 64)
# the kernel's own paths: (B, S, H, hd), log decay shift. S around its
# 16-step chunks; w near 0 (exp(-e^2)) and near 1 (exp(-e^-6)); B * H = 264
# blocks, two waves of the 132 SMs
RW_CASES = [((1, 1, 2, 64), 0.0), ((2, 31, 2, 64), 0.0),
            ((2, 33, 2, 64), 0.0), ((2, 100, 3, 64), 2.0),
            ((1, 512, 2, 32), -6.0), ((6, 48, 44, 64), 0.0)]
RW_TOL = 1e-5
# K3's backward (wkv_backward): (B, S, H, hd), log decay shift, each with
# y's gradient alone and with the final state's too. The RWKV FACADE
# round's shape; S 1; S 33 around both head dims' chunks (8 steps at hd
# 64, 16 at hd 32); ragged last chunks at S 100 (hd 64: 12 chunks and 4
# steps; hd 32: 6 and 4); w near 0 (exp(-e^2)), where rebuilding a state
# backwards would divide by it, and near 1 (exp(-e^-6))
RW_BWD_CASES = [((4, 256, 32, 64), 0.0), ((1, 1, 2, 64), 0.0),
                ((2, 33, 2, 64), 0.0), ((2, 33, 2, 32), 0.0),
                ((2, 100, 3, 64), 2.0), ((2, 100, 4, 32), -6.0)]
# ... and at train_4k's length on one batch row (steps_phase)
RW_BWD_LONG = (1, 4096, 32, 64)
# the backward's gate, against a float64 witness (the plain loop on the
# same inputs in float64), each leaf relative to its largest |gradient|:
# the kernel's distance within RW_BWD_FACTOR times the plain fp32 loop's
# own distance (the control), or within RW_BWD_FLOOR (a few fp32 ulps of
# the largest, where the control is near exact), and always within RW_TOL
RW_BWD_FACTOR = 4.0
RW_BWD_FLOOR = 2.0 ** -21
# FACADE on llama3.2-1b at full width (bf16, heads untied by the binding):
# 2 nodes in clusters 1:1, k 2, degree 1, H 2, B 4, S 256 (T = 1024 tokens
# a node at step 2c), tokens as examples/facade_lm_pretrain.py builds them;
# 3 rounds and one more profiled (rwkv6-1.6b too since its wkv backward
# is a kernel: a round took 20-36 s on the plain backward)
LM_FACADE = dict(clusters=(1, 1), k=2, degree=1, local_steps=2, batch=4,
                 seq=256, lr=5e-3, head_jitter=1e-3, seqs_per_node=32,
                 seed=0)
# hymba-1.5b the same way in bf16 (its V 32,001 on the tensor cores through
# the padded copy, K2 with its window of 1024 in every feature-pass layer;
# one round, 13.5-25 s, most of it the plain SSM scan, and that one
# profiled), and one llama3.2-1b round with the config in fp32 (step 2c on
# the fp32 tensor-core body at n·K 4, T 1024, D 2048, V 128,256), then
# profiled once more
LM_ROUNDS = {"llama3.2-1b": 3, "rwkv6-1.6b": 3, "hymba-1.5b": 1,
             "llama3.2-1b fp32": 1}
LM_RUN_DTYPE = {"llama3.2-1b fp32": "float32"}
# runs whose one round is the profiled one: a round takes 13.5-25 s
# (hymba), the profiler, with the device's activity alone, 14.5 s more to
# stop and read its 0.93 million events (rwkv6-1.6b's round on the plain
# wkv backward took 20-36 s and 42-45 s more for 1.79 million). A profile
# of hymba's K1 call alone recorded no device event in the script's
# process.
LM_PROFILED_ONLY = ("hymba-1.5b",)
# the host seconds in each ``wkv_train`` backward, by a host clock around
# ``WkvFunction.backward`` (the profiler's name for its host event), and
# K3's forward and backward kernels by name in RWKV's profiled round
WKV_BACKWARD = "autograd::engine::evaluate_function: WkvFunctionBackward"
# K2 in the LM FACADE path's step-2c feature pass: llama3.2-1b's heads at
# LM_FACADE's batch and sequence, (B, Hq, Hkv, S, D) = (4, 32, 8, 256, 64)
LM_CFG = get_config("llama3.2-1b")
FA_LM = (LM_FACADE["batch"], LM_CFG.n_heads, LM_CFG.n_kv_heads,
         LM_FACADE["seq"], LM_CFG.hd)
# round 1 scores the initial heads: ln V, plus about 0.4 for logits of
# standard deviation about 0.9 (untied head at 0.02, unit-RMS features):
# llama3.2-1b ln 128,256 = 11.76, so [11, 13] (in fp32 too: the same
# init); rwkv6-1.6b ln 65,536 = 11.09, so [10.5, 12.5]; hymba-1.5b ln
# 32,001 = 10.37, and logits of standard deviation about 0.8 (0.02 times
# sqrt(1600)) add 0.32 (the control, 10.69; read on the card: 10.70-10.72),
# so [9.8, 11.8]
LM_SELECT_RANGE = {"llama3.2-1b": (11.0, 13.0), "rwkv6-1.6b": (10.5, 12.5),
                   "hymba-1.5b": (9.8, 11.8),
                   "llama3.2-1b fp32": (11.0, 13.0)}
# the launcher's lm mode runs on these two smoke configs
LM_MODE_ARCHS = ("llama3.2-1b", "rwkv6-1.6b")
# the smoke config (fp32) on the card and on the CPU: selection losses and
# parameters (against each leaf's largest value) within 1e-4, the same fp32
# arithmetic in other summation orders; cluster ids and bytes exact; 2
# rounds
SMOKE_LM = dict(LM_FACADE, batch=2, seq=32, lr=1e-2, seqs_per_node=8)
SMOKE_LM_ROUNDS = 2
SMOKE_LM_TOL = 1e-4
SERVE = dict(batch=4, prompt_len=512, gen_len=32, temperature=0.0, seed=0)
N_REQUESTS = 8
# the archs served at full width after llama3.2-1b and rwkv6-1.6b (whose
# serves are also traced), each with K2 in every prefill layer, and the
# layers kept: grok-1-314b's 64 layers at every published width are about
# 630 GB in bf16, so its serve keeps 2 of them (about 22.9 GB with the
# embedding and head); llava-next-34b's 60 are 68.8 GB, which with its
# image-prefix prefill leaves no margin on an 80 GB card, so it keeps 16
# (about 19.7 GB)
SERVE_MORE = {"qwen3-8b": None, "stablelm-12b": None, "minicpm3-4b": None,
              "deepseek-moe-16b": None, "grok-1-314b": 2,
              "hymba-1.5b": None, "llava-next-34b": 16}
# the VLM's image-prefix prefill (5a), on llava-next-34b's served slice:
# SERVE's batch of requests, each its config's 2880 patch embeddings (the
# vision tower is a stub, as in the reference: drawn from a seeded
# generator at the token embeddings' scale, 0.02) in front of a prompt of
# SERVE's 512 tokens, then SERVE's 32 greedy decode steps
VLM_PREFILL = dict(batch=SERVE["batch"], prompt_len=SERVE["prompt_len"],
                   gen_len=SERVE["gen_len"], img_std=0.02)
# whisper-tiny at full width (5b): SERVE's batch of requests, each the
# config's 1500 frames (the audio frontend is a stub: unit normal draws),
# a 64-token decoder prompt and 32 greedy decode steps; and at smoke
# size on the card and on the CPU (5c)
WHISPER = dict(batch=SERVE["batch"], prompt_len=64, gen_len=32)
WHISPER_SMOKE = dict(batch=2, prompt_len=16, gen_len=8)
# the smoke configs served on the card and on the CPU (5c) and the smoke
# LM FACADE rounds (4b): MLA, MoE and the hybrid beside GQA and RWKV
SMOKE_SERVE_ARCHS = ("llama3.2-1b", "rwkv6-1.6b") + tuple(SERVE_MORE)
SMOKE_LM_ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "minicpm3-4b",
                  "deepseek-moe-16b", "hymba-1.5b")
SMOKE_SERVE = dict(batch=2, prompt_len=32, gen_len=8, temperature=0.0,
                   seed=0)
# hymba-smoke served once more with prompts past its window of 64: K2's
# window masks, and decode writes around the 64-slot ring buffer
SMOKE_SERVE_LONG = {"hymba-1.5b": dict(SMOKE_SERVE, prompt_len=96)}
# K2 at the hybrid, audio and VLM families' full-width prefill shapes,
# (B, Hq, Hkv, S, D), causal, window, calls a timed graph: hymba-1.5b at twice its window of
# 1024 (GQA group 5; its serving prompt of 512 sits inside the window, so
# this is the shape where the window masks); whisper-tiny's encoder over
# its 1500 frames (non-causal, ragged against the kernel's 64-row tiles);
# llava-next-34b's 2880 image positions and 512-token prompt (GQA group 7)
HYMBA_CFG = get_config("hymba-1.5b")
WHISPER_CFG = get_config("whisper-tiny")
LLAVA_CFG = get_config("llava-next-34b")
FA_FAMILIES = {
    "hymba": ((SERVE["batch"], HYMBA_CFG.n_heads, HYMBA_CFG.n_kv_heads,
               2 * HYMBA_CFG.sliding_window, HYMBA_CFG.hd), True,
              HYMBA_CFG.sliding_window, 20),
    "whisper_enc": ((WHISPER["batch"], WHISPER_CFG.n_heads,
                     WHISPER_CFG.n_kv_heads, WHISPER_CFG.encoder_seq,
                     WHISPER_CFG.hd), False, 0, 50),
    "llava": ((VLM_PREFILL["batch"], LLAVA_CFG.n_heads,
               LLAVA_CFG.n_kv_heads,
               LLAVA_CFG.n_image_tokens + VLM_PREFILL["prompt_len"],
               LLAVA_CFG.hd), True, 0, 3)}
SMOKE_LOGIT_TOL = 1e-4  # fp32 on both devices, other summation order
# K1's LM body on non-finite inputs (bf16, V a multiple of 8): (n, K, T,
# D, V), the non-finite values placed as hs_non_finite_case places them
HS_LM_NON_FINITE = (4, 2, 256, 2048, 4096)
# the step builders (launch/steps.py) at full width (steps_phase): (arch,
# input shape, the batch tried first, layers kept or None). A case's batch
# is the largest that fits on the card, halving from the first; rwkv6's
# train_4k runs all 24 layers since its wkv backward is a kernel (it kept
# 1 on the plain recurrence, about 3 s a layer at S 4096), from a batch
# reckoned from memory, RWKV_TRAIN_BATCH: on an 80 GB card B 16 peaks at
# 49.43 GB and B 32 runs out of memory. Each runs one warm-up call and
# STEP_CALLS timed calls, 1 where the warm-up took over STEP_LONG_S.
RWKV_TRAIN_BATCH = 16
STEP_CASES = [("llama3.2-1b", "prefill_32k", 32, None),
              ("llama3.2-1b", "decode_32k", 128, None),
              ("llama3.2-1b", "long_500k", 1, None),
              ("llama3.2-1b", "train_4k", 256, None),
              ("llama3.2-1b", "facade_pod", 16, None),
              ("rwkv6-1.6b", "prefill_32k", 32, None),
              ("rwkv6-1.6b", "decode_32k", 128, None),
              ("rwkv6-1.6b", "long_500k", 1, None),
              ("rwkv6-1.6b", "train_4k", RWKV_TRAIN_BATCH, None),
              ("whisper-tiny", "prefill_32k", 32, None),
              ("whisper-tiny", "decode_32k", 128, None)]
STEP_CALLS, STEP_LONG_S = 2, 3.0
# the roofline traces (fake tensors on the CPU) run in worker processes
# beside the card's work: workers and threads each
TRACE_WORKERS, TRACE_THREADS = 2, 2
# a loss on random tokens from the initial model: ln V plus about 0.4
# (LM_SELECT_RANGE), within [ln V - 0.5, ln V + 1.5]
STEP_LOSS_SPAN = (-0.5, 1.5)
# K2 and K3 at the prefill_32k length, and K1 at the FACADE step's: the
# check shapes (K2 on one batch row and one KV group, Hq 4 and Hkv 1: 17 GB
# of fp32 scores in the plain version) and the timed shapes (K2 one batch
# row of llama3.2-1b's heads; K3 one row and rwkv6-1.6b's prefill batch)
FA_STEPS_CHECK = (1, 4, 1, 32768, 64)
FA_STEPS_TIME = (1, 32, 8, 32768, 64)
RW_STEPS = (1, 32768, 32, 64)
# the smoke configs' steps on the card and on the CPU: (arch, shape) at B 2
# and S 64
STEPS_SMOKE = [("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"),
               ("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "facade_pod"),
               ("rwkv6-1.6b", "train_4k"), ("rwkv6-1.6b", "prefill_32k"),
               ("rwkv6-1.6b", "decode_32k"), ("whisper-tiny", "prefill_32k"),
               ("whisper-tiny", "decode_32k")]
STEPS_SMOKE_SEQ = 64
# the language models' mesh on one card (lm_mesh_phase): (arch, input
# shape, batch, K2 and K3 launches a call); full width, cut batches
LM_MESH_CASES = [("llama3.2-1b", "prefill_32k", 2, (16, 0)),
                 ("llama3.2-1b", "train_4k", 2, (0, 0)),
                 ("rwkv6-1.6b", "prefill_32k", 2, (0, 24))]
# ... and llama3.2-1b's FACADE step (bf16, n 2, k 2) on the multi-pod
# layout at (1, 1, 1): a node's batch and length, cut so that the case
# adds seconds
LM_MESH_FACADE = dict(batch_per_node=1, seq=256)
# the examples (``examples_phase``): the LM pretraining example at full
# width, and the quickstart held card against CPU
EXAMPLES_LM = dict(nodes=(3, 1), rounds=4, eval_every=2)
EXAMPLES_CARD_CPU = dict(rounds=4, eval_every=2)
EXAMPLES_CARD_CPU_JITTER = 0.05       # as small_input_phase
# K2's and K3's kernels by name in a profile (K3's backward apart:
# "wkv_kernel" is not in its name)
FA_KERNELS = ("fa_kernel", "fa_bf16_kernel")
WKV_KERNEL = "wkv_kernel"
WKV_BWD_KERNEL = "wkv_backward_kernel"


def log(*args):
    print(*args, flush=True)


def settled_allocated() -> int:
    """Device memory held by live tensors once pending work is done, with
    cuBLAS's per-stream workspaces released (each new stream's first
    matmul allocates one and keeps it)."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def graph_ms(fn, calls: int = 50, reps: int = 7) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events; the median per call. The
    graph and its memory pool are released before returning, and the
    device memory held afterwards must be what it was before (or raise),
    so a timing changes no later phase's peak memory."""
    before = settled_allocated()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph, stream
    after = settled_allocated()
    if after != before:
        raise AssertionError(f"graph_ms kept {after - before} bytes of "
                             f"device memory ({before} before, {after} "
                             f"after)")
    return statistics.median(times)


def hs_case(n, k, t, d, v, dtype, seed, drop=0.1):
    g = torch.Generator().manual_seed(seed)
    feats = 0.5 * torch.randn((n, t, d), generator=g)
    heads = 0.05 * torch.randn((n, k, d, v), generator=g)
    labels = torch.randint(0, v, (n, t), generator=g, dtype=torch.int32)
    labels[torch.rand((n, t), generator=g) < drop] = -1
    return (feats.to(dtype).cuda(), heads.to(dtype).cuda(), labels.cuda())


def hs_main_inputs(seed):
    """Inputs at the FACADE path's shape as the path makes them: LeNet's
    bias folded in as a ones column, and no excluded label."""
    feats, heads, labels = hs_case(*MAIN_SHAPE, torch.float32, seed=seed)
    feats[..., -1] = 1.0
    return feats, heads, labels.abs()


def hs_lm_case(n, k, t, d, v, seed, drop=0.1, dtype=torch.bfloat16):
    """LM-regime inputs drawn on the card: features as ``rms_norm`` gives
    them (unit scale), heads at the untied head's init scale (0.02), in
    ``dtype`` (bf16 unless asked); ``drop`` of the labels excluded."""
    g = torch.Generator("cuda").manual_seed(seed)
    feats = torch.randn((n, t, d), generator=g, device="cuda")
    heads = 0.02 * torch.randn((n, k, d, v), generator=g, device="cuda")
    labels = torch.randint(0, v, (n, t), generator=g, dtype=torch.int32,
                           device="cuda")
    labels[torch.rand((n, t), generator=g, device="cuda") < drop] = -1
    return feats.to(dtype), heads.to(dtype), labels


def hs_lm_library(feats, heads, labels):
    """Per (node, head) a bf16 ``torch.matmul`` and ``cross_entropy`` on
    the fp32 logits (the yardstick; the port never calls it)."""
    n, k = heads.shape[:2]
    return torch.stack([torch.stack([F.cross_entropy(
        torch.matmul(feats[i], heads[i, j]).float(), labels[i].long(),
        ignore_index=-1) for j in range(k)]) for i in range(n)])


def hs_check(name, got, want, tol=HS_TOL, **info):
    """Relative error (against max(|want|, 1)) within ``tol`` and equal
    argmins, or raise."""
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
    same_argmin = bool(torch.equal(got.argmin(1), want.argmin(1)))
    rec = dict(info, max_abs_err=err, max_rel_err=rel,
               argmin_equal=same_argmin)
    log(f"{name} check", json.dumps(rec))
    if not (np.isfinite(err) and rel <= tol and same_argmin):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def hs_non_finite_case(seed):
    """The FACADE path's inputs with non-finite values where an unguarded
    faulty round puts them: node 0 a token of NaN features, node 1 a head
    of NaN weights, node 2 a +inf bias weight in a column none of its
    labels names (a +inf logit, a +inf loss), node 3 a head of +inf
    weights (+inf and -inf products: NaN logits); the other nodes
    finite."""
    feats, heads, labels = hs_main_inputs(seed)
    feats[0, 3, :-1] = float("nan")
    heads[1, 1] = float("nan")
    free = sorted(set(range(MAIN_SHAPE[4]))
                  - set(labels[2].tolist()))[0]
    heads[2, 0, -1, free] = float("inf")
    heads[3, 1] = float("inf")
    return feats, heads, labels


def hs_non_finite_check() -> dict:
    """K1 against its plain version on :func:`hs_non_finite_case`: NaN
    and +inf at the same places, the finite losses within ``HS_TOL``
    (relative) and equal argmins (the first NaN of a row, else the least
    loss), or raise."""
    feats, heads, labels = hs_non_finite_case(seed=97)
    got = head_losses(feats, heads, labels)
    want = head_losses_ref(feats, heads, labels)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    rec = {"nan_equal": bool(torch.equal(got.isnan(), want.isnan())),
           "posinf_equal": bool(torch.equal(got.isposinf(),
                                            want.isposinf())),
           "non_finite": int((~fin).sum()),
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / want[fin].abs().clamp(min=1)).max()),
           "argmin_equal": bool(torch.equal(got.argmin(1),
                                            want.argmin(1))),
           "argmin_first_nodes": got.argmin(1)[:4].tolist()}
    log("head_select non-finite check", json.dumps(rec))
    if not (rec["nan_equal"] and rec["posinf_equal"] and rec["argmin_equal"]
            and rec["max_rel_err"] <= HS_TOL and rec["non_finite"] == 5
            and rec["argmin_first_nodes"] == [0, 1, 1, 1]):
        raise AssertionError(f"head_select disagrees with its plain "
                             f"version on non-finite inputs: {rec}")
    return rec


def hs_lm_non_finite_case(seed, shape=HS_LM_NON_FINITE,
                          dtype=torch.bfloat16):
    """LM-regime inputs (``shape``, ``dtype``; ``HS_LM_NON_FINITE`` in bf16
    unless asked) with the non-finite values ``hs_non_finite_case``
    places: node 0 a token of NaN features (its label kept), node 1 a head
    of NaN weights, node 2 a +inf weight on a feature that is 1 for every
    token, in a column none of its labels names (a +inf logit, a +inf
    loss), node 3 a head of +inf weights (NaN logits); the other nodes
    finite."""
    n, k, t, d, v = shape
    feats, heads, labels = hs_lm_case(n, k, t, d, v, seed=seed, dtype=dtype)
    labels[0, 3] = 5
    feats[0, 3] = float("nan")
    heads[1, 1] = float("nan")
    feats[2, :, 0] = 1.0
    free = sorted(set(range(v)) - set(labels[2].tolist()))[0]
    heads[2, 0, 0, free] = float("inf")
    heads[3, 1] = float("inf")
    return feats, heads, labels


def hs_lm_non_finite_check(shape=HS_LM_NON_FINITE,
                           dtype=torch.bfloat16, body=None) -> dict:
    """K1's tiled bodies against the plain version on
    :func:`hs_lm_non_finite_case` (the tensor-core body at
    ``HS_LM_NON_FINITE`` unless asked; ``body`` forces one), with the FMA
    body's gates (``hs_non_finite_check``), or raise."""
    feats, heads, labels = hs_lm_non_finite_case(96, shape, dtype)
    kw = {"body": body} if body else {}
    body = body or hs_ops.body_for(*shape, dtype)
    got = head_losses(feats, heads, labels, **kw)
    want = head_losses_ref(feats, heads, labels)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    rec = {"shape": list(shape), "dtype": str(dtype), "body": body,
           "nan_equal": bool(torch.equal(got.isnan(), want.isnan())),
           "posinf_equal": bool(torch.equal(got.isposinf(),
                                            want.isposinf())),
           "non_finite": int((~fin).sum()),
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / want[fin].abs().clamp(min=1)).max()),
           "argmin_equal": bool(torch.equal(got.argmin(1),
                                            want.argmin(1))),
           "argmin_first_nodes": got.argmin(1)[:4].tolist(),
           "got": got.tolist()}
    log("head_select lm non-finite check", json.dumps(rec))
    if not (rec["nan_equal"] and rec["posinf_equal"] and rec["argmin_equal"]
            and rec["max_rel_err"] <= HS_TOL and rec["non_finite"] == 5
            and rec["argmin_first_nodes"] == [0, 1, 1, 1]):
        raise AssertionError(f"head_select's {body} body disagrees with its "
                             f"plain version on non-finite inputs: {rec}")
    return rec


def hs_tc32_non_finite_check(shape=HS_F32_NON_FINITE) -> dict:
    """The fp32 tensor-core body on :func:`hs_lm_non_finite_case` with the
    gates ``hs_wide_check`` holds it to elsewhere, or raise: the finite
    losses against the float64 witness (``hs_witness_check``), two calls
    the same bits (NaN included), identical heads the same bits, and a
    node whose labels are all excluded (the last, whose head of +inf
    weights gives NaN logits) 0.0. ``hs_lm_non_finite_check`` holds the
    NaN and +inf places."""
    name = "head_select fp32_tensor_core non-finite"
    feats, heads, labels = hs_lm_non_finite_case(96, shape, torch.float32)

    def call(h=heads, lab=labels):
        return head_losses(feats, h, lab, body="fp32_tensor_core")

    def bits(x):
        return x.view(torch.int32)
    got, again = call(), call()
    plain = head_losses_ref(feats, heads, labels)
    witness = hs_witness(feats, heads, labels)
    fin = torch.isfinite(witness) & torch.isfinite(plain)
    rec = {"shape": list(shape), "finite_losses": int(fin.sum()),
           "witness": hs_witness_check(name, got[fin], plain[fin],
                                       witness[fin]),
           "same_bits_twice": bool(torch.equal(bits(got), bits(again)))}
    same = call(h=heads[:, :1].repeat(1, 2, 1, 1).contiguous())
    rec["identical_heads_same_bits"] = bool(torch.equal(bits(same[:, 0]),
                                                        bits(same[:, 1])))
    excluded = labels.clone()
    excluded[-1] = -1
    rec["excluded_node"] = call(lab=excluded)[-1].tolist()
    log(f"{name} check", json.dumps(rec))
    if not (rec["same_bits_twice"] and rec["identical_heads_same_bits"]
            and rec["excluded_node"] == [0.0, 0.0]):
        raise AssertionError(f"{name}: {rec}")
    return rec


def hs_library(feats, heads, labels):
    """One PyTorch product and cross-entropy for the same function (the
    yardstick; the port never calls it)."""
    n, k, d, v = heads.shape
    t = feats.shape[1]
    logits = torch.matmul(feats.float()[:, None], heads.float())
    nll = F.cross_entropy(logits.reshape(-1, v),
                          labels.long()[:, None].expand(n, k, t).reshape(-1),
                          ignore_index=-1, reduction="none").view(n, k, t)
    return nll.sum(-1) / (labels >= 0).sum(-1, keepdim=True).clamp(min=1)


def hs_bound(feats, heads, labels, tc32=False):
    """K1's bound in ms, what bounds it, its bytes and FLOPs: the products
    (2 K T D V FLOP over the tokens whose label counts) at the bf16 tensor
    cores' rate, in fp32 at the fp32 pipes' or, with ``tc32``, as three
    TF32 products at the TF32 tensor cores' (the fp32 tensor-core body);
    or the inputs read once and the output written."""
    n, k, d, v = heads.shape
    nbytes = (feats.numel() * feats.element_size()
              + heads.numel() * heads.element_size()
              + labels.numel() * 4 + n * k * 4)
    valid = int((labels >= 0).sum())              # tokens this data needs
    flops = 2 * k * valid * d * v
    peak = BF16_FLOPS if feats.dtype == torch.bfloat16 else FP32_FLOPS
    if tc32:
        flops, peak = 3 * flops, TF32_FLOPS
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, flops


def ptxas_report(source: str, kernel: str) -> dict:
    """Registers, stack and spills that ``nvcc -Xptxas -v`` reported for
    the entry functions of ``source``'s build whose names hold ``kernel``
    (from the log beside the library), with any ptxas warning about them."""
    log_path = build.library_path(source).with_suffix(".log")
    out, current = {}, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if kernel in name else None
            if current:
                out[current] = {"warnings": []}
        elif current is None:
            continue
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[current].update(stack_bytes=nums[0], spill_stores=nums[1],
                                spill_loads=nums[2])
        elif "Used" in line and "registers" in line:
            out[current]["registers"] = int(
                line.split("Used")[1].split()[0])
        elif "warning" in line.lower():
            out[current]["warnings"].append(line.strip())
    return out


def launches_of(**nonzero) -> dict:
    """Every kernel's launch count, 0 but for ``nonzero``'s, as
    ``counted`` reports them."""
    want = {fn.__name__: 0 for fn in KERNELS}
    want.update(nonzero)
    return want


@contextlib.contextmanager
def counted():
    """Every kernel's launch count set to 0 on entry; the dict yielded is
    filled with the counts of the block on exit, so a phase reads only its
    own launches."""
    for fn in KERNELS:
        fn.launches = 0
    counts = {}
    try:
        yield counts
    finally:
        counts.update({fn.__name__: fn.launches for fn in KERNELS})


def kernel_phase(rec):
    t0 = time.perf_counter()
    libs = build.build(*sorted(p.stem for p in build.CSRC.glob("*.cu")))
    rec["build_s"] = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {rec['build_s']:.1f} s")
    for name, lib in libs.items():
        report = lib.with_suffix(".log")
        if report.exists():
            log(f"nvcc {name}: " + " | ".join(
                ln.strip() for ln in report.read_text().splitlines()
                if "registers" in ln or "spill" in ln))

    checks = []
    cases = [((1,) + s, dt) for s in HS_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    for i, (shape, dtype) in enumerate(cases):
        feats, heads, labels = hs_case(*shape, dtype, seed=i)
        got = head_losses(feats, heads, labels)
        torch.cuda.synchronize()
        checks.append(hs_check("head_select", got,
                               head_losses_ref(feats, heads, labels),
                               shape=list(shape), dtype=str(dtype)))
    # the FACADE path's shape in fp32, and in bf16 (the FMA body's bf16
    # path: D 513 is off the tensor-core body's 16-byte rows)
    for extra, dtype in ((1, torch.bfloat16), (0, torch.float32)):
        feats, heads, labels = hs_main_inputs(seed=len(cases) + extra)
        feats, heads = feats.to(dtype), heads.to(dtype)
        got = head_losses(feats, heads, labels)
        torch.cuda.synchronize()
        checks.append(hs_check("head_select", got,
                               head_losses_ref(feats, heads, labels),
                               shape=list(MAIN_SHAPE), dtype=str(dtype)))
    rec["head_select_checks"] = checks
    rec["head_select_non_finite"] = hs_non_finite_check()
    rec["head_select_lm_non_finite"] = hs_lm_non_finite_check()

    feats, heads, labels = hs_main_inputs(seed=99)
    bound_ms, bound_by, nbytes, flops = hs_bound(feats, heads, labels)
    timing = {}
    for label, fn in (("ms", head_losses), ("plain_ms", head_losses_ref),
                      ("library_ms", hs_library),
                      ("ms_again", head_losses),
                      ("plain_ms_again", head_losses_ref)):
        timing[label] = graph_ms(lambda: fn(feats, heads, labels))
    t0 = time.perf_counter()
    for _ in range(100):
        head_losses(feats, heads, labels)
    torch.cuda.synchronize()
    timing["eager_call_ms"] = (time.perf_counter() - t0) * 10
    # the launch floor: one one-element in-place op per call, same timing
    one = torch.zeros(1, device="cuda")
    timing["launch_floor_ms"] = graph_ms(lambda: one.add_(1.0))
    # the reference tests' largest shape (K 5, T 128, D 128, V 1024)
    big = hs_case(1, *HS_SHAPES[2], torch.float32, seed=98)
    big_bound = hs_bound(*big)
    timing["hs_shapes_2"] = {
        "shape": [1, *HS_SHAPES[2]], "ms": graph_ms(
            lambda: head_losses(*big), calls=10),
        "library_ms": graph_ms(lambda: hs_library(*big), calls=10),
        "bound_ms": big_bound[0], "bound_by": big_bound[1]}
    rec["head_select_timing"] = dict(
        timing, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        flops=flops, shape=list(MAIN_SHAPE))
    log("head_select timing", json.dumps(rec["head_select_timing"]))
    return {"name": "head_select", "route": "cuda",
            "source": "src/repro_torch/csrc/head_select.cu",
            "replaces": "src/repro/kernels/head_select/kernel.py:62",
            "launches": None,
            "max_abs_err": checks[-1]["max_abs_err"],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timing["library_ms"],
            "lm": head_select_lm_phase(rec)}


def head_select_lm_phase(rec) -> dict:
    """K1's tensor-core body (the LM regime) against its plain version at
    the LM FACADE paths' shapes (llama3.2-1b's and rwkv6-1.6b's) and two
    ragged ones (the last node's labels all excluded: 0.0), then timed at
    both paths' shapes; returns llama's timing with rwkv's under
    ``"rwkv"``."""
    checks = []
    for i, shape in enumerate([HS_LM_SHAPE, HS_LM_RWKV] + HS_LM_RAGGED):
        feats, heads, labels = hs_lm_case(*shape, seed=i)
        labels[-1] = -1
        got = head_losses(feats, heads, labels)
        torch.cuda.synchronize()
        checks.append(hs_check("head_select lm", got,
                               head_losses_ref(feats, heads, labels),
                               shape=list(shape), dtype="bf16"))
        if not torch.equal(got[-1], torch.zeros_like(got[-1])):
            raise AssertionError(f"head_select lm: a node with every label "
                                 f"excluded gives {got[-1].tolist()}")
        del feats, heads, labels
    # identical heads, identical losses
    feats, heads, labels = hs_lm_case(2, 1, *HS_LM_SHAPE[2:], seed=7)
    got = head_losses(feats, heads.repeat(1, 2, 1, 1).contiguous(), labels)
    if not torch.equal(got[:, 0], got[:, 1]):
        raise AssertionError(f"head_select lm: identical heads give "
                             f"{got.tolist()}")
    del feats, heads, labels
    torch.cuda.empty_cache()

    t = hs_lm_timing(HS_LM_SHAPE)
    t.update(tol=HS_TOL, max_abs_err=max(c["max_abs_err"] for c in checks),
             max_rel_err=max(c["max_rel_err"] for c in checks),
             build=ptxas_report("head_select", "head_losses_lm_kernel"))
    t["rwkv"] = hs_lm_timing(HS_LM_RWKV)
    rec["head_select_lm"] = dict(t, checks=checks)
    log("head_select lm timing", json.dumps(t))
    return t


def hs_lm_timing(shape) -> dict:
    """K1 in the LM regime, its plain version and the library call timed
    on a path's inputs (every label counts: the mask is all ones), beside
    the bound."""
    feats, heads, labels = hs_lm_case(*shape, seed=99, drop=0.0)
    bound_ms, bound_by, nbytes, flops = hs_bound(feats, heads, labels)
    t = {"shape": list(shape), "dtype": "bf16", "bound_ms": bound_ms,
         "bound_by": bound_by, "bytes": nbytes, "flops": flops,
         "device_launches_per_call": 2}
    for key, fn, calls in (("ms", head_losses, 5),
                           ("plain_ms", head_losses_ref, 1),
                           ("library_ms", hs_lm_library, 2),
                           ("ms_again", head_losses, 5)):
        t[key] = graph_ms(lambda: fn(feats, heads, labels), calls=calls,
                          reps=5)
    del feats, heads, labels
    torch.cuda.empty_cache()
    return t


def hs_dispatch_shapes() -> list:
    """(n, K, T, D, V, dtype) of every K1 input this script gives the
    kernel, by its constants, and of every arch's LM FACADE step 2c (n·K 4,
    T 1024) at full width in its dtype and in fp32 and of its smoke config:
    the body depends on T > 0, D, V and the dtype alone."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = [(*MAIN_SHAPE, f32), (*MAIN_SHAPE, bf16), (8, 2, 8, 513, 10, f32),
           (*HS_RESNET8, f32), (*HS_LM_SHAPE, bf16), (*HS_LM_RWKV, bf16),
           (*HS_LM_NON_FINITE, bf16), (*HS_F32_CHECK, f32),
           (*HS_F32_EDGE, f32), (*HS_F32_NON_FINITE, f32),
           (*HS_PADDED_NON_FINITE, bf16)]
    out += [(*s, bf16) for s in HS_LM_RAGGED]
    out += [(*s, f32) for s in HS_F32_TIMED + HS_TC32_SWEEP]
    out += [(*s, bf16) for s in HS_PADDED.values()]
    out += [(1, *s, dt) for s in HS_SHAPES for dt in (f32, bf16)]
    for arch in list_archs():
        cfg, smoke = get_config(arch), get_config(arch, smoke=True)
        out += [(4, 1, 1024, cfg.d_model, cfg.vocab_size, cfg.dt),
                (4, 1, 1024, cfg.d_model, cfg.vocab_size, f32),
                (4, 1, 64, smoke.d_model, smoke.vocab_size, smoke.dt)]
    return out


def hs_dispatch_check() -> dict:
    """``hs_ops.body_for`` (the wrapper's rule) against the source's
    ``hs_body`` on :func:`hs_dispatch_shapes`, or raise; the count of
    shapes each body takes."""
    lib = hs_ops._library()
    bodies, wrong = {}, []
    for n, k, t, d, v, dtype in hs_dispatch_shapes():
        mirror = hs_ops.body_for(n, k, t, d, v, dtype)
        source = hs_ops.BODIES[lib.hs_body(n, k, t, d, v,
                                           int(dtype == torch.bfloat16))]
        bodies[mirror] = bodies.get(mirror, 0) + 1
        if mirror != source:
            wrong.append([n, k, t, d, v, str(dtype), mirror, source])
    rec = {"shapes": sum(bodies.values()), "by_body": bodies,
           "disagree": wrong}
    log("head_select dispatch", json.dumps(rec))
    if wrong:
        raise AssertionError(f"head_select: body_for and hs_body disagree "
                             f"on {wrong}")
    return rec


def hs_witness(feats, heads, labels):
    """The plain version's steps in float64 on the same inputs: the
    witness of the fp32 tensor-core body's gate."""
    n, k = heads.shape[:2]
    t = feats.shape[1]
    logits = torch.einsum("ntd,nkdv->nktv", feats.double(), heads.double())
    lse = torch.logsumexp(logits, dim=-1)
    labs = labels.long().clamp(min=0)[:, None, :, None].expand(n, k, t, 1)
    gold = torch.gather(logits, -1, labs).squeeze(-1)
    del logits
    valid = (labels >= 0)[:, None, :]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return nll.sum(-1) / valid.sum(-1).clamp(min=1)


def hs_witness_check(name, got, plain, witness) -> dict:
    """``got``'s distance from the float64 witness (each loss relative to
    max(|witness|, 1)) within ``HS_TC32_FACTOR`` times the plain fp32
    version's (the control) or within ``HS_TC32_FLOOR``, or raise."""
    def dist(x):
        return float(((x.double() - witness).abs()
                      / witness.abs().clamp(min=1)).max())
    rec = {"witness_err": dist(got), "control_err": dist(plain),
           "factor": HS_TC32_FACTOR, "floor": HS_TC32_FLOOR}
    rec["ratio"] = rec["witness_err"] / max(rec["control_err"], 1e-30)
    if not rec["witness_err"] <= max(HS_TC32_FACTOR * rec["control_err"],
                                     HS_TC32_FLOOR):
        raise AssertionError(f"{name}: farther from the float64 witness "
                             f"than the plain version allows: {rec}")
    return rec


def hs_wide_check(name, shape, dtype, seed, body, forced=False) -> dict:
    """K1 at ``shape`` (drawn on the card as ``hs_lm_case``, the last
    node's labels all excluded: 0.0) against its plain version at
    ``HS_TOL`` with equal argmins, on ``body``: the dispatch rule's, or
    forced where ``forced``; identical heads identical losses. The fp32
    tensor-core body also against the float64 witness
    (``hs_witness_check``), and two calls the same bits."""
    rule = hs_ops.body_for(*shape, dtype)
    if not forced and rule != body:
        raise AssertionError(f"{name}: {shape} {dtype} takes {rule}, not "
                             f"{body}")
    kw = {"body": body} if forced else {}
    feats, heads, labels = hs_lm_case(*shape, seed=seed, dtype=dtype)
    labels[-1] = -1
    got = head_losses(feats, heads, labels, **kw)
    torch.cuda.synchronize()
    plain = head_losses_ref(feats, heads, labels)
    c = hs_check(name, got, plain, shape=list(shape), dtype=str(dtype),
                 body=body, rule=rule)
    if not torch.equal(got[-1], torch.zeros_like(got[-1])):
        raise AssertionError(f"{name}: a node with every label excluded "
                             f"gives {got[-1].tolist()}")
    if body == "fp32_tensor_core":
        c["witness"] = hs_witness_check(name, got, plain,
                                        hs_witness(feats, heads, labels))
        again = head_losses(feats, heads, labels, **kw)
        c["same_bits_twice"] = bool(torch.equal(got, again))
        log(f"{name} witness", json.dumps(c["witness"]))
        if not c["same_bits_twice"]:
            raise AssertionError(f"{name}: two calls give {got.tolist()} "
                                 f"and {again.tolist()}")
    # identical heads, identical losses
    got = head_losses(feats, heads[:, :1].repeat(1, 2, 1, 1).contiguous(),
                      labels, **kw)
    if not torch.equal(got[:, 0], got[:, 1]):
        raise AssertionError(f"{name}: identical heads give {got.tolist()}")
    del feats, heads, labels, got, plain
    torch.cuda.empty_cache()
    return c


def hs_wide_timing(shape, dtype, calls=2, reps=3, fma=False) -> dict:
    """K1 (its rule's body), its plain version and the library call timed
    on a path's inputs (every label counts), beside the bound; in fp32 also
    both fp32 bodies forced, in turns (tensor cores, SIMT, SIMT, tensor
    cores), beside both bounds (``hs_bound``: the fp32 pipes' and three
    TF32 products'); with ``fma`` the FMA body forced on the same inputs
    too; in bf16 on a ragged V, also the copy of the heads into rows of V8
    alone (``hs_pad_rows``)."""
    feats, heads, labels = hs_lm_case(*shape, seed=99, drop=0.0,
                                      dtype=dtype)
    body = hs_ops.body_for(*shape, dtype)
    bound_ms, bound_by, nbytes, flops = hs_bound(
        feats, heads, labels, tc32=body == "fp32_tensor_core")
    library = hs_library if dtype == torch.float32 else hs_lm_library
    t = {"shape": list(shape), "dtype": str(dtype), "body": body,
         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
         "flops": flops}
    timed = [("ms", lambda: head_losses(feats, heads, labels)),
             ("plain_ms", lambda: head_losses_ref(feats, heads, labels)),
             ("library_ms", lambda: library(feats, heads, labels)),
             ("ms_again", lambda: head_losses(feats, heads, labels))]
    if dtype == torch.float32:
        for tc32 in (False, True):
            key = "bound_tf32" if tc32 else "bound_fp32"
            t[key + "_ms"], t[key + "_by"] = hs_bound(feats, heads, labels,
                                                       tc32=tc32)[:2]
        for key, forced in (("tc_ms", "fp32_tensor_core"),
                            ("simt_ms", "fp32_tiled"),
                            ("simt_ms_again", "fp32_tiled"),
                            ("tc_ms_again", "fp32_tensor_core")):
            timed.append((key, lambda forced=forced: head_losses(
                feats, heads, labels, body=forced)))
    if fma:
        timed.append(("fma_ms", lambda: head_losses(feats, heads, labels,
                                                    body="fma")))
    for key, fn in timed:
        t[key] = graph_ms(fn, calls=calls, reps=reps)
    n, k, d, v = heads.shape
    if body == "tensor_core" and v % 8:
        lib = hs_ops._library()
        rows, v8 = n * k * d, -(-v // 8) * 8
        dst = torch.empty((rows, v8), dtype=heads.dtype, device="cuda")

        def copy():
            rc = lib.hs_pad_rows(heads.data_ptr(), dst.data_ptr(), rows, v,
                                 v8, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"hs_pad_rows returned {rc}")
        t["copy_ms"] = graph_ms(copy, calls=calls, reps=reps)
        t["copy_share"] = t["copy_ms"] / t["ms"]
        t["copy_bytes"] = 2 * heads.numel() * heads.element_size()
        del dst
    del feats, heads, labels
    torch.cuda.empty_cache()
    log("head_select wide timing", json.dumps(t))
    return t


def head_select_wide_phase(rec) -> list:
    """K1's fp32 bodies and its tensor-core body on a ragged V, on the
    card: the dispatch rule against the source's; both fp32 bodies, the
    SIMT one and the tensor cores' (3xTF32), forced and held against the
    plain version (``HS_TOL``, equal argmins, a node with every label
    excluded 0.0, identical heads identical; the tensor cores' also against
    the float64 witness, ``hs_witness_check``, and two calls the same bits)
    at ``HS_SHAPES`` (fp32), ``HS_F32_EDGE``, ``HS_F32_CHECK`` and
    ``HS_F32_TIMED``, and the tensor-core body at ``HS_PADDED``'s hymba and
    whisper shapes by the rule; on non-finite inputs
    (``HS_F32_NON_FINITE`` for both fp32 bodies, the tensor cores' with
    every gate above, ``HS_PADDED_NON_FINITE``);
    then timed beside their bounds and library calls: the two fp32 bodies
    in turns and the FMA body at ``HS_SHAPES`` and ``HS_F32_EDGE``, the
    two fp32 bodies in turns at ``HS_TC32_SWEEP`` (the thresholds'
    readings), the two fp32 bodies in turns at the LM shapes
    (``HS_F32_CHECK``, ``HS_F32_TIMED``: the FMA body takes seconds
    there), the padded calls with their copy apart. Returns the three
    entries of the ``kernels`` line (launches filled in by the LM
    rounds)."""
    t0 = time.perf_counter()
    out = {"dispatch": hs_dispatch_check(), "checks": []}
    f32, bf16 = torch.float32, torch.bfloat16
    f32_shapes = ([(1, *s) for s in HS_SHAPES]
                  + [HS_F32_EDGE, HS_F32_CHECK] + HS_F32_TIMED)
    for body in F32_BODIES:
        for i, shape in enumerate(f32_shapes):
            out["checks"].append(hs_wide_check(f"head_select {body}", shape,
                                               f32, 300 + i, body,
                                               forced=True))
    for i, shape in enumerate(HS_PADDED.values()):
        out["checks"].append(hs_wide_check("head_select padded", shape,
                                           bf16, 310 + i, "tensor_core"))
    out["non_finite"] = [hs_lm_non_finite_check(HS_F32_NON_FINITE, f32,
                                                body=body)
                         for body in F32_BODIES]
    out["non_finite"].append(hs_lm_non_finite_check(HS_PADDED_NON_FINITE,
                                                    bf16))
    out["non_finite_tc32"] = hs_tc32_non_finite_check()
    out["threshold"] = [hs_wide_timing((1, *s), f32, calls=10, reps=5,
                                       fma=True)
                        for s in HS_SHAPES + [HS_F32_EDGE[1:]]]
    out["threshold"] += [hs_wide_timing(s, f32, calls=10, reps=5)
                         for s in HS_TC32_SWEEP]
    out["fp32"] = [hs_wide_timing(s, f32)
                   for s in [HS_F32_CHECK] + HS_F32_TIMED]
    out["padded"] = {name: hs_wide_timing(s, bf16, calls=5, reps=5)
                     for name, s in HS_PADDED.items()}
    out["phase_s"] = time.perf_counter() - t0
    rec["head_select_wide"] = out
    log(f"head_select wide phase: {out['phase_s']:.1f} s")
    base = {"route": "cuda", "source": "src/repro_torch/csrc/head_select.cu",
            "replaces": "src/repro/kernels/head_select/kernel.py:62",
            "launches": None}
    # each fp32 body's entry at the fp32 llama round's step 2c, forced
    # (its time, and its bound: the fp32 pipes' or three TF32 products');
    # the padded path's at hymba's
    main_f32 = next(t for t in out["fp32"]
                    if t["shape"] == list(HS_F32_TIMED[1]))
    entries = []
    for body, name, key, bound in (
            ("fp32_tiled", "head_select_fp32_tiled", "simt_ms",
             "bound_fp32"),
            ("fp32_tensor_core", "head_select_fp32_tensor_core", "tc_ms",
             "bound_tf32")):
        checks = [c for c in out["checks"] if c["body"] == body]
        entries.append(dict(
            base, name=name, body=body,
            max_abs_err=max(c["max_abs_err"] for c in checks),
            ms=main_f32[key], plain_ms=main_f32["plain_ms"],
            bound_ms=main_f32[bound + "_ms"],
            bound_by=main_f32[bound + "_by"],
            library_ms=main_f32["library_ms"], shape=main_f32["shape"],
            shapes=[{k: t[k] for k in ("shape", key, key + "_again",
                                       bound + "_ms", "library_ms",
                                       "plain_ms")}
                    for t in out["fp32"] + out["threshold"]]))
    entries[1]["witness"] = [dict(c["witness"], shape=c["shape"])
                             for c in out["checks"] if "witness" in c]
    hymba = out["padded"]["hymba"]
    pad_checks = [c for c in out["checks"] if c["body"] == "tensor_core"]
    entries.append(dict(
        base, name="head_select_tensor_core_padded", body="tensor_core",
        max_abs_err=max(c["max_abs_err"] for c in pad_checks),
        **{key: hymba[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        shape=hymba["shape"], copy_ms=hymba["copy_ms"],
        copy_share=hymba["copy_share"], whisper=out["padded"]["whisper"]))
    return entries


def head_select_lm_split() -> dict:
    """The two launches of a K1 call in the LM regime apart, the tile
    kernel and the merge, by ``torch.profiler`` at the path's shape: the
    mean of the launches it recorded (None where it records no device
    time: not measured). Run after every timed phase: the profiler's
    tracing may slow the host for the rest of the process."""
    feats, heads, labels = hs_lm_case(*HS_LM_SHAPE, seed=99, drop=0.0)
    prof = device_profile(lambda: [head_losses(feats, heads, labels)
                                   for _ in range(3)])
    split = {key: next((secs * 1e3 / n for name, secs, n in
                        prof["top_kernels_s"] if part in name), None)
             for key, part in (("body_ms", "lm_kernel"),
                               ("merge_ms", "lm_merge"))}
    split["launches_recorded"] = {name[:40]: n for name, _, n in
                                  prof["top_kernels_s"]}
    log("head_select lm split", json.dumps(split))
    return split


def head_select_lm_split_apart() -> dict:
    """``head_select_lm_split`` in a process of its own. Late in this
    script's process the profiler has recorded no device event of that
    call (also before the segment engine's phases were added), while a
    fresh process records both launches, also after smoke serving, the
    small inputs or CPU work alone."""
    return run_apart("head_select_lm_split")


def run_apart(name: str) -> dict:
    """``chip_smoke.<name>()`` in a process of its own; its JSON result
    (the last line of its output that starts with ``{``)."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            f"print(json.dumps(chip_smoke.{name}()))")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=600,
                          check=True)
    return json.loads(next(line for line in reversed(
        proc.stdout.splitlines()) if line.startswith("{")))


def round_bytes(cfg, algo: str, n: int, degree: int) -> float:
    """n * degree pushes a round, held as float32: FACADE pushes its core,
    one head and a 4-byte cluster id, DEPRL its core alone, EL, D-PSGD
    and DAC the whole model."""
    binding = make_binding(cfg)
    params = binding.init(torch.Generator().manual_seed(0))
    core, head = split.split_params(params, binding.head_keys)
    payload = {"facade": split.tree_size_bytes(core)
               + split.tree_size_bytes(head) + 4,
               "deprl": split.tree_size_bytes(core)}.get(
        algo, split.tree_size_bytes(params))
    return float(np.float32(n * degree * payload))


def paper_lenet_data(rec):
    """The paper-scale GN-LeNet data of the main path and the engine
    phase: SynthSpec(10, 32, 32, 64, seed 3), 32 nodes in clusters 24:8
    rotated rot0/rot180."""
    spec = SynthSpec(n_classes=10, image_size=32, samples_per_class=32,
                     test_per_class=64, seed=3)
    t0 = time.perf_counter()
    ds = make_clustered_data(spec, (24, 8), ("rot0", "rot180"))
    rec["data_s"] = time.perf_counter() - t0
    return ds


def main_path_phase(rec, ds):
    cfg = lenet()
    n = ds.n_nodes
    results = {}
    with counted() as counts:
        for algo in ALGOS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_experiment(algo, cfg, ds, rounds=ROUNDS,
                                 eval_every=EVAL_EVERY, device="cuda",
                                 **PAPER)
            torch.cuda.synchronize()
            results[algo] = (res, time.perf_counter() - t0)

    out = {"launches": counts}
    if counts != launches_of(head_losses=FACADE_LAUNCHES):
        raise AssertionError(f"kernel launches {counts} in {ROUNDS} rounds "
                             f"of each of {ALGOS} (want one head select per "
                             f"FACADE round and per warm-up call before "
                             f"its capture, none elsewhere)")
    for algo, (res, wall) in results.items():
        leaves = tree_leaves(res.models)
        if not all(bool(torch.isfinite(l).all()) for l in leaves):
            raise AssertionError(f"{algo}: non-finite parameters")
        if leaves[0].shape[0] != n or leaves[0].device.type != "cuda":
            raise AssertionError(f"{algo}: models not [n, ...] on the card")
        want = round_bytes(cfg, algo, n, PAPER["degree"])
        per_round = np.diff([0.0] + res.comm.bytes)
        if len(per_round) != ROUNDS or not (per_round == want).all():
            raise AssertionError(f"{algo}: bytes per round {per_round} != "
                                 f"{want}")
        accs = res.final_acc
        if not (len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
                and np.isfinite(res.best_fair_acc())):
            raise AssertionError(f"{algo}: bad accuracies {accs}")
        out[algo] = {"wall_s": wall, "rounds_per_s": ROUNDS / wall,
                     "final_acc": accs, "fair_acc": res.fair_acc[-1][1],
                     "dp": res.dp, "eo": res.eo,
                     "bytes_per_round": want}
        if algo == "facade":
            out[algo]["final_cluster_id"] = \
                res.cluster_history[-1][1].tolist()
        log(f"{algo}: {ROUNDS} rounds in {wall:.2f} s "
            f"({ROUNDS / wall:.2f} rounds/s), acc per cluster {accs}, "
            f"fair_acc {res.fair_acc[-1][1]:.4f}, bytes/round {want:.0f}")
    rec["main_path"] = out
    return counts["head_losses"]


def run_diff(a, b) -> dict:
    """How two runs of one configuration differ: whether they are the same
    run bit for bit (every parameter leaf, the accuracy, fairness, bytes,
    simulated seconds, eval and cluster histories), and the largest
    parameter difference."""
    la, lb = tree_leaves(a.models), tree_leaves(b.models)
    leaves_equal = all(torch.equal(x, y) for x, y in zip(la, lb))
    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(la, lb))
    same_cid = len(a.cluster_history) == len(b.cluster_history) and all(
        r1 == r2 and np.array_equal(c1, c2) for (r1, c1), (r2, c2) in
        zip(a.cluster_history, b.cluster_history))
    histories = (a.acc_per_cluster == b.acc_per_cluster
                 and a.fair_acc == b.fair_acc and (a.dp, a.eo) == (b.dp, b.eo)
                 and a.comm.rounds == b.comm.rounds
                 and a.comm.bytes == b.comm.bytes
                 and a.comm.seconds == b.comm.seconds
                 and a.comm.evaled == b.comm.evaled and same_cid)
    return {"equal": leaves_equal and histories,
            "leaves_equal": leaves_equal, "histories_equal": histories,
            "max_abs_param_diff": diff}


def paper_spec(algo, cfg, ds, warmup_rounds: int = 0) -> EngineSpec:
    """The cache key ``run_experiment`` builds for a PAPER run of
    ``algo`` on the card."""
    return EngineSpec(
        algo=algo, cfg=cfg, n=ds.n_nodes, k=PAPER["k"],
        degree=PAPER["degree"], local_steps=PAPER["local_steps"],
        batch_size=PAPER["batch_size"], lr=PAPER["lr"],
        warmup_rounds=warmup_rounds,
        device=torch.device("cuda", torch.cuda.current_device()))


def timed_run(algo, cfg, ds, **kw) -> tuple:
    """``run_experiment`` between two synchronises: (result, host
    seconds, peak allocated bytes, peak reserved bytes). The peaks start
    from the memory held before the run (the allocator's cache released;
    cuBLAS's workspaces are kept, since the cache's captured rounds use
    theirs); a CUDA graph's intermediates come from its pool, which the
    allocated peak does not see and the reserved one does."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_experiment(algo, cfg, ds, device="cuda", **kw)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def break_even(capture_s: float, engine_round_s: float,
               loop_round_s: float):
    """The run length from which the engine's captures (warm-up included)
    have paid for themselves against the loop: ``capture_s`` over what a
    round saves, or None where the engine's round is no faster."""
    saved = loop_round_s - engine_round_s
    return capture_s / saved if saved > 0 else None


def engine_phase(rec, ds):
    """The segment engine at paper scale on GN-LeNet (the main path's
    data), for the five algorithms:

    - parity: the loop twice (whether it equals itself) and the engine
      once, ROUNDS rounds with an eval every EVAL_EVERY and FACADE's first
      PARITY_WARMUP rounds in its warmup phase (both of its rounds
      captured): the engine must be the loop's run bit for bit; K1's
      launches are the rounds plus the warm-up calls before each capture;
    - steady state: ENGINE_ROUNDS rounds with an eval every
      ENGINE_EVAL_EVERY through one EngineCache, seed 0 (which captures)
      then seed 1 timed, and the loop timed on the same seed-1 run (which
      the engine's must equal); rounds per second of both, peak memory,
      capture seconds per graph, compile_count after each run, and the
      run length from which the captures have paid for themselves
      (``break_even``)."""
    cfg = lenet()
    out = {"parity": {}, "steady": {}}
    for algo in ALGOS:
        warm = PARITY_WARMUP if algo == "facade" else 0
        kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY,
                  warmup_rounds=warm, device="cuda")
        loop_a = run_experiment(algo, cfg, ds, engine=False, **kw)
        loop_b = run_experiment(algo, cfg, ds, engine=False, **kw)
        with counted() as counts:
            eng = run_experiment(algo, cfg, ds, **kw)
            torch.cuda.synchronize()
        graphs = 2 if warm else 1
        want = ROUNDS + WARMUP_ROUNDS * graphs if algo == "facade" else 0
        got = out["parity"][algo] = {
            "loop_vs_loop": run_diff(loop_a, loop_b),
            "engine_vs_loop": run_diff(eng, loop_a), "launches": counts}
        log(f"engine parity {algo}: {json.dumps(got)}")
        if counts["head_losses"] != want:
            raise AssertionError(f"engine {algo}: {counts} K1 launches, "
                                 f"want {want}")
        if not (got["loop_vs_loop"]["equal"]
                and got["engine_vs_loop"]["equal"]):
            raise AssertionError(f"engine {algo}: not the loop's run bit "
                                 f"for bit: {json.dumps(got)}")
    cache = EngineCache()
    for algo in ALGOS:
        kw = dict(PAPER, rounds=ENGINE_ROUNDS, eval_every=ENGINE_EVAL_EVERY)
        run_experiment(algo, cfg, ds, cache=cache, device="cuda", **kw)
        after_first = cache.compile_count
        with counted() as counts:
            eng, eng_s, eng_peak, eng_res = timed_run(
                algo, cfg, ds, cache=cache, **dict(kw, seed=1))
        after_second = cache.compile_count
        loop, loop_s, loop_peak, loop_res = timed_run(
            algo, cfg, ds, engine=False, **dict(kw, seed=1))
        entry = cache.entry(paper_spec(algo, cfg, ds))
        got = out["steady"][algo] = {
            "engine_s": eng_s, "loop_s": loop_s,
            "engine_rounds_per_s": ENGINE_ROUNDS / eng_s,
            "loop_rounds_per_s": ENGINE_ROUNDS / loop_s,
            "speedup": loop_s / eng_s,
            "engine_peak_allocated": eng_peak,
            "engine_peak_reserved": eng_res,
            "loop_peak_allocated": loop_peak,
            "loop_peak_reserved": loop_res,
            "capture_s": entry.engine.capture_s,
            "break_even_rounds": break_even(
                sum(entry.engine.capture_s), eng_s / ENGINE_ROUNDS,
                loop_s / ENGINE_ROUNDS),
            "compile_count_after_first": after_first,
            "compile_count_after_second": after_second,
            "launches": counts, "vs_loop": run_diff(eng, loop)}
        log(f"engine steady {algo}: {json.dumps(got)}")
        want = ENGINE_ROUNDS if algo == "facade" else 0
        if not (after_second == after_first and len(entry.engine.capture_s)
                == 1 and counts["head_losses"] == want
                and got["vs_loop"]["equal"]):
            raise AssertionError(f"engine {algo}: steady-state run "
                                 f"{json.dumps(got)}")
    out["cache"] = cache.stats()
    rec["engine"] = out
    del cache
    torch.cuda.empty_cache()
    return out


def engine_profile_phase(rec, ds) -> dict:
    """Where a replayed FACADE round's time goes: one ENGINE_EVAL_EVERY-
    round run through a fresh EngineCache (K1's count must be its rounds
    plus the warm-up calls before the capture), then one replayed segment
    of as many rounds under ``torch.profiler``, which must hold exactly
    one K1 execution a round by kernel name and by counter. Run after the
    last timed phase, which its profiler session would slow."""
    cfg, seg, cache = lenet(), ENGINE_EVAL_EVERY, EngineCache()
    with counted() as counts:
        run_experiment("facade", cfg, ds, cache=cache, device="cuda",
                       rounds=seg, eval_every=seg, **PAPER)
        torch.cuda.synchronize()
    if counts["head_losses"] != seg + WARMUP_ROUNDS:
        raise AssertionError(f"{counts} K1 launches in a {seg}-round run, "
                             f"want {seg + WARMUP_ROUNDS}")
    entry = cache.entry(paper_spec("facade", cfg, ds))
    draws = TorchDraws(2)
    carry = entry.engine.init_carry(entry.setup(draws).state)
    train_x, train_y = entry.engine.place_data(ds)
    with counted() as counts:
        prof = device_profile(lambda: entry.engine.run_segment(
            carry, 0, seg, train_x, train_y, draws), kernels=(K1_KERNEL,))
    k1_events, k1_s = prof["kernels"][K1_KERNEL]
    prof["k1_us_per_round"] = 1e6 * k1_s / max(k1_events, 1)
    prof["launches"] = counts
    log(f"engine FACADE segment profile: {json.dumps(prof)}")
    if not (k1_events == seg and counts["head_losses"] == seg):
        raise AssertionError(f"a replayed {seg}-round FACADE segment ran "
                             f"{k1_events} K1 kernels by name and "
                             f"{counts['head_losses']} by counter, want "
                             f"{seg}")
    rec["engine"]["facade_segment_profile"] = prof
    del cache, entry, carry, train_x, train_y
    torch.cuda.empty_cache()
    return prof


def driver_kw(algo) -> dict:
    """The driver phases' run settings: DRIVER_ROUNDS rounds with an eval
    every DRIVER_EVAL_EVERY, FACADE with PARITY_WARMUP warmup rounds."""
    return dict(PAPER, rounds=DRIVER_ROUNDS, eval_every=DRIVER_EVAL_EVERY,
                warmup_rounds=PARITY_WARMUP if algo == "facade" else 0)


def pipeline_phase(rec, ds) -> dict:
    """The pipelined driver against the serialized one at paper scale on
    GN-LeNet, for the five algorithms, through one EngineCache a
    algorithm: seed 0 serialized (which captures) then pipelined, seed 1
    serialized then pipelined, timed (``timed_run``). Each pair must be
    one run bit for bit (every parameter leaf and history, the cluster
    ids and the bytes); each pipelined run must have overlapped at least
    one segment (its successor's end event not yet complete when its
    host work ended: ``SegmentEngine.overlapped``); a pipelined FACADE
    run replays with no capture, so K1's count is its rounds. Then a
    ``target_acc`` of 0.0 on FACADE, which the first eval (round 10)
    reaches, serialized and pipelined: the same run, K1 10 serialized and
    10 + 10 pipelined (the segment dispatched past the hit ran)."""
    cfg = lenet()
    out, launches = {}, 0
    for algo in ALGOS:
        kw = driver_kw(algo)
        cache = EngineCache()
        eng = cache.entry(paper_spec(algo, cfg, ds,
                                     kw["warmup_rounds"])).engine
        got = out[algo] = {}
        ser = run_experiment(algo, cfg, ds, cache=cache, device="cuda",
                             **kw)
        for seed in (0, 1):
            before = eng.overlapped
            with counted() as counts:
                if seed:
                    ser, ser_s, _, _ = timed_run(algo, cfg, ds, cache=cache,
                                                 **dict(kw, seed=seed))
                pip, pip_s, _, _ = timed_run(algo, cfg, ds, cache=cache,
                                             pipeline=True,
                                             **dict(kw, seed=seed))
            got[f"seed{seed}"] = {
                "vs_serialized": run_diff(pip, ser),
                "overlapped_segments": eng.overlapped - before,
                "segments": len(segment_plan(DRIVER_ROUNDS,
                                             DRIVER_EVAL_EVERY,
                                             kw["warmup_rounds"])),
                "launches": counts}
            if seed:
                got.update(serialized_s=ser_s, pipelined_s=pip_s,
                           serialized_rounds_per_s=DRIVER_ROUNDS / ser_s,
                           pipelined_rounds_per_s=DRIVER_ROUNDS / pip_s)
        log(f"pipeline {algo}: {json.dumps(got)}")
        k1 = {"seed0": DRIVER_ROUNDS, "seed1": 2 * DRIVER_ROUNDS}
        for seed in ("seed0", "seed1"):
            g = got[seed]
            want = k1[seed] if algo == "facade" else 0
            if not (g["vs_serialized"]["equal"]
                    and g["overlapped_segments"] > 0
                    and g["launches"]["head_losses"] == want):
                raise AssertionError(f"pipelined {algo} {seed}: "
                                     f"{json.dumps(g)} (K1 want {want})")
            launches += g["launches"]["head_losses"]
        if algo == "facade":
            kt = dict(kw, target_acc=0.0, device="cuda")
            with counted() as c_ser:
                ser = run_experiment(algo, cfg, ds, cache=cache, **kt)
                torch.cuda.synchronize()
            with counted() as c_pip:
                pip = run_experiment(algo, cfg, ds, cache=cache,
                                     pipeline=True, **kt)
                torch.cuda.synchronize()
            stop = ser.comm.rounds[-1]
            got["target_acc"] = {
                "stop_round": stop, "vs_serialized": run_diff(pip, ser),
                "launches_serialized": c_ser["head_losses"],
                "launches_pipelined": c_pip["head_losses"]}
            log(f"pipeline target_acc: {json.dumps(got['target_acc'])}")
            if not (stop == DRIVER_EVAL_EVERY
                    and got["target_acc"]["vs_serialized"]["equal"]
                    and c_ser["head_losses"] == stop
                    and c_pip["head_losses"] == stop + DRIVER_EVAL_EVERY):
                raise AssertionError(f"target_acc under pipelining: "
                                     f"{json.dumps(got['target_acc'])}")
            launches += c_ser["head_losses"] + c_pip["head_losses"]
        del cache, eng
    rec["pipeline"] = out
    return launches


class Killed(Exception):
    """The kill of ``resume_phase``: raised by a patched dispatch."""


def killed_at_third_dispatch(fn):
    """Run ``fn`` with ``SegmentEngine.dispatch_segment`` raising at its
    third call, then restore the method."""
    orig = SegmentEngine.dispatch_segment
    calls = []

    def killer(self, *a, **k):
        if len(calls) == 2:
            raise Killed
        calls.append(1)
        return orig(self, *a, **k)

    SegmentEngine.dispatch_segment = killer
    try:
        fn()
    except Killed:
        return
    finally:
        SegmentEngine.dispatch_segment = orig
    raise AssertionError("the run was not killed")


def resume_phase(rec, ds) -> int:
    """Kill and resume at paper scale on GN-LeNet, FACADE and DAC (the
    Gumbel stream): an uninterrupted serialized run with a checkpoint;
    the same run pipelined with a checkpoint, killed at its third segment
    dispatch, then resumed by the same call through a fresh EngineCache
    (as a new process would). The resumed run must be the uninterrupted
    one bit for bit and the two final checkpoints equal (carry, draws
    state, meta); a call with another seed on the checkpoint must be
    refused; K1's count in the resumed run must be its replayed rounds
    plus one warm-up call a round it captures."""
    cfg, out, launches = lenet(), {}, 0
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    for algo in ("facade", "dac"):
        kw = driver_kw(algo)
        whole, ck = (str(CKPT_DIR / f"{algo}-{name}.npz")
                     for name in ("whole", "killed"))
        for path in (whole, ck):
            if pathlib.Path(path).exists():
                pathlib.Path(path).unlink()
        kw["device"] = "cuda"
        want = run_experiment(algo, cfg, ds, ckpt=whole, **kw)
        killed_at_third_dispatch(lambda: run_experiment(
            algo, cfg, ds, ckpt=ck, pipeline=True, **kw))
        next_segment = ckpt_io.load(ck)[1]["next_segment"]
        rest = segment_plan(DRIVER_ROUNDS, DRIVER_EVAL_EVERY,
                            kw["warmup_rounds"])[next_segment:]
        graphs = len({seg.warmup for seg in rest})
        with counted() as counts:
            t0 = time.perf_counter()
            res = run_experiment(algo, cfg, ds, ckpt=ck, pipeline=True,
                                 cache=EngineCache(), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (pa, ma), (pb, mb) = ckpt_io.load(whole), ckpt_io.load(ck)
        same_ckpt = ma == mb and all(
            torch.equal(x, y) for name in ("carry", "draws")
            for x, y in zip(tree_leaves(pa[name]), tree_leaves(pb[name]),
                            strict=True))
        try:
            run_experiment(algo, cfg, ds, ckpt=ck, **dict(kw, seed=1))
            refused = False
        except ValueError as e:
            refused = "fingerprint mismatch" in str(e)
        replayed = sum(seg.length for seg in rest)
        k1 = replayed + WARMUP_ROUNDS * graphs if algo == "facade" else 0
        got = out[algo] = {
            "resumed_at_round": rest[0].start, "resume_s": wall,
            "vs_uninterrupted": run_diff(res, want),
            "final_checkpoints_equal": same_ckpt, "mismatch_refused": refused,
            "launches": counts, "k1_want": k1}
        log(f"resume {algo}: {json.dumps(got)}")
        if not (got["vs_uninterrupted"]["equal"] and same_ckpt and refused
                and counts["head_losses"] == k1 and rest[0].start > 0):
            raise AssertionError(f"kill and resume {algo}: "
                                 f"{json.dumps(got)}")
        launches += counts["head_losses"]
    rec["resume"] = out
    return launches


def sweep_phase(rec, ds) -> int:
    """``run_sweep`` at paper scale on GN-LeNet: cells FACADE and EL over
    seeds 0, 1, 2, DRIVER_ROUNDS rounds each, through one EngineCache with
    a ``ckpt_dir`` under ``build/``. Each run is timed (the sweep's
    ``run_experiment`` wrapped); the cache's ``compile_count`` must stay
    flat after each cell's first seed; each seed's result must equal a
    fresh ``run_experiment`` call's bit for bit; a rerun must skip both
    cells (no run). Rounds per second on the warm seeds (1 and 2, their
    checkpoint writes included)."""
    cfg = lenet()
    sweep_dir = CKPT_DIR / "sweep"
    if sweep_dir.exists():
        for path in sweep_dir.iterdir():
            path.unlink()
    cells = [SweepCell(name=algo, algo=algo, cfg=cfg, dataset=ds,
                       rounds=DRIVER_ROUNDS,
                       kwargs={**{k: v for k, v in driver_kw(algo).items()
                                  if k not in ("seed", "rounds")},
                               "device": "cuda"})
             for algo in ("facade", "el")]
    cache, runs = EngineCache(), []
    orig = sweep_driver.run_experiment

    def timed(algo, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(algo, *a, **kw)
        torch.cuda.synchronize()
        runs.append({"algo": algo, "seed": kw["seed"],
                     "wall_s": time.perf_counter() - t0,
                     "compile_count": kw["cache"].compile_count})
        return res

    sweep_driver.run_experiment = timed
    try:
        with counted() as counts:
            sweep = run_sweep(cells, SWEEP_SEEDS, cache=cache,
                              ckpt_dir=sweep_dir)
        n_runs = len(runs)
        t0 = time.perf_counter()
        again = run_sweep(cells, SWEEP_SEEDS, cache=cache,
                          ckpt_dir=sweep_dir)
        rerun_s = time.perf_counter() - t0
    finally:
        sweep_driver.run_experiment = orig
    fresh_equal = {
        c.cell.name: [run_diff(res, run_experiment(
            c.cell.algo, cfg, ds, rounds=DRIVER_ROUNDS, seed=seed,
            **c.cell.kwargs))["equal"]
            for seed, res in zip(SWEEP_SEEDS, c.results, strict=True)]
        for c in sweep.cells}
    flat = {algo: len({r["compile_count"] for r in runs
                       if r["algo"] == algo}) == 1
            for algo in ("facade", "el")}
    out = rec["sweep"] = {
        "runs": runs, "wall_s": sweep.wall_s,
        "warm_rounds_per_s": {
            algo: [DRIVER_ROUNDS / r["wall_s"] for r in runs
                   if r["algo"] == algo and r["seed"] != SWEEP_SEEDS[0]]
            for algo in ("facade", "el")},
        "compile_count_flat_after_first_seed": flat,
        "fresh_equal": fresh_equal,
        "rerun": {"skipped": [c.skipped for c in again.cells],
                  "runs": len(runs) - n_runs, "wall_s": rerun_s},
        "errors": [c.error for c in sweep.cells],
        "cache": cache.stats(), "launches": counts}
    log(f"sweep: {json.dumps(out)}")
    k1 = len(SWEEP_SEEDS) * DRIVER_ROUNDS + WARMUP_ROUNDS * 2
    if not (all(flat.values()) and all(all(v) for v in fresh_equal.values())
            and out["rerun"]["skipped"] == [True, True]
            and out["rerun"]["runs"] == 0
            and not any(out["errors"])
            and counts["head_losses"] == k1):
        raise AssertionError(f"sweep: {json.dumps(out)} (K1 want {k1})")
    del cache, sweep, again
    torch.cuda.empty_cache()
    return counts["head_losses"]


def payload_bytes(cfg, algo: str) -> int:
    """What one node pushes to one neighbour, as ``round_bytes`` counts
    it (FACADE: core, one head and a 4-byte cluster id; DEPRL: the core;
    the others: the model)."""
    binding = make_binding(cfg)
    params = binding.init(torch.Generator().manual_seed(0))
    core, head = split.split_params(params, binding.head_keys)
    return {"facade": split.tree_size_bytes(core)
            + split.tree_size_bytes(head) + 4,
            "deprl": split.tree_size_bytes(core)}.get(
        algo, split.tree_size_bytes(params))


def net_run_check(algo, res, payload: int, n: int) -> dict:
    """A netsim run's accounting, recounted on the host: each round's
    drained bytes (the differences of the cumulative column, exact in
    float64) is the float32 product of a whole number of delivering edges
    and the payload (the edges read back as the nearest whole number of
    payloads), at most ``n * degree`` of them (DAC's symmetrised
    graph: at most ``2 * n * degree``), and the cumulative column is their
    running sum; each round's simulated seconds is finite and not
    negative, the run's total positive."""
    per_round = np.diff([0.0] + res.comm.bytes)
    edges = np.rint(per_round / payload)
    cap = PAPER["degree"] * n * (2 if algo == "dac" else 1)
    recount = [float(np.float32(np.float32(e) * np.float32(payload)))
               for e in edges]
    secs = np.diff([0.0] + res.comm.seconds)
    ok = (bool((edges >= 0).all() and (edges <= cap).all())
          and recount == per_round.tolist()
          and np.cumsum(per_round).tolist() == res.comm.bytes
          and bool(np.isfinite(secs).all() and (secs >= 0).all())
          and res.comm.seconds[-1] > 0
          and all(np.isfinite(a) for a in res.final_acc))
    return {"ok": ok, "edges_per_round": edges.tolist(),
            "seconds_per_round": secs.tolist(),
            "total_gb": res.comm.total_gb,
            "total_hours": res.comm.total_hours}


def netsim_phase(rec, ds) -> int:
    """Network simulation at paper scale on GN-LeNet (the main path's
    data), ROUNDS rounds with an eval every EVAL_EVERY, FACADE's heads as
    ``PAPER`` gives them:

    - the five algorithms under NET_ALL and FACADE and EL under NET_TWO:
      the engine (a fresh capture a run: K1 its rounds plus one warm-up
      call for FACADE) against the loop, bit for bit, simulated seconds
      included; each run's bytes and seconds recounted on the host
      (``net_run_check``);
    - ``preset("ideal")`` against ``net=None`` for FACADE and EL: the same
      trajectory (parameters, accuracies, cluster ids);
    - ``edge-churn`` with ``async_gossip=True, max_staleness=0`` against
      the synchronous ``edge-churn`` run of the same algorithm, for the
      five, bit for bit, bytes and seconds included;
    - FACADE's engine rate under ``net=None`` and each of the nine
      presets: NET_RATE_ROUNDS rounds of seed 1 through the cache whose
      seed-0 run captured (``timed_run``: host clock, peak memory), the
      capture seconds, K1 one a replayed round.
    Returns K1's launches in the phase."""
    cfg, n = lenet(), ds.n_nodes
    out = {"parity": {}, "ideal": {}, "async0": {}, "rates": {}}
    payloads = {algo: payload_bytes(cfg, algo) for algo in ALGOS}
    kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY, device="cuda")
    launches, sync_runs = 0, {}
    cells = [(p, a) for p in NET_ALL for a in ALGOS] + \
        [(p, a) for p in NET_TWO for a in ("facade", "el")]
    for preset, algo in cells:
        net = NetworkConfig.preset(preset)
        loop = run_experiment(algo, cfg, ds, engine=False, net=net, **kw)
        with counted() as counts:
            eng = run_experiment(algo, cfg, ds, net=net, **kw)
            torch.cuda.synchronize()
        want = ROUNDS + WARMUP_ROUNDS if algo == "facade" else 0
        got = out["parity"][f"{preset}/{algo}"] = {
            "engine_vs_loop": run_diff(eng, loop), "launches": counts,
            "check": net_run_check(algo, eng, payloads[algo], n)}
        log(f"netsim {preset} {algo}: {json.dumps(got)}")
        if not (got["engine_vs_loop"]["equal"] and got["check"]["ok"]
                and counts["head_losses"] == want):
            raise AssertionError(f"netsim {preset} {algo}: "
                                 f"{json.dumps(got)} (K1 want {want})")
        launches += counts["head_losses"]
        if preset == "edge-churn":
            sync_runs[algo] = eng
    for algo in ("facade", "el"):
        with counted() as counts:
            base = run_experiment(algo, cfg, ds, **kw)
            ideal = run_experiment(algo, cfg, ds,
                                   net=NetworkConfig.preset("ideal"), **kw)
        diff = run_diff(base, ideal)
        got = out["ideal"][algo] = {
            "leaves_equal": diff["leaves_equal"],
            "accs_equal": base.acc_per_cluster == ideal.acc_per_cluster,
            "cluster_ids_equal": all(
                np.array_equal(c1, c2) for (_, c1), (_, c2) in
                zip(base.cluster_history, ideal.cluster_history,
                    strict=True)),
            "ideal_seconds": ideal.comm.seconds[-1], "launches": counts}
        log(f"netsim ideal vs none {algo}: {json.dumps(got)}")
        if not (got["leaves_equal"] and got["accs_equal"]
                and got["cluster_ids_equal"]):
            raise AssertionError(f"netsim ideal {algo}: {json.dumps(got)}")
        launches += counts["head_losses"]
    zero = NetworkConfig.preset("edge-churn", async_gossip=True,
                                max_staleness=0)
    for algo in ALGOS:
        with counted() as counts:
            res = run_experiment(algo, cfg, ds, net=zero, **kw)
        got = out["async0"][algo] = dict(run_diff(res, sync_runs[algo]),
                                         launches=counts)
        log(f"netsim async max_staleness=0 vs sync {algo}: "
            f"{json.dumps(got)}")
        if not got["equal"]:
            raise AssertionError(f"netsim async0 {algo}: {json.dumps(got)}")
        launches += counts["head_losses"]
    rate_kw = dict(PAPER, rounds=NET_RATE_ROUNDS,
                   eval_every=NET_RATE_ROUNDS)
    for name in ("none",) + tuple(PRESETS):
        net = None if name == "none" else NetworkConfig.preset(name)
        cache = EngineCache()
        with counted() as counts:
            run_experiment("facade", cfg, ds, cache=cache, device="cuda",
                           net=net, **rate_kw)
            res, wall, peak, reserved = timed_run(
                "facade", cfg, ds, cache=cache, net=net,
                **dict(rate_kw, seed=1))
        spec = dataclasses.replace(paper_spec("facade", cfg, ds), net=net)
        if spec not in cache:
            raise AssertionError(f"netsim rate {name}: the run's cache "
                                 f"entry is not {spec}")
        got = out["rates"][name] = {
            "rounds_per_s": NET_RATE_ROUNDS / wall, "wall_s": wall,
            "capture_s": cache.entry(spec).engine.capture_s,
            "peak_allocated": peak, "peak_reserved": reserved,
            "sim_seconds": res.comm.seconds[-1],
            "gb": res.comm.total_gb, "launches": counts}
        log(f"netsim rate {name}: {json.dumps(got)}")
        want = 2 * NET_RATE_ROUNDS + WARMUP_ROUNDS
        if counts["head_losses"] != want:
            raise AssertionError(f"netsim rate {name}: {counts} K1, want "
                                 f"{want}")
        launches += counts["head_losses"]
        del cache
    ideal_rate = out["rates"]["none"]["rounds_per_s"]
    for name, got in out["rates"].items():
        got["vs_ideal_medium"] = got["rounds_per_s"] / ideal_rate
    log("netsim rounds/s " + json.dumps(
        {k: round(v["rounds_per_s"], 2) for k, v in out["rates"].items()}))
    out["launches"] = launches
    rec["netsim"] = out
    torch.cuda.empty_cache()
    return launches


def faults_phase(rec, ds) -> int:
    """Node faults at paper scale on GN-LeNet (the main path's data),
    ROUNDS rounds with an eval every EVAL_EVERY under ``edge-v2``:

    - the five algorithms under FAULTS_NAN, FACADE and DAC under
      FAULTS_RESET, FACADE under FAULTS_NOISE: the engine (a fresh capture
      a run: K1 its rounds plus one warm-up call for FACADE) against the
      loop, bit for bit, bytes and simulated seconds included, each run's
      bytes recounted on the host (``net_run_check``), its parameters
      finite;
    - the off-switches: ``FaultConfig()`` and ``FaultConfig(robust=
      False)`` against the fault-free ``edge-v2`` run, FACADE and EL, bit
      for bit;
    - a NaN storm (FAULTS_STORM) on FACADE: the guarded run's parameters
      finite (a gate), and whether the unguarded run's go non-finite
      (recorded);
    - kill and resume: FACADE under FAULTS_RESET with an eval every
      FAULTS_RESUME_EVAL_EVERY (four segments), pipelined with a
      checkpoint under ``build/``, killed at its third segment dispatch
      and resumed by the same call through a fresh cache, against the
      uninterrupted serialized run;
    - FACADE's steady engine rate (NET_RATE_ROUNDS rounds of seed 1
      through the cache whose seed-0 run captured, ``timed_run``) under
      ``edge-v2`` with no faults, FAULTS_NAN and FAULTS_NOISE, with the
      capture seconds and peak memory, and the host seconds of drawing
      those rounds' network and fault draws (``NetSchedule.round``, the
      payload noise among them).
    Returns K1's launches in the phase."""
    cfg, n = lenet(), ds.n_nodes
    out = {"parity": {}, "off": {}, "storm": {}, "resume": {}, "rates": {}}
    payloads = {algo: payload_bytes(cfg, algo) for algo in ALGOS}
    kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY, device="cuda")
    launches = 0
    cells = ([("nan", FAULTS_NAN, a) for a in ALGOS]
             + [("reset", FAULTS_RESET, a) for a in ("facade", "dac")]
             + [("noise", FAULTS_NOISE, "facade")])
    for name, faults, algo in cells:
        net = NetworkConfig.preset("edge-v2", faults=faults)
        loop = run_experiment(algo, cfg, ds, engine=False, net=net, **kw)
        with counted() as counts:
            eng = run_experiment(algo, cfg, ds, net=net, **kw)
            torch.cuda.synchronize()
        want = ROUNDS + WARMUP_ROUNDS if algo == "facade" else 0
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree_leaves(eng.models))
        got = out["parity"][f"{name}/{algo}"] = {
            "engine_vs_loop": run_diff(eng, loop), "launches": counts,
            "finite": finite,
            "check": net_run_check(algo, eng, payloads[algo], n)}
        log(f"faults {name} {algo}: {json.dumps(got)}")
        if not (got["engine_vs_loop"]["equal"] and got["check"]["ok"]
                and finite and counts["head_losses"] == want):
            raise AssertionError(f"faults {name} {algo}: "
                                 f"{json.dumps(got)} (K1 want {want})")
        launches += counts["head_losses"]
    for algo in ("facade", "el"):
        with counted() as counts:
            base = run_experiment(algo, cfg, ds,
                                  net=NetworkConfig.preset("edge-v2"), **kw)
            got = out["off"][algo] = {
                label: run_diff(run_experiment(
                    algo, cfg, ds, net=NetworkConfig.preset(
                        "edge-v2", faults=fc), **kw), base)
                for label, fc in (("FaultConfig()", FaultConfig()),
                                  ("FaultConfig(robust=False)",
                                   FaultConfig(robust=False)))}
        got["launches"] = counts
        log(f"faults off-switches {algo}: {json.dumps(got)}")
        if not all(v["equal"] for k, v in got.items() if k != "launches"):
            raise AssertionError(f"faults off-switch {algo}: "
                                 f"{json.dumps(got)}")
        launches += counts["head_losses"]
    with counted() as counts:
        for label, fc in (("guarded", FAULTS_STORM),
                          ("unguarded", dataclasses.replace(
                              FAULTS_STORM, robust=False))):
            res = run_experiment("facade", cfg, ds, net=NetworkConfig.preset(
                "edge-v2", faults=fc), **kw)
            out["storm"][label] = {
                "params_finite": all(bool(torch.isfinite(l).all())
                                     for l in tree_leaves(res.models)),
                "final_acc": res.final_acc,
                "final_cluster_id": res.cluster_history[-1][1].tolist()}
    out["storm"]["launches"] = counts
    log(f"faults NaN storm: {json.dumps(out['storm'])}")
    if not out["storm"]["guarded"]["params_finite"]:
        raise AssertionError(f"faults NaN storm: the guarded run's "
                             f"parameters are not finite: {out['storm']}")
    launches += counts["head_losses"]
    out["resume"] = faults_resume(cfg, ds)
    launches += out["resume"]["launches"]["head_losses"]
    rate_kw = dict(PAPER, rounds=NET_RATE_ROUNDS,
                   eval_every=NET_RATE_ROUNDS)
    for name, faults in (("none", None), ("nan", FAULTS_NAN),
                         ("noise", FAULTS_NOISE)):
        net = NetworkConfig.preset("edge-v2", faults=faults)
        cache = EngineCache()
        with counted() as counts:
            run_experiment("facade", cfg, ds, cache=cache, device="cuda",
                           net=net, **rate_kw)
            res, wall, peak, reserved = timed_run(
                "facade", cfg, ds, cache=cache, net=net,
                **dict(rate_kw, seed=1))
        spec = dataclasses.replace(paper_spec("facade", cfg, ds), net=net)
        entry = cache.entry(spec)
        draws = TorchDraws(1)
        sched = NetSchedule(net, n, draws, noise=noise_spec(
            net, entry.program.sent_of(entry.setup(draws).state),
            entry.program.sent_lead))
        t0 = time.perf_counter()
        for rnd in range(NET_RATE_ROUNDS):
            sched.round(rnd)
        draw_s = time.perf_counter() - t0
        got = out["rates"][name] = {
            "rounds_per_s": NET_RATE_ROUNDS / wall, "wall_s": wall,
            "capture_s": entry.engine.capture_s,
            "peak_allocated": peak, "peak_reserved": reserved,
            "net_draw_s_per_round": draw_s / NET_RATE_ROUNDS,
            "launches": counts}
        log(f"faults rate {name}: {json.dumps(got)}")
        want = 2 * NET_RATE_ROUNDS + WARMUP_ROUNDS
        if counts["head_losses"] != want:
            raise AssertionError(f"faults rate {name}: {counts} K1, want "
                                 f"{want}")
        launches += counts["head_losses"]
        del cache, entry
    for got in out["rates"].values():
        got["vs_fault_free"] = (got["rounds_per_s"]
                                / out["rates"]["none"]["rounds_per_s"])
    out["launches"] = launches
    rec["faults"] = out
    torch.cuda.empty_cache()
    return launches


def faults_resume(cfg, ds) -> dict:
    """FACADE under FAULTS_RESET (its round-0 copy of the state in the
    checkpoint), pipelined with a checkpoint, killed at the third segment
    dispatch and resumed through a fresh cache, against the uninterrupted
    serialized run: the same run bit for bit and equal final
    checkpoints."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    kw = dict(PAPER, rounds=ROUNDS, eval_every=FAULTS_RESUME_EVAL_EVERY,
              device="cuda",
              net=NetworkConfig.preset("edge-v2", faults=FAULTS_RESET))
    whole, ck = (str(CKPT_DIR / f"faults-{name}.npz")
                 for name in ("whole", "killed"))
    for path in (whole, ck):
        if pathlib.Path(path).exists():
            pathlib.Path(path).unlink()
    want = run_experiment("facade", cfg, ds, ckpt=whole, **kw)
    killed_at_third_dispatch(lambda: run_experiment(
        "facade", cfg, ds, ckpt=ck, pipeline=True, **kw))
    next_segment = ckpt_io.load(ck)[1]["next_segment"]
    with counted() as counts:
        res = run_experiment("facade", cfg, ds, ckpt=ck, pipeline=True,
                             cache=EngineCache(), **kw)
        torch.cuda.synchronize()
    (pa, ma), (pb, mb) = ckpt_io.load(whole), ckpt_io.load(ck)
    same_ckpt = ma == mb and all(
        torch.equal(x, y) for name in ("carry", "net", "draws")
        for x, y in zip(tree_leaves(pa[name]), tree_leaves(pb[name]),
                        strict=True))
    rest = segment_plan(ROUNDS, FAULTS_RESUME_EVAL_EVERY)[next_segment:]
    k1 = sum(seg.length for seg in rest) + WARMUP_ROUNDS
    got = {"resumed_at_round": rest[0].start,
           "vs_uninterrupted": run_diff(res, want),
           "final_checkpoints_equal": same_ckpt,
           "checkpoint_holds_init": sorted(pa["net"]["fault"]),
           "launches": counts, "k1_want": k1}
    log(f"faults resume: {json.dumps(got)}")
    if not (got["vs_uninterrupted"]["equal"] and same_ckpt
            and got["checkpoint_holds_init"] == ["down", "init"]
            and counts["head_losses"] == k1 and rest[0].start > 0):
        raise AssertionError(f"faults kill and resume: {json.dumps(got)}")
    return got


def topo_bytes_check(algo, res, payload: int, n: int, net) -> dict:
    """An adaptive run's accounting, recounted on the host: under ``net``
    as ``net_run_check``; without it each round's drained bytes are the
    drawn graph's directed edges (a whole number, more than 0, at most
    ``n * degree``; DAC's symmetrised picks twice that) times the payload
    as float32, their running sum the cumulative column, and the
    simulated seconds 0."""
    if net is not None:
        return net_run_check(algo, res, payload, n)
    per_round = np.diff([0.0] + res.comm.bytes)
    edges = np.rint(per_round / payload)
    cap = PAPER["degree"] * n * (2 if algo == "dac" else 1)
    recount = [float(np.float32(np.float32(e) * np.float32(payload)))
               for e in edges]
    ok = (bool((edges > 0).all() and (edges <= cap).all())
          and recount == per_round.tolist()
          and np.cumsum(per_round).tolist() == res.comm.bytes
          and res.comm.seconds == [0.0] * len(per_round)
          and all(np.isfinite(a) for a in res.final_acc))
    return {"ok": ok, "edges_per_round": edges.tolist(),
            "total_gb": res.comm.total_gb}


def topo_phase(rec, ds) -> int:
    """The adaptive topology policy at paper scale on GN-LeNet (the main
    path's data), ROUNDS rounds with an eval every EVAL_EVERY:

    - the five algorithms under TOPO_REL and ``core-edge``; FACADE and EL
      under TOPO_BW on ``core-edge``, TOPO_REL on ``bursty-wan`` and
      ``edge-v2``, and TOPO_REL without ``net``: the engine (a fresh
      capture a run: K1 its rounds plus one warm-up call for FACADE)
      against the loop, bit for bit, simulated seconds included, each
      run's bytes recounted on the host (``topo_bytes_check``), its
      parameters finite;
    - the off-switch: ``TopoConfig()`` against ``topo=None`` under
      ``core-edge`` for the five, bit for bit;
    - the floor on the card: ``inclusion_stats`` of TOPO_REL on
      ``core-edge`` at 32 nodes, degree 4, TOPO_FLOOR_ROUNDS rounds
      (the port's counter draws): every node's inclusion and
      participation at least 0.25 - 3 sigma, symmetric 0/1 graphs within
      the edge budget;
    - kill and resume: FACADE under TOPO_REL on ``core-edge`` with an
      eval every FAULTS_RESUME_EVAL_EVERY (four segments), pipelined with
      a checkpoint under ``build/``, killed at its third segment dispatch
      and resumed through a fresh cache, against the uninterrupted
      serialized run;
    - FACADE's steady engine rate (NET_RATE_ROUNDS rounds of seed 1
      through the cache whose seed-0 run captured, ``timed_run``) under
      ``core-edge`` made comm-bound (``compute_s_per_step=0.002``) with
      no policy, TOPO_REL and TOPO_BW: capture seconds, peak memory, the
      simulated seconds and bytes of the run.
    Returns K1's launches in the phase."""
    cfg, n = lenet(), ds.n_nodes
    out = {"parity": {}, "off": {}, "floor": {}, "resume": {}, "rates": {}}
    payloads = {algo: payload_bytes(cfg, algo) for algo in ALGOS}
    kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY, device="cuda")
    launches = 0
    cells = ([("reliability", TOPO_REL, "core-edge", a) for a in ALGOS]
             + [(p, t, net, a) for p, t, net in (
                 ("bandwidth", TOPO_BW, "core-edge"),
                 ("reliability", TOPO_REL, "bursty-wan"),
                 ("reliability", TOPO_REL, "edge-v2"),
                 ("reliability", TOPO_REL, None))
                for a in ("facade", "el")])
    for policy, topo, preset, algo in cells:
        net = None if preset is None else NetworkConfig.preset(preset)
        loop = run_experiment(algo, cfg, ds, engine=False, net=net,
                              topo=topo, **kw)
        with counted() as counts:
            eng = run_experiment(algo, cfg, ds, net=net, topo=topo, **kw)
            torch.cuda.synchronize()
        want = ROUNDS + WARMUP_ROUNDS if algo == "facade" else 0
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree_leaves(eng.models))
        got = out["parity"][f"{policy}/{preset}/{algo}"] = {
            "engine_vs_loop": run_diff(eng, loop), "launches": counts,
            "finite": finite,
            "check": topo_bytes_check(algo, eng, payloads[algo], n, net)}
        log(f"topo {policy} {preset} {algo}: {json.dumps(got)}")
        if not (got["engine_vs_loop"]["equal"] and got["check"]["ok"]
                and finite and counts["head_losses"] == want):
            raise AssertionError(f"topo {policy} {preset} {algo}: "
                                 f"{json.dumps(got)} (K1 want {want})")
        launches += counts["head_losses"]
    net = NetworkConfig.preset("core-edge")
    for algo in ALGOS:
        with counted() as counts:
            got = out["off"][algo] = run_diff(
                run_experiment(algo, cfg, ds, net=net, topo=TopoConfig(),
                               **kw),
                run_experiment(algo, cfg, ds, net=net, **kw))
        got["launches"] = counts
        log(f"topo off-switch {algo}: {json.dumps(got)}")
        if not got["equal"]:
            raise AssertionError(f"topo off-switch {algo}: "
                                 f"{json.dumps(got)}")
        launches += counts["head_losses"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = inclusion_stats(TOPO_REL, net, n=n, rounds=TOPO_FLOOR_ROUNDS,
                         degree=PAPER["degree"], device="cuda")
    floor = TOPO_REL.min_inclusion
    bar = floor - 3 * np.sqrt(floor * (1 - floor) / TOPO_FLOOR_ROUNDS)
    got = out["floor"] = {
        "wall_s": time.perf_counter() - t0, "bar": bar,
        "min_inclusion": float(st["inclusion"].min()),
        "min_participation": float(st["participation"].min()),
        "mean_participation": float(st["participation"].mean()),
        "mean_degree": st["mean_degree"], "max_degree": st["max_degree"],
        "mean_edges": st["mean_edges"], "edge_budget": st["edge_budget"],
        "symmetric": st["symmetric"], "binary": st["binary"]}
    log(f"topo floor: {json.dumps(got)}")
    if not (got["min_inclusion"] >= bar and got["min_participation"] >= bar
            and st["symmetric"] and st["binary"]
            and st["mean_edges"] <= st["edge_budget"]):
        raise AssertionError(f"topo floor: {json.dumps(got)}")
    out["resume"] = topo_resume(cfg, ds)
    launches += out["resume"]["launches"]["head_losses"]
    rate_kw = dict(PAPER, rounds=NET_RATE_ROUNDS,
                   eval_every=NET_RATE_ROUNDS)
    net = NetworkConfig.preset("core-edge", compute_s_per_step=0.002)
    for name, topo in (("none", None), ("reliability", TOPO_REL),
                       ("bandwidth", TOPO_BW)):
        cache = EngineCache()
        with counted() as counts:
            run_experiment("facade", cfg, ds, cache=cache, device="cuda",
                           net=net, topo=topo, **rate_kw)
            res, wall, peak, reserved = timed_run(
                "facade", cfg, ds, cache=cache, net=net, topo=topo,
                **dict(rate_kw, seed=1))
        spec = dataclasses.replace(paper_spec("facade", cfg, ds), net=net,
                                   topo=topo)
        if spec not in cache:
            raise AssertionError(f"topo rate {name}: the run's cache "
                                 f"entry is not {spec}")
        got = out["rates"][name] = {
            "rounds_per_s": NET_RATE_ROUNDS / wall, "wall_s": wall,
            "capture_s": cache.entry(spec).engine.capture_s,
            "peak_allocated": peak, "peak_reserved": reserved,
            "sim_seconds": res.comm.seconds[-1], "gb": res.comm.total_gb,
            "final_acc": res.final_acc, "launches": counts}
        log(f"topo rate {name}: {json.dumps(got)}")
        want = 2 * NET_RATE_ROUNDS + WARMUP_ROUNDS
        if counts["head_losses"] != want:
            raise AssertionError(f"topo rate {name}: {counts} K1, want "
                                 f"{want}")
        launches += counts["head_losses"]
        del cache
    base = out["rates"]["none"]
    for got in out["rates"].values():
        got["vs_no_policy"] = got["rounds_per_s"] / base["rounds_per_s"]
        got["peak_allocated_vs_no_policy"] = (got["peak_allocated"]
                                              - base["peak_allocated"])
    log("topo rounds/s " + json.dumps(
        {k: round(v["rounds_per_s"], 2) for k, v in out["rates"].items()}))
    out["launches"] = launches
    rec["topo"] = out
    torch.cuda.empty_cache()
    return launches


def topo_resume(cfg, ds) -> dict:
    """FACADE under TOPO_REL on ``core-edge`` (the EWMAs in the
    checkpoint), pipelined with a checkpoint, killed at the third segment
    dispatch and resumed through a fresh cache, against the uninterrupted
    serialized run: the same run bit for bit and equal final
    checkpoints."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    kw = dict(PAPER, rounds=ROUNDS, eval_every=FAULTS_RESUME_EVAL_EVERY,
              device="cuda", net=NetworkConfig.preset("core-edge"),
              topo=TOPO_REL)
    whole, ck = (str(CKPT_DIR / f"topo-{name}.npz")
                 for name in ("whole", "killed"))
    for path in (whole, ck):
        if pathlib.Path(path).exists():
            pathlib.Path(path).unlink()
    want = run_experiment("facade", cfg, ds, ckpt=whole, **kw)
    killed_at_third_dispatch(lambda: run_experiment(
        "facade", cfg, ds, ckpt=ck, pipeline=True, **kw))
    next_segment = ckpt_io.load(ck)[1]["next_segment"]
    with counted() as counts:
        res = run_experiment("facade", cfg, ds, ckpt=ck, pipeline=True,
                             cache=EngineCache(), **kw)
        torch.cuda.synchronize()
    (pa, ma), (pb, mb) = ckpt_io.load(whole), ckpt_io.load(ck)
    same_ckpt = ma == mb and all(
        torch.equal(x, y) for name in ("carry", "net", "topo", "draws")
        for x, y in zip(tree_leaves(pa[name]), tree_leaves(pb[name]),
                        strict=True))
    rest = segment_plan(ROUNDS, FAULTS_RESUME_EVAL_EVERY)[next_segment:]
    k1 = sum(seg.length for seg in rest) + WARMUP_ROUNDS
    got = {"resumed_at_round": rest[0].start,
           "vs_uninterrupted": run_diff(res, want),
           "final_checkpoints_equal": same_ckpt,
           "checkpoint_holds": sorted(pa["topo"]),
           "launches": counts, "k1_want": k1}
    log(f"topo resume: {json.dumps(got)}")
    if not (got["vs_uninterrupted"]["equal"] and same_ckpt
            and got["checkpoint_holds"] == ["delivery", "link_s"]
            and counts["head_losses"] == k1 and rest[0].start > 0):
        raise AssertionError(f"topo kill and resume: {json.dumps(got)}")
    return got


def obs_frames_check(algo, obs, res, payload: int, n: int) -> dict:
    """A run's frames, recounted on the host against its drained bytes:
    ROUNDS rounds numbered from 1; each round's bytes (the differences of
    the cumulative column) are the float32 product of its frame's
    ``delivered_edges`` (a whole number, at most ``n * degree``, DAC's
    symmetrised graph twice that) and the payload, and within 1e-6 of its
    frame's ``bytes_core + bytes_edge`` (both tiers carrying some); each
    ``stale_hist`` sums to ``n``; the other counts are whole numbers and
    the norms finite."""
    t = obs.run_frames_table()
    per_round = np.diff([0.0] + res.comm.bytes)
    edges = t["delivered_edges"]
    cap = PAPER["degree"] * n * (2 if algo == "dac" else 1)
    recount = [float(np.float32(e) * np.float32(payload)) for e in edges]
    split_sum = (t["bytes_core"].astype(np.float64)
                 + t["bytes_edge"].astype(np.float64))
    whole = all(np.array_equal(t[f], np.rint(t[f])) for f in (
        "cluster_switches", "delivered_edges", "stale_hist", "crashed",
        "corrupted", "quarantined"))
    ok = (t["round"].tolist() == list(range(1, ROUNDS + 1))
          and recount == per_round.tolist()
          and bool((edges <= cap).all() and (edges > 0).all())
          and bool(np.allclose(split_sum, per_round, rtol=1e-6, atol=0))
          and bool((t["bytes_edge"] > 0).any()
                   and (t["bytes_core"] > 0).any())
          and np.array_equal(t["stale_hist"].sum(1), np.full(ROUNDS, n))
          and whole and bool(np.isfinite(t["update_norm"]).all()
                             and np.isfinite(t["param_norm"]).all()))
    return {"ok": ok, "edges_per_round": edges.tolist(),
            "switches_per_round": t["cluster_switches"].tolist(),
            "inclusion_per_round": t["inclusion"].tolist(),
            "update_norm_per_round": t["update_norm"].tolist()}


def frames_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[f], b[f]) for f in a)


def obs_phase(rec, ds) -> int:
    """Run telemetry at paper scale on GN-LeNet (the main path's data),
    ROUNDS rounds with an eval every EVAL_EVERY:

    - the five algorithms under ``core-edge`` (link tiers, so the byte
      split has both sides) with ``Obs(ObsConfig(), jsonl=..., out_dir=...)``
      under ``build/obs``: the observed engine (a fresh capture a run: K1
      its rounds plus one warm-up call for FACADE) against the unobserved
      engine and the observed loop, the same run bit for bit and the same
      frames bit for bit; each run's frames recounted against its bytes
      (``obs_frames_check``); the health verdict ``ok``; the manifest on
      disk and the JSONL's metrics and eval records;
    - FACADE under ``edge-v2`` (async stale gossip): engine frames against
      the loop's, ``stale_hist`` summing to n with stale nodes seen;
    - an unguarded NaN storm (FAULTS_STORM, ``robust=False``, ideal
      medium) on FACADE: the verdict ``fail`` with ``nonfinite``; a report
      rendered from its manifest and JSONL (``obs.report``);
    - FACADE's steady engine rate with ``ObsConfig()`` against
      ``obs=None``: one ``EngineCache`` each, whose seed-0 run captures,
      then OBS_RATE_REPS runs of NET_RATE_ROUNDS rounds of seed 1 each, in
      turns (the order reversed every other turn; ``timed_run``), medians
      and quartiles as ``tools/topo_rate.py`` takes them, peak memory and
      capture seconds.
    Returns K1's launches in the phase."""
    cfg, n = lenet(), ds.n_nodes
    out = {"parity": {}, "stale": {}, "storm": {}, "rates": {}}
    obs_dir = ROOT / "build" / "obs"
    if obs_dir.exists():
        shutil.rmtree(obs_dir)
    payloads = {algo: payload_bytes(cfg, algo) for algo in ALGOS}
    kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY, device="cuda")
    launches = 0
    net = NetworkConfig.preset("core-edge")
    for algo in ALGOS:
        plain = run_experiment(algo, cfg, ds, net=net, **kw)
        loop_obs = Obs(ObsConfig())
        loop = run_experiment(algo, cfg, ds, engine=False, net=net,
                              obs=loop_obs, **kw)
        obs = Obs(ObsConfig(), jsonl=obs_dir / f"{algo}.jsonl",
                  out_dir=obs_dir)
        with counted() as counts:
            eng = run_experiment(algo, cfg, ds, net=net, obs=obs, **kw)
            torch.cuda.synchronize()
        obs.sink.close()
        want = ROUNDS + WARMUP_ROUNDS if algo == "facade" else 0
        recs = read_jsonl(obs_dir / f"{algo}.jsonl")
        health = obs.manifests[-1].health
        got = out["parity"][algo] = {
            "observed_vs_unobserved": run_diff(eng, plain),
            "loop_vs_unobserved": run_diff(loop, plain),
            "frames_engine_vs_loop": frames_equal(
                obs.frames_table(), loop_obs.frames_table()),
            "check": obs_frames_check(algo, obs, eng, payloads[algo], n),
            "verdict": health["verdict"], "launches": counts,
            "manifest_on_disk": (obs_dir
                                 / f"manifest_{algo}-seed0.json").exists(),
            "jsonl_records": {t: sum(r["type"] == t for r in recs)
                              for t in ("span", "event", "metrics",
                                        "eval")},
            "spans": obs.tracer.rollup()["spans"]}
        log(f"obs {algo}: {json.dumps(got)}")
        if not (got["observed_vs_unobserved"]["equal"]
                and got["loop_vs_unobserved"]["equal"]
                and got["frames_engine_vs_loop"] and got["check"]["ok"]
                and got["verdict"] == "ok" and got["manifest_on_disk"]
                and got["jsonl_records"]["eval"] == ROUNDS // EVAL_EVERY
                and got["jsonl_records"]["metrics"] == ROUNDS // EVAL_EVERY
                and counts["head_losses"] == want):
            raise AssertionError(f"obs {algo}: {json.dumps(got)} (K1 want "
                                 f"{want})")
        launches += counts["head_losses"]
    v2 = NetworkConfig.preset("edge-v2")
    loop_obs, obs = Obs(ObsConfig()), Obs(ObsConfig())
    run_experiment("facade", cfg, ds, engine=False, net=v2, obs=loop_obs,
                   **kw)
    with counted() as counts:
        run_experiment("facade", cfg, ds, net=v2, obs=obs, **kw)
        torch.cuda.synchronize()
    hist = obs.frames_table()["stale_hist"]
    got = out["stale"] = {
        "frames_engine_vs_loop": frames_equal(obs.frames_table(),
                                              loop_obs.frames_table()),
        "stale_hist": hist.tolist(), "launches": counts}
    log(f"obs edge-v2 facade: {json.dumps(got)}")
    if not (got["frames_engine_vs_loop"]
            and np.array_equal(hist.sum(1), np.full(ROUNDS, n))
            and hist[:, 1:].sum() > 0):
        raise AssertionError(f"obs edge-v2: {json.dumps(got)}")
    launches += counts["head_losses"]
    storm = NetworkConfig.preset("ideal", faults=dataclasses.replace(
        FAULTS_STORM, robust=False))
    obs = Obs(ObsConfig(), jsonl=obs_dir / "storm.jsonl", out_dir=obs_dir)
    with counted() as counts:
        run_experiment("facade", cfg, ds, net=storm, obs=obs,
                       **dict(kw, seed=2))
        torch.cuda.synchronize()
    obs.sink.close()
    report, md = build_report(obs_dir / "manifest_facade-seed2.json")
    health = obs.manifests[-1].health
    got = out["storm"] = {
        "verdict": health["verdict"],
        "rules": sorted({i["rule"] for i in health["issues"]}),
        "issues": health["issues"], "report_evals": report["n_evals"],
        "report_lines": md.count("\n"), "launches": counts}
    log(f"obs unguarded NaN storm: {json.dumps(got)}")
    if not (got["verdict"] == "fail" and "nonfinite" in got["rules"]
            and "**verdict: fail**" in md
            and report["n_evals"] == ROUNDS // EVAL_EVERY):
        raise AssertionError(f"obs NaN storm: {json.dumps(got)}")
    launches += counts["head_losses"]
    rate_kw = dict(PAPER, rounds=NET_RATE_ROUNDS,
                   eval_every=NET_RATE_ROUNDS)
    configs = {"none": None, "obs": ObsConfig()}
    caches = {name: EngineCache() for name in configs}
    runs = {name: [] for name in configs}
    with counted() as counts:
        for name, ocfg in configs.items():
            run_experiment("facade", cfg, ds, cache=caches[name],
                           device="cuda",
                           obs=None if ocfg is None else Obs(ocfg),
                           **rate_kw)
        for rep in range(OBS_RATE_REPS):
            order = list(configs) if rep % 2 == 0 else list(configs)[::-1]
            for name in order:
                ocfg = configs[name]
                res, wall, peak, reserved = timed_run(
                    "facade", cfg, ds, cache=caches[name],
                    obs=None if ocfg is None else Obs(ocfg),
                    **dict(rate_kw, seed=1))
                runs[name].append({"rounds_per_s": NET_RATE_ROUNDS / wall,
                                   "peak_allocated": peak,
                                   "peak_reserved": reserved})
    for name, ocfg in configs.items():
        rates = [r["rounds_per_s"] for r in runs[name]]
        q1, med, q3 = np.percentile(rates, [25, 50, 75])
        spec = dataclasses.replace(paper_spec("facade", cfg, ds), obs=ocfg)
        if spec not in caches[name]:
            raise AssertionError(f"obs rate {name}: the run's cache entry "
                                 f"is not {spec}")
        out["rates"][name] = {
            "median": med, "q1": q1, "q3": q3, "rates": rates,
            "peak_allocated": max(r["peak_allocated"] for r in runs[name]),
            "peak_reserved": max(r["peak_reserved"] for r in runs[name]),
            "capture_s": caches[name].entry(spec).engine.capture_s}
    base = out["rates"]["none"]
    for got in out["rates"].values():
        got["median_vs_none"] = got["median"] / base["median"]
        got["peak_allocated_vs_none"] = (got["peak_allocated"]
                                         - base["peak_allocated"])
    want = 2 * (1 + OBS_RATE_REPS) * NET_RATE_ROUNDS + 2 * WARMUP_ROUNDS
    out["rates"]["launches"] = counts
    log(f"obs rate: {json.dumps(out['rates'])}")
    if counts["head_losses"] != want:
        raise AssertionError(f"obs rate: {counts} K1, want {want}")
    launches += counts["head_losses"]
    del caches
    out["launches"] = launches
    rec["obs"] = out
    torch.cuda.empty_cache()
    return launches


def mesh_phase(rec, ds) -> int:
    """The node mesh on the driver's one card at paper scale on GN-LeNet
    (the main path's data), ROUNDS rounds with an eval every EVAL_EVERY:

    - the five algorithms with ``mesh=(1,)`` against ``mesh=None``,
      without a medium and under ``edge-v2`` with ``MESH_FAULTS`` and
      ``Obs(ObsConfig())``: the same run bit for bit (``run_diff``) and
      the same frames; K1 ``FACADE_LAUNCHES`` in FACADE's meshed run (one
      a replayed round, inside the captured round beside its all-gather,
      and its warm-up call), none elsewhere;
    - FACADE's steady rate with ``mesh=(1,)`` and ``mesh=None``: one
      ``EngineCache`` each, whose seed-0 run captures, then
      MESH_RATE_REPS runs of NET_RATE_ROUNDS rounds of seed 1 each, in
      turns (``timed_run``), medians.
    The one-rank process group ``mesh=(1,)`` started is destroyed at the
    end. Returns K1's launches in the phase."""
    t0 = time.perf_counter()
    cfg = lenet()
    kw = dict(PAPER, rounds=ROUNDS, eval_every=EVAL_EVERY, device="cuda")
    full = NetworkConfig.preset("edge-v2", faults=MESH_FAULTS)
    out = {"parity": {}, "rates": {}}
    launches = 0
    for algo in ALGOS:
        for variant in ("plain", "full"):
            extra = {} if variant == "plain" else {"net": full}
            obs_a = obs_b = None
            if variant == "full":
                obs_a, obs_b = Obs(ObsConfig()), Obs(ObsConfig())
            ref = run_experiment(algo, cfg, ds, obs=obs_a, **extra, **kw)
            with counted() as counts:
                got = run_experiment(algo, cfg, ds, obs=obs_b, mesh=(1,),
                                     **extra, **kw)
                torch.cuda.synchronize()
            want = FACADE_LAUNCHES if algo == "facade" else 0
            res = out["parity"][f"{algo} {variant}"] = {
                "diff": run_diff(got, ref), "launches": counts,
                "frames_equal": None if obs_a is None else frames_equal(
                    obs_a.frames_table(), obs_b.frames_table())}
            log(f"mesh (1,) {algo} {variant}: {json.dumps(res)}")
            if not (res["diff"]["equal"] and res["frames_equal"] is not False
                    and counts["head_losses"] == want):
                raise AssertionError(f"mesh {algo} {variant}: "
                                     f"{json.dumps(res)} (K1 want {want})")
            launches += counts["head_losses"]
    rate_kw = dict(PAPER, rounds=NET_RATE_ROUNDS,
                   eval_every=NET_RATE_ROUNDS)
    meshes = {"none": None, "mesh1": (1,)}
    caches = {name: EngineCache() for name in meshes}
    runs = {name: [] for name in meshes}
    with counted() as counts:
        for name, mesh in meshes.items():
            run_experiment("facade", cfg, ds, cache=caches[name],
                           device="cuda", mesh=mesh, **rate_kw)
        for rep in range(MESH_RATE_REPS):
            order = list(meshes) if rep % 2 == 0 else list(meshes)[::-1]
            for name in order:
                _, wall, peak, reserved = timed_run(
                    "facade", cfg, ds, cache=caches[name],
                    mesh=meshes[name], **dict(rate_kw, seed=1))
                runs[name].append({"rounds_per_s": NET_RATE_ROUNDS / wall,
                                   "peak_allocated": peak,
                                   "peak_reserved": reserved})
    for name in meshes:
        rates = [r["rounds_per_s"] for r in runs[name]]
        out["rates"][name] = {
            "median": statistics.median(rates), "rates": rates,
            "peak_allocated": max(r["peak_allocated"] for r in runs[name]),
            "capture_s": caches[name].entry(dataclasses.replace(
                paper_spec("facade", cfg, ds),
                mesh=meshes[name])).engine.capture_s}
    out["rates"]["mesh1_vs_none"] = (out["rates"]["mesh1"]["median"]
                                     / out["rates"]["none"]["median"])
    want = 2 * (1 + MESH_RATE_REPS) * NET_RATE_ROUNDS + 2 * WARMUP_ROUNDS
    out["rates"]["launches"] = counts
    log(f"mesh rate: {json.dumps(out['rates'])}")
    if counts["head_losses"] != want:
        raise AssertionError(f"mesh rate: {counts} K1, want {want}")
    launches += counts["head_losses"]
    del caches
    dist.destroy_process_group()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"mesh phase: {out['phase_s']:.1f} s")
    rec["mesh"] = out
    torch.cuda.empty_cache()
    return launches


def whole_leaves(out) -> list:
    """A step's output as its tensor leaves, each DTensor gathered."""
    from torch.distributed.tensor import DTensor
    leaves = []
    for part in out:
        for x in (tree_leaves(part) if isinstance(part, dict) else [part]):
            if isinstance(x, DTensor):
                x = x.full_tensor()
            if isinstance(x, torch.Tensor):
                leaves.append(x)
    return leaves


def lm_mesh_phase(rec) -> dict:
    """The language models' mesh on one card (``LM_MESH_CASES``): each
    step built with ``mesh=None`` and run, then built on
    ``make_debug_mesh((1, 1))`` (a one-rank NCCL group) from the same seed
    and run under the profiler: every output leaf equal bit for bit, K2
    and K3 launched on the DTensor path as many times as the case says,
    by the launch counters and by the profiler's kernel names; then
    FACADE's step on the multi-pod layout at (1, 1, 1)
    (``lm_mesh_facade``). The group is destroyed at the end. Returns the
    meshed runs' K1, K2 and K3 launches. On one rank ``localmap.grad_in_layout`` hands ``x`` back
    as it is, so the train step here skips its ``_InLayout`` node, which
    every step on more ranks runs (``tools/lm_mesh_run.py``,
    ``tests/test_torch_lm_mesh.py``'s gloo world)."""
    t0 = time.perf_counter()
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    out = {"cases": {}}
    total = {"flash_attention": 0, "wkv": 0}
    for arch, shape, batch, (n_fa, n_wkv) in LM_MESH_CASES:
        plain = steps.build_case(arch, shape, batch=batch, seed=0)
        want = whole_leaves(plain.step_fn(*plain.args))
        del plain
        case = steps.build_case(arch, shape, batch=batch, seed=0,
                                mesh=mesh)
        got = []
        with counted() as counts:
            prof = device_profile(
                lambda: got.append(case.step_fn(*case.args)),
                kernels=FA_KERNELS + (WKV_KERNEL,))
        leaves = whole_leaves(got.pop())
        del case
        equal = len(leaves) == len(want) and all(
            torch.equal(a, b) for a, b in zip(leaves, want))
        by_name = prof.get("kernels") or {}
        res = {"batch": batch, "bit_for_bit": equal, "leaves": len(want),
               "launches": counts, "wall_s": prof["wall_s"],
               "profiled_fa": sum(by_name.get(k, [0])[0] for k in
                                  FA_KERNELS) if by_name else None,
               "profiled_wkv": by_name[WKV_KERNEL][0] if by_name else None}
        out["cases"][f"{arch} {shape}"] = res
        log(f"lm mesh (1, 1) {arch} {shape}: {json.dumps(res)}")
        if not (equal and counts["flash_attention"] == n_fa
                and counts["wkv"] == n_wkv and counts["head_losses"] == 0
                and res["profiled_fa"] in (None, n_fa)
                and res["profiled_wkv"] in (None, n_wkv)):
            raise AssertionError(f"lm mesh {arch} {shape}: {res}")
        total["flash_attention"] += counts["flash_attention"]
        total["wkv"] += counts["wkv"]
        del want, leaves
        gc.collect()
        torch.cuda.empty_cache()
    res = lm_mesh_facade()
    out["cases"]["llama3.2-1b facade_pod"] = res
    total["head_losses"] = res["launches"]["head_losses"]
    total["flash_attention"] += res["launches"]["flash_attention"]
    dist.destroy_process_group()
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t0
    log(f"lm mesh phase: {out['phase_s']:.1f} s")
    rec["lm_mesh"] = out
    return total


def facade_step_leaves(out) -> list:
    """A FACADE step's new state (cores, heads, cluster ids) and info
    (selection losses, cluster ids) as tensor leaves, DTensors gathered."""
    state, info = out
    return whole_leaves([state.cores, state.heads, state.cluster_id,
                         info["selection_losses"], info["cluster_id"]])


def lm_mesh_facade() -> dict:
    """``lm_mesh_phase``'s FACADE case: llama3.2-1b's step
    (``LM_MESH_FACADE``) on ``make_debug_mesh((1, 1, 1), ("pod", "data",
    "model"))`` against ``mesh=None`` from the same seed, bit for bit;
    its step 2c through K1's DTensor branch (the selection losses come out
    a DTensor), K1 once by counter and by its LM body's kernel name, K2
    in both nodes' feature passes."""
    from torch.distributed.tensor import DTensor

    t0 = time.perf_counter()
    mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = get_config("llama3.2-1b")
    plain = steps.build_facade_case("llama3.2-1b", seed=0, **LM_MESH_FACADE)
    want_out = plain.step_fn(*plain.args)
    want = facade_step_leaves(want_out)
    bytes_want = want_out[1]["round_bytes"]
    del plain, want_out
    case = steps.build_facade_case("llama3.2-1b", seed=0, mesh=mesh,
                                   **LM_MESH_FACADE)
    got = []
    with counted() as counts:
        prof = device_profile(
            lambda: got.append(case.step_fn(*case.args)),
            kernels=K1_NAMES + FA_KERNELS)
    out = got.pop()
    on_mesh = isinstance(out[1]["selection_losses"], DTensor)
    leaves = facade_step_leaves(out)
    bytes_got = out[1]["round_bytes"]
    del case, out
    equal = len(leaves) == len(want) and all(
        torch.equal(a, b) for a, b in zip(leaves, want))
    by_name = prof.get("kernels") or {}
    n_fa = 2 * cfg.n_layers                       # both nodes' features
    res = {**LM_MESH_FACADE, "dtype": cfg.dtype, "bit_for_bit": equal,
           "leaves": len(want), "round_bytes_equal": bytes_got ==
           bytes_want, "losses_dtensor": on_mesh, "launches": counts,
           "wall_s": prof["wall_s"],
           "profiled_k1": ({k: by_name[k][0] for k in K1_NAMES}
                           if by_name else None),
           "profiled_fa": sum(by_name.get(k, [0])[0] for k in
                              FA_KERNELS) if by_name else None}
    res["case_s"] = time.perf_counter() - t0
    log(f"lm mesh (1, 1, 1) llama3.2-1b facade_pod: {json.dumps(res)}")
    k1_body = K1_BODY_KERNEL[hs_ops.body_for(
        1, 1, LM_MESH_FACADE["batch_per_node"] * LM_MESH_FACADE["seq"],
        cfg.d_model, cfg.vocab_size, cfg.dt)]
    if not (equal and on_mesh and res["round_bytes_equal"]
            and counts["head_losses"] == 1
            and counts["flash_attention"] == n_fa and counts["wkv"] == 0
            and (res["profiled_k1"] is None
                 or res["profiled_k1"][k1_body] == 1)
            and res["profiled_fa"] in (None, n_fa)):
        raise AssertionError(f"lm mesh llama3.2-1b facade_pod: {res}")
    del want, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return res


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (the examples are scripts,
    not a package)."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def returned_tensors(obj, seen=None) -> list:
    """Every tensor in what an example returned: through dicts, lists,
    tuples (named ones included) and dataclasses (``RunResult``)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for item in items for t in returned_tensors(item, seen)]


@contextlib.contextmanager
def inputs_seen():
    """Each distinct signature (input shapes and dtypes, keyword options)
    with which the port's modules call K1's and K2's wrappers inside the
    block: every module outside ``repro_torch.kernels`` that holds a
    wrapper by name holds a pass-through to it meanwhile."""
    seen = {fn.__name__: [] for fn in (head_losses, flash_attention)}

    def tap(fn):
        def through(*args, **kw):
            sig = (tuple((tuple(a.shape), str(a.dtype)) for a in args),
                   tuple(sorted(kw.items())))
            if sig not in seen[fn.__name__]:
                seen[fn.__name__].append(sig)
            return fn(*args, **kw)
        return through

    taps = {fn: tap(fn) for fn in (head_losses, flash_attention)}
    patched = [(mod, fn) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith("repro_torch.")
               and not mod.__name__.startswith("repro_torch.kernels")
               for fn in taps if getattr(mod, fn.__name__, None) is fn]
    for mod, fn in patched:
        setattr(mod, fn.__name__, taps[fn])
    try:
        yield seen
    finally:
        for mod, fn in patched:
            setattr(mod, fn.__name__, fn)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name.removeprefix("torch."))


def example_kernel_checks(name, counts, seen) -> dict:
    """K1 and K2 against their plain versions on seeded inputs at every
    signature the example gave them (``inputs_seen``): K1 by ``hs_check``
    (``HS_TOL``, equal argmins; bf16 inputs as ``hs_lm_case`` draws them,
    fp32 as ``hs_case``), K2 by ``check`` at ``FA_TOL``. Raises where a
    kernel launched in the example's run but no call was seen."""
    for key in seen:
        if counts[key] and not seen[key]:
            raise AssertionError(f"example {name}: {key} launched "
                                 f"{counts[key]} times, no call seen")
    t0 = time.perf_counter()
    out = {"head_losses": [], "flash_attention": []}
    for i, (args, opts) in enumerate(seen["head_losses"]):
        (f_shape, f_dtype), (h_shape, _), (_, l_dtype) = args
        if opts:
            raise AssertionError(f"example {name}: K1 called with {opts}")
        (n, t, d), (k, v) = f_shape, (h_shape[1], h_shape[3])
        if torch_dtype(f_dtype) == torch.bfloat16:
            feats, heads, labels = hs_lm_case(n, k, t, d, v, seed=200 + i)
        else:
            feats, heads, labels = hs_case(n, k, t, d, v,
                                           torch_dtype(f_dtype), 200 + i)
        labels = labels.to(torch_dtype(l_dtype))
        got = head_losses(feats, heads, labels)
        torch.cuda.synchronize()
        out["head_losses"].append(hs_check(
            f"example {name} head_select", got,
            head_losses_ref(feats, heads, labels), shape=[n, k, t, d, v],
            dtype=f_dtype))
        del feats, heads, labels, got
    for i, (args, opts) in enumerate(seen["flash_attention"]):
        ((b, s, hq, d), q_dtype), ((_, _, hkv, _), _), _ = args
        kw = dict(opts)
        if not set(kw) <= {"causal", "window"}:
            raise AssertionError(f"example {name}: K2 called with {kw}")
        dtype = torch_dtype(q_dtype)
        q, k, v = fa_inputs(b, hq, hkv, s, d, dtype, seed=300 + i)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa_plain(q.float(), k.float(), v.float(),
                        kw.get("window", 0), kw.get("causal", True))
        out["flash_attention"].append(check(
            f"example {name} flash_attention", got, want, *FA_TOL[dtype],
            shape=[b, hq, hkv, s, d], dtype=q_dtype, **kw))
        del q, k, v, got, want
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def example_setting(ex, name: str, default=None):
    """The default of the example's ``run`` setting ``name``: the
    reference example's value."""
    param = inspect.signature(ex.run).parameters.get(name)
    return default if param is None else param.default


def drive_example(rec, name: str, **kw) -> tuple:
    """``run(device="cuda", **kw)`` of the example ``name`` with the
    launch counts set to 0 just before and read just after, and the
    kernels' calls seen (``inputs_seen``); every tensor it returns must
    be on the card. Returns (module, result, counts, calls seen,
    record)."""
    ex = load_example(name)
    settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted() as counts, inputs_seen() as seen:
        res = ex.run(device="cuda", **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tensors = returned_tensors(res)
    off_card = sorted({str(t.device) for t in tensors
                       if t.device.type != "cuda"})
    entry = {"wall_s": wall, "launches": counts,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "tensors_returned": len(tensors),
             "nvidia_smi": rec["nvidia_smi"]}
    if not tensors or off_card:
        raise AssertionError(f"example {name}: returned {len(tensors)} "
                             f"tensors, off the card on {off_card}")
    log(f"example {name}: {wall:.2f} s, launches {counts}")
    return ex, res, counts, seen, entry


def example_bytes_check(name, cfg, res, n: int, degree: int) -> dict:
    """EL's and FACADE's first-round bytes: each what ``round_bytes``
    counts, so the same model bytes a push, FACADE's push adding its
    4-byte cluster id."""
    el, fa = res["el"].comm.bytes[0], res["facade"].comm.bytes[0]
    out = {"el": el, "facade": fa, "cluster_id_bytes": fa - el,
           "el_want": round_bytes(cfg, "el", n, degree),
           "facade_want": round_bytes(cfg, "facade", n, degree)}
    if not (el == out["el_want"] and fa == out["facade_want"]
            and fa - el == 4 * n * degree):
        raise AssertionError(f"example {name}: per-round bytes {out}")
    return out


def k1_gate(name, ex, counts, facade_runs: int):
    """K1 launched exactly as the example's FACADE runs launch it: each of
    the ``rounds`` rounds once, and ``WARMUP_ROUNDS`` calls before each
    capture of the segment engine (two captures where FACADE's
    ``warmup_rounds`` boundary splits the run)."""
    graphs = 2 if example_setting(ex, "warmup_rounds", 0) else 1
    want = facade_runs * (example_setting(ex, "rounds")
                          + WARMUP_ROUNDS * graphs)
    if counts["head_losses"] != want:
        raise AssertionError(f"example {name}: K1 launched "
                             f"{counts['head_losses']} times in "
                             f"{facade_runs} FACADE runs, want {want}")


class CardInitDraws(TorchDraws):
    """``TorchDraws`` with the initial parameters drawn on the card: a
    full-width model's weights in about a second where the CPU takes half
    a minute (batches and topologies as ``TorchDraws``)."""

    def __init__(self, seed: int):
        super().__init__(seed)
        self._init = torch.Generator("cuda").manual_seed(
            self._init.initial_seed())


def examples_lm_profile() -> dict:
    """One profiled round of ``torch_facade_lm_pretrain`` at llama3.2-1b's
    full width (``EXAMPLES_LM`` with 1 round, evaluated once; its weights
    drawn on the card): K1's launches by counter and its LM body's by
    kernel name."""
    ex = load_example("facade_lm_pretrain")
    cfg = get_config("llama3.2-1b")
    kw = dict(EXAMPLES_LM, rounds=1, eval_every=1)
    with counted() as counts:
        prof = device_profile(
            lambda: ex.run(cfg=cfg, verbose=False, device="cuda",
                           draws=CardInitDraws, **kw),
            kernels=(K1_KERNEL, K1_LM_KERNEL, K1_LM_MERGE))
    by_name = prof.get("kernels") or {}
    out = {"launches": counts, "wall_s": prof["wall_s"],
           "busy_share": prof["busy_share"],
           "profiled_k1": {k: v[0] for k, v in by_name.items()}
           if by_name else None}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quickstart_card_vs_cpu(qs) -> dict:
    """``torch_quickstart`` at ``EXAMPLES_CARD_CPU`` on the card and on the
    CPU from the same draws: accuracies within SMALL_TOL, bytes and
    cluster ids equal, or raise. The heads are decorrelated
    (``EXAMPLES_CARD_CPU_JITTER``): at the example's equal heads a
    selection is a tie between the two devices' last ulps."""
    runs = {dev: qs.run(device=dev, verbose=False,
                        head_jitter=EXAMPLES_CARD_CPU_JITTER,
                        **EXAMPLES_CARD_CPU) for dev in ("cuda", "cpu")}
    out = {"head_jitter": EXAMPLES_CARD_CPU_JITTER, **EXAMPLES_CARD_CPU}
    for algo in ("el", "facade"):
        gpu, cpu = runs["cuda"][algo], runs["cpu"][algo]
        hist = [[(r, c.tolist()) for r, c in res.cluster_history]
                for res in (gpu, cpu)]
        got = out[algo] = {
            "acc_diff": float(np.abs(np.subtract(gpu.final_acc,
                                                 cpu.final_acc)).max()),
            "bytes_equal": gpu.comm.bytes == cpu.comm.bytes,
            "cluster_ids_equal": hist[0] == hist[1]}
        if not (got["acc_diff"] <= SMALL_TOL and got["bytes_equal"]
                and got["cluster_ids_equal"]):
            raise AssertionError(f"example quickstart {algo}: card and CPU "
                                 f"disagree {got}, cluster history "
                                 f"{hist}")
    log(f"example quickstart card vs CPU {json.dumps(out)}")
    return out


def examples_phase(rec) -> dict:
    """The six ``examples/torch_*.py`` through their ``run`` on the card,
    as a user runs them: the four CNN examples at the reference's own
    settings, ``torch_serve_batched`` and ``torch_facade_lm_pretrain`` at
    llama3.2-1b's full width (``EXAMPLES_LM``; their weights drawn on
    the card by their ``draws`` seam, ``CardInitDraws``). Gates: the
    examples' per-round bytes (``example_bytes_check``), K1's exact
    launches in the FACADE runs (``k1_gate``), K2 16 times a prefill, K1
    and K2 against their plain versions at every signature each example
    gave them (``example_kernel_checks``), obs_demo's own dp/eo identity
    and its rendered report, the robust run's finite node accuracies,
    every returned tensor on the card; K1 once a round of the LM example
    and, in one profiled round in a process of its own, its LM body by
    kernel name; then ``quickstart_card_vs_cpu``. Returns K1's and K2's
    launches."""
    t_phase = time.perf_counter()
    out, total = {}, {"head_losses": 0, "flash_attention": 0}

    def add(counts):
        for key in total:
            total[key] += counts[key]

    lenet4 = lenet(smoke=True).replace(n_classes=4)
    # quickstart and fairness_eval: EL and FACADE, 48 rounds, 8 nodes
    for name in ("quickstart", "fairness_eval"):
        kw = {"verbose": False} if name == "quickstart" else {}
        ex, res, counts, seen, entry = drive_example(rec, name, **kw)
        entry["bytes"] = example_bytes_check(name, lenet4, res, n=8,
                                             degree=2)
        k1_gate(name, ex, counts, 1)
        entry["checks"] = example_kernel_checks(name, counts, seen)
        entry["final_acc"] = {a: res[a].final_acc for a in ("el", "facade")}
        entry["best_fair_acc"] = {a: res[a].best_fair_acc()
                                  for a in ("el", "facade")}
        log(ex.summary(res))
        out[name] = entry
        add(counts)

    ex, res, counts, seen, entry = drive_example(
        rec, "obs_demo", out_dir=ROOT / "build" / "examples_obs")
    k1_gate("obs_demo", ex, counts, 1)
    entry["checks"] = example_kernel_checks("obs_demo", counts, seen)
    if not res["markdown"].startswith("# Run report"):
        raise AssertionError(f"example obs_demo: report {res['markdown']!r}")
    entry.update(verdict=res["manifest"].health["verdict"],
                 dp=res["result"].dp, eo=res["result"].eo,
                 manifest=str(res["manifest_path"].relative_to(ROOT)))
    log(ex.summary(res).split("\nrendered report")[0])
    out["obs_demo"] = entry
    add(counts)

    ex, res, counts, seen, entry = drive_example(rec, "netsim_demo")
    n_runs = len(res["scenarios"]) + 2 + len(res["hostile"])
    k1_gate("netsim_demo", ex, counts, n_runs)
    entry["checks"] = example_kernel_checks("netsim_demo", counts, seen)
    robust = np.asarray(res["hostile"]["robust"][0].node_acc, float)
    unguarded = np.asarray(res["hostile"]["unguarded"][0].node_acc, float)
    entry.update(runs=n_runs, robust_node_acc=robust.tolist(),
                 unguarded_finite=bool(np.isfinite(unguarded).all()))
    if not np.isfinite(robust).all():
        raise AssertionError(f"example netsim_demo: robust node accuracies "
                             f"{robust.tolist()}")
    log(ex.summary(res))
    out["netsim_demo"] = entry
    add(counts)

    cfg = get_config("llama3.2-1b")
    ex, res, counts, seen, entry = drive_example(
        rec, "serve_batched", cfg=cfg, draws=CardInitDraws)
    prefills = len(res["generated"])
    want = launches_of(flash_attention=cfg.n_layers * prefills)
    shapes = {c: list(g.shape) for c, g in res["generated"].items()}
    entry.update(prefills=prefills, generated=shapes)
    if counts != want or any(s[1] != 16 for s in shapes.values()):
        raise AssertionError(f"example serve_batched: launches {counts}, "
                             f"want {want}; generated {shapes}")
    log(ex.summary(res))
    del res
    gc.collect()
    entry["checks"] = example_kernel_checks("serve_batched", counts, seen)
    out["serve_batched"] = entry
    add(counts)

    ex, res, counts, seen, entry = drive_example(
        rec, "facade_lm_pretrain", cfg=cfg, draws=CardInitDraws,
        **EXAMPLES_LM)
    n = sum(EXAMPLES_LM["nodes"])
    evals = len(res["evals"])
    want = launches_of(head_losses=EXAMPLES_LM["rounds"],
                       flash_attention=(EXAMPLES_LM["rounds"] + evals) * n
                       * cfg.n_layers)
    entry.update(rounds_per_s=res["rounds_per_s"], evals=[
        {"round": r, "nll": nll, "cluster_id": cid.tolist(),
         "rounds_per_s": rate} for r, nll, cid, rate in res["evals"]])
    if counts != want or not all(np.isfinite(e["nll"]).all()
                                 for e in entry["evals"]):
        raise AssertionError(f"example facade_lm_pretrain: launches "
                             f"{counts}, want {want}; evals "
                             f"{entry['evals']}")
    log(ex.summary(res))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    entry["checks"] = example_kernel_checks("facade_lm_pretrain", counts,
                                            seen)
    # a process of its own: late in this one the profiler may record no
    # device event (head_select_lm_split_apart)
    t0 = time.perf_counter()
    profile = entry["profiled_round"] = run_apart("examples_lm_profile")
    profile["process_s"] = time.perf_counter() - t0
    log(f"example facade_lm_pretrain profiled round {json.dumps(profile)}")
    if not (profile["launches"]["head_losses"] == 1 and profile[
            "profiled_k1"] and profile["profiled_k1"][K1_LM_KERNEL] == 1
            and profile["profiled_k1"][K1_KERNEL] == 0):
        raise AssertionError(f"example facade_lm_pretrain: profiled round "
                             f"{profile}")
    out["facade_lm_pretrain"] = entry
    add(counts)

    t0 = time.perf_counter()
    out["quickstart_card_vs_cpu"] = quickstart_card_vs_cpu(
        load_example("quickstart"))
    out["quickstart_card_vs_cpu"]["wall_s"] = time.perf_counter() - t0
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    rec["examples"] = out
    log(f"examples phase: {out['phase_s']:.1f} s, launches {total}")
    return total


def small_input_phase(rec):
    """The same tiny experiment on the card and on the CPU (one seed, so
    the same draws), on GN-LeNet and on ResNet8: bytes and cluster ids
    exact, accuracy within 0.1."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                     test_per_class=16, seed=3)
    ds = make_clustered_data(spec, (6, 2), ("rot0", "rot180"))
    kw = dict(rounds=4, k=2, degree=2, local_steps=3, batch_size=8,
              lr=0.05, eval_every=2, seed=0, head_jitter=0.05)
    out = {}
    for model in (lenet, resnet8):
        cfg = model(smoke=True).replace(n_classes=4)
        for algo in ("facade", "el"):
            gpu = run_experiment(algo, cfg, ds, device="cuda", **kw)
            cpu = run_experiment(algo, cfg, ds, device="cpu", **kw)
            diff = float(np.abs(np.subtract(gpu.final_acc,
                                            cpu.final_acc)).max())
            same_cid = all(np.array_equal(a, b) for (_, a), (_, b) in
                           zip(gpu.cluster_history, cpu.cluster_history))
            got = out.setdefault(cfg.kind, {})[algo] = {
                "acc_diff": diff, "cluster_ids_equal": same_cid,
                "bytes_equal": gpu.comm.bytes == cpu.comm.bytes}
            log(f"small input {cfg.kind} {algo}: card vs CPU "
                f"{json.dumps(got)}")
            if not (diff <= SMALL_TOL and same_cid and gpu.comm.bytes ==
                    cpu.comm.bytes):
                raise AssertionError(f"{cfg.kind} {algo}: card and CPU "
                                     f"disagree {got}")
    rec["small_input"] = out


@contextlib.contextmanager
def one_dataset(rec):
    """``paper_main`` makes its dataset on every call, as the reference's
    does; inside this block the launcher's ``make_clustered_data`` makes
    each (spec, clusters, transforms) once and hands the same arrays to
    later calls (the function is deterministic, and the runs only read
    them), so the five runs of one spec pay for the data once. The host
    time of each making goes to ``rec["data_s"]``."""
    make, made = train.make_clustered_data, {}
    rec["data_s"] = []

    def shared(spec, sizes, transforms=None):
        key = (spec, tuple(sizes), transforms and tuple(transforms))
        if key not in made:
            t0 = time.perf_counter()
            made[key] = make(spec, sizes, transforms)
            rec["data_s"].append(time.perf_counter() - t0)
        return made[key]

    train.make_clustered_data = shared
    try:
        yield
    finally:
        train.make_clustered_data = make


@contextlib.contextmanager
def launcher_cache(cache: EngineCache):
    """``paper_main`` builds a private ``EngineCache`` for its run; inside
    this block its ``run_experiment`` goes through ``cache`` instead, so
    that the run's capture seconds can be read after it."""
    run = train.run_experiment
    train.run_experiment = functools.partial(run, cache=cache)
    try:
        yield
    finally:
        train.run_experiment = run


def resnet8_paper_phase(rec) -> int:
    """The launcher's paper mode (``train.paper_main``) on full-width
    ResNet8 for the five algorithms (``RESNET8_PAPER``, the data made
    once: ``one_dataset``), on the segment engine; checks one K1 launch
    per FACADE round and per warm-up call before its capture and none in
    the baselines, the bytes per round against ``RESNET8_BYTES``, finite
    parameters on the card and accuracies in [0, 1]. Then the per-round
    loop on the same run, timed, which the engine's run must equal bit for
    bit, and the run length from which the engine's capture has paid for
    itself (``break_even``, the capture counted whole against 8-round
    runs). Returns K1's launches in the FACADE run."""
    p = RESNET8_PAPER
    cfg = resnet8().replace(n_classes=p["n_classes"],
                            image_size=p["image_size"])
    n = sum(p["clusters"])
    spec = SynthSpec(n_classes=p["n_classes"], image_size=p["image_size"],
                     samples_per_class=p["samples_per_class"],
                     test_per_class=p["test_per_class"], seed=p["seed"])
    loop_kw = dict(rounds=ROUNDS, k=p["k"], degree=p["degree"],
                   local_steps=p["local_steps"], batch_size=p["batch"],
                   lr=p["lr"], eval_every=p["eval_every"], seed=p["seed"],
                   warmup_rounds=p["warmup_rounds"])
    out = {}
    with one_dataset(out):
        for algo in ALGOS:
            cache, made = EngineCache(), len(out["data_s"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counted() as counts, launcher_cache(cache):
                res = train.paper_main(argparse.Namespace(algo=algo, **p))
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = out[algo] = resnet8_run_check(cfg, algo, n, res, counts,
                                                wall)
            ds = train.make_clustered_data(spec, tuple(p["clusters"]),
                                           p["transforms"])
            loop, loop_s, _, _ = timed_run(algo, cfg, ds, engine=False,
                                           **loop_kw)
            key = paper_spec(algo, cfg, ds)
            if len(cache) != 1 or key not in cache:
                raise AssertionError(f"resnet8 {algo}: the run's cache "
                                     f"holds {cache.stats()}")
            capture = sum(cache.entry(key).engine.capture_s)
            # the engine's rounds and evals: the run less its capture and
            # the data, where this run made it
            rounds_s = wall - capture - sum(out["data_s"][made:])
            got.update(loop_s=loop_s, capture_s=capture,
                       vs_loop=run_diff(res, loop),
                       break_even_rounds=break_even(
                           capture, rounds_s / ROUNDS, loop_s / ROUNDS))
            log(f"resnet8 {algo}: the loop {loop_s:.2f} s, capture "
                f"{capture:.2f} s, engine vs loop "
                f"{json.dumps(got['vs_loop'])}, break-even "
                f"{got['break_even_rounds']} rounds")
            if not got["vs_loop"]["equal"]:
                raise AssertionError(f"resnet8 {algo}: the engine is not "
                                     f"the loop's run: {got['vs_loop']}")
            del cache
    rec["resnet8_paper"] = out
    return out["facade"]["launches"]["head_losses"]


def resnet8_run_check(cfg, algo, n, res, counts, wall) -> dict:
    """One ResNet8 paper run's checks and record."""
    want = {fn.__name__: 0 for fn in KERNELS}
    want["head_losses"] = FACADE_LAUNCHES if algo == "facade" else 0
    if counts != want:
        raise AssertionError(f"resnet8 {algo}: kernel launches {counts} "
                             f"in {ROUNDS} rounds, want {want}")
    leaves = tree_leaves(res.models)
    if not all(bool(torch.isfinite(l).all()) for l in leaves):
        raise AssertionError(f"resnet8 {algo}: non-finite parameters")
    if leaves[0].shape[0] != n or leaves[0].device.type != "cuda":
        raise AssertionError(f"resnet8 {algo}: models not [n, ...] on the "
                             f"card")
    want_bytes = round_bytes(cfg, algo, n, RESNET8_PAPER["degree"])
    per_round = np.diff([0.0] + res.comm.bytes)
    if not (want_bytes == RESNET8_BYTES[algo] and len(per_round) == ROUNDS
            and (per_round == want_bytes).all()):
        raise AssertionError(f"resnet8 {algo}: bytes per round "
                             f"{per_round}, want {RESNET8_BYTES[algo]}")
    accs = res.final_acc
    if not (len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
            and np.isfinite(res.best_fair_acc())):
        raise AssertionError(f"resnet8 {algo}: bad accuracies {accs}")
    log(f"resnet8 {algo}: {ROUNDS} rounds in {wall:.2f} s with set-up "
        f"({ROUNDS / wall:.2f} rounds/s), acc per cluster {accs}, "
        f"bytes/round {want_bytes:.0f}")
    return {"wall_s": wall, "rounds_per_s": ROUNDS / wall,
            "launches": counts, "final_acc": accs,
            "fair_acc": res.fair_acc[-1][1], "dp": res.dp, "eo": res.eo,
            "bytes_per_round": want_bytes}


def resnet8_select_phase(rec) -> dict:
    """K1 on the operands step 2c builds in a full-width ResNet8 FACADE
    round (``HS_RESNET8``): the state drawn as the launcher's run draws it
    (seed 3, head jitter 0.05 so that the heads differ), the first local
    batch from that spec's data (one sample per class and node, to keep
    the set-up short). Checks K1 against its plain version (2e-5 relative,
    equal argmins) and against that round's own selection losses, then
    times K1, the plain version and the library call beside the bound and
    the launch floor."""
    p = RESNET8_PAPER
    cfg = resnet8()
    n, k = sum(p["clusters"]), p["k"]
    ds = make_clustered_data(
        SynthSpec(n_classes=p["n_classes"], image_size=p["image_size"],
                  samples_per_class=1, test_per_class=1, seed=p["seed"]),
        tuple(p["clusters"]), tuple(p["transforms"]))
    binding = make_binding(cfg)
    draws = TorchDraws(p["seed"])
    params, heads_k = draws.facade_init(binding, k, head_jitter=0.05)
    state = init_facade_state(binding, n, k, params=params, heads_k=heads_k,
                              device="cuda")
    train_x, train_y = pipeline.place(ds, "cuda")
    batches = pipeline.sample_round_batches(
        draws.batch_indices(n, p["local_steps"], p["batch"],
                            train_x.shape[1]).cuda(), train_x, train_y)
    perms = draws.perms(n, p["degree"]).cuda()
    first = {key: b[:, 0] for key, b in batches.items()}
    with torch.no_grad():
        feats = binding.features(state.cores, first)
        f, w, labels = binding.select_operands(feats, state.heads, first)
        got = head_losses(f, w, labels).reshape(n, k)
        want = head_losses_ref(f, w, labels).reshape(n, k)
    torch.cuda.synchronize()
    shape = (w.shape[0], w.shape[1], f.shape[1], f.shape[2], w.shape[3])
    if shape != HS_RESNET8 or f.dtype != torch.float32:
        raise AssertionError(f"resnet8 step 2c operands {shape} {f.dtype}, "
                             f"want {HS_RESNET8} fp32")
    c = hs_check("head_select resnet8 path", got, want,
                 operands=[list(f.shape), list(w.shape)])
    # the round scores what was checked (at round 1 the aggregation leaves
    # the replicated state as it is, up to rounding)
    _, info = facade.facade_round(
        facade.FacadeConfig(n_nodes=n, k=k, degree=p["degree"], lr=p["lr"]),
        binding, state, batches, perms)
    losses = info["selection_losses"]
    c["round_vs_check_rel_err"] = float(
        ((losses - got).abs() / got.abs().clamp(min=1)).max())
    if not c["round_vs_check_rel_err"] <= HS_TOL:
        raise AssertionError(f"resnet8 round 1 selected on {losses.tolist()}"
                             f", the checked K1 call gave {got.tolist()}")
    bound_ms, bound_by, nbytes, flops = hs_bound(f, w, labels)
    t = {"shape": list(HS_RESNET8), "dtype": "fp32", "bound_ms": bound_ms,
         "bound_by": bound_by, "bytes": nbytes, "flops": flops, "check": c}
    for label, fn in (("ms", head_losses), ("plain_ms", head_losses_ref),
                      ("library_ms", hs_library), ("ms_again", head_losses),
                      ("plain_ms_again", head_losses_ref)):
        t[label] = graph_ms(lambda: fn(f, w, labels))
    one = torch.zeros(1, device="cuda")
    t["launch_floor_ms"] = graph_ms(lambda: one.add_(1.0))
    rec["head_select_resnet8"] = t
    log("head_select resnet8 timing", json.dumps(t))
    del ds, state, train_x, train_y, batches, feats, f, w, labels
    torch.cuda.empty_cache()
    return t


def lm_mode_phase(rec) -> dict:
    """The launcher's lm mode (``train.main``) on both LM smoke configs on
    the card (``LM_MODE``; AdamW, the clustered token stream) with a
    checkpoint in a temporary directory under ``build/``: finite losses,
    the checkpoint loads back bit-equal to the final parameters, no K1 or
    K2 launch (training attention is the plain ``sdpa``) and, for RWKV,
    one K3 launch and one of its backward per layer and step
    (``wkv_train``); returns each arch's launches."""
    out = {}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for arch in LM_MODE_ARCHS:
            cfg = get_config(arch, smoke=True)
            path = str(pathlib.Path(tmp) / "lm.npz")
            argv = ["--mode", "lm", "--arch", arch, "--steps",
                    str(LM_MODE["steps"]), "--batch", str(LM_MODE["batch"]),
                    "--seq", str(LM_MODE["seq"]), "--log-every", "10",
                    "--ckpt", path, "--device", "cuda"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counted() as counts:
                res = train.main(argv)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_run = LM_MODE["steps"] * cfg.n_layers if cfg.rwkv else 0
            want = launches_of(wkv=per_run, wkv_backward=per_run)
            if counts != want:
                raise AssertionError(f"lm mode {arch}: kernel launches "
                                     f"{counts}, want {want}")
            if not np.isfinite(res["losses"]).all():
                raise AssertionError(f"lm mode {arch}: losses "
                                     f"{res['losses']}")
            saved, _ = ckpt_io.load(path)
            final = tree_leaves(res["params"])
            loaded = tree_leaves(saved["params"])
            same = len(loaded) == len(final) and all(
                a.dtype == b.dtype and torch.equal(a, b.cpu())
                for a, b in zip(loaded, final))
            if not (same and int(saved["step"]) == LM_MODE["steps"]):
                raise AssertionError(f"lm mode {arch}: the checkpoint does "
                                     f"not hold the final parameters")
            out[arch] = {**LM_MODE, "wall_s": wall,
                         "steps_per_s": LM_MODE["steps"] / wall,
                         "first_loss": res["losses"][0],
                         "last_loss": res["losses"][-1],
                         "launches": counts, "checkpoint_equal": same}
            log(f"lm mode {arch}: {json.dumps(out[arch])}")
    rec["lm_mode"] = out
    return out


def lm_payload_bytes(cfg) -> int:
    """One push of an LM under FACADE, from the config alone: the core
    (embedding and layers) and one head (final norm and untied
    ``lm_head``) in the param dtype, RWKV's fp32 leaves (``decay_base`` and
    ``bonus_u``, d values each a layer) and the hybrid's (the mamba
    branch's ``dt_bias``, ``a_log`` and ``d_skip``) at 4 bytes, and the
    4-byte cluster id."""
    d, ff, size = cfg.d_model, cfg.d_ff, torch.finfo(cfg.dt).bits // 8
    if cfg.rwkv:
        # two norms; time mix: five mixes, w_r/k/v/g/o, the decay's rank-32
        # factors and ln_g; channel mix: two mixes, w_k, w_v and w_r
        layer = (2 * d + (6 * d + 5 * d * d + 2 * 32 * d)
                 + (2 * d + 2 * d * ff + d * d)) * size + 2 * d * 4
    else:
        hd = cfg.hd
        layer = (2 * d + d * cfg.n_heads * hd * 2
                 + d * cfg.n_kv_heads * hd * 2 + 3 * d * ff) * size
    if cfg.arch_type == "hybrid":
        # the mamba branch (models/ssm.py::init_ssm): w_in, the conv, the
        # x projection to dt's rank and B, C, w_dt and w_out in the param
        # dtype, dt_bias, a_log and d_skip in fp32; and two branch norms
        di, n, rank = cfg.ssm_expand * d, cfg.ssm_state, max(1, d // 16)
        layer += (d * 2 * di + cfg.ssm_conv * di + di * (rank + 2 * n)
                  + rank * di + di * d + 2 * d) * size + (2 + n) * di * 4
    core = cfg.vocab_size * d * size + cfg.n_layers * layer
    head = (d + d * cfg.vocab_size) * size
    return core + head + 4


def lm_launches_per_round(cfg, n: int, local_steps: int) -> dict:
    """Kernel launches an LM FACADE round makes: one head-select call;
    step 2c's no-grad feature pass runs one K2 (attention) or K3 (wkv)
    launch a layer and node; training attention is the plain ``sdpa``
    (no K2), while each local step runs K3's forward and its backward
    kernel once a layer and node (``wkv_train``)."""
    per_pass = n * cfg.n_layers
    if cfg.rwkv:
        return launches_of(head_losses=1, wkv=per_pass * (1 + local_steps),
                           wkv_backward=per_pass * local_steps)
    return launches_of(head_losses=1, flash_attention=per_pass)


def lm_select_check(run, drawn) -> tuple:
    """K1 against its plain version on the operands the LM binding builds
    from ``run``'s state and the first local batch of ``drawn``, as step 2c
    builds them (at round 1 the aggregation leaves the replicated state as
    it is); returns (K1's [n, k] losses, the check's record)."""
    first = {key: b[:, 0] for key, b in drawn[0].items()}
    with torch.no_grad():
        feats = run.binding.features(run.state.cores, first)
        f, w, labels = run.binding.select_operands(feats, run.state.heads,
                                                   first)
        got = head_losses(f, w, labels).reshape(run.n, -1)
        want = head_losses_ref(f, w, labels).reshape(run.n, -1)
    torch.cuda.synchronize()
    c = hs_check("head_select lm path", got, want,
                 operands=[list(f.shape), list(w.shape)],
                 dtype=str(f.dtype).removeprefix("torch."))
    del feats, f, w, labels, want
    torch.cuda.empty_cache()
    return got, c


def lm_facade_phase(rec, key: str) -> dict:
    """FACADE at full width on the card for ``key``, a key of
    ``LM_ROUNDS``: an arch, with ``LM_RUN_DTYPE``'s dtype where it names
    one; returns its kernels' launches in the timed rounds. The profiled
    round also counts K1's launches by kernel name: its body's tile kernel
    once (``hs_ops.body_for`` on the round's operands), the merge once
    after a tiled body, the copy once for each ragged D or V on the
    tensor cores, and no other body's kernel."""
    arch = key.split()[0]
    cfg = get_config(arch)
    if key in LM_RUN_DTYPE:
        cfg = cfg.replace(dtype=LM_RUN_DTYPE[key])
    p = LM_FACADE
    want_bytes = float(np.float32(len(p["clusters"]) * p["degree"]
                                  * lm_payload_bytes(cfg)))
    select_range = LM_SELECT_RANGE[key]
    rounds, launches = [], {}
    t0 = time.perf_counter()
    run = LMFacade(cfg, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(p["seed"]),
                   **p)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    want = lm_launches_per_round(cfg, run.n, p["local_steps"])
    drawn = run.draw()
    k1_path, path_check = lm_select_check(run, drawn)
    torch.cuda.reset_peak_memory_stats()

    def one_round(drawn=None):
        with counted() as counts:
            info = run.round(drawn)
            torch.cuda.synchronize()
        if counts != want:
            raise AssertionError(f"LM FACADE {key}: kernel launches "
                                 f"{counts} in a round, want {want}")
        if info["round_bytes"] != want_bytes:
            raise AssertionError(f"LM FACADE {key}: bytes per round "
                                 f"{info['round_bytes']} != {want_bytes}")
        return info, counts

    def profiled(fn):
        """``fn()`` under torch.profiler (the device's activity), with the
        host time in the wkv recurrence's backward (its kernel; 2 nodes' H
        local steps, each layer once), and K1's kernels by name, and for
        RWKV K3's forward and backward kernels by name."""
        names = K1_NAMES + ((WKV_KERNEL, WKV_BWD_KERNEL) if cfg.rwkv
                            else ())
        with host_seconds_in(WkvFunction, "backward") as backward:
            prof = device_profile(fn, kernels=names, host=False)
        if cfg.rwkv:
            calls = run.n * p["local_steps"] * cfg.n_layers
            if backward[1] != calls:
                raise AssertionError(f"LM FACADE {key}: {backward[1]} wkv "
                                     f"backward calls, want {calls}")
            prof["host_spans"] = {WKV_BACKWARD: {
                "host_s": backward[0], "events": backward[1],
                "share_of_wall": backward[0] / prof["wall_s"]}}
            if prof["device_busy_s"] is not None:
                by_name = {name: prof["kernels"][name][0]
                           for name in (WKV_KERNEL, WKV_BWD_KERNEL)}
                named = {WKV_KERNEL: want["wkv"],
                         WKV_BWD_KERNEL: want["wkv_backward"]}
                prof["k3_by_name"] = by_name
                if by_name != named:
                    raise AssertionError(f"LM FACADE {key}: K3's kernels by "
                                         f"name {by_name}, want {named}")
        return prof

    profile = None
    for rnd in range(1, LM_ROUNDS[key] + 1):
        t0 = time.perf_counter()
        if rnd == 1 and key in LM_PROFILED_ONLY:
            # its one round runs under the profiler
            done = []
            profile = profiled(lambda: done.append(one_round(drawn)))
            info, counts = done[0]
        else:
            info, counts = one_round(drawn if rnd == 1 else None)
        wall = time.perf_counter() - t0
        losses = info["selection_losses"].float()
        if rnd == 1:
            # the round scored what the check held against the plain version
            path_check["round_vs_check_rel_err"] = float(
                ((losses - k1_path).abs() / k1_path.abs().clamp(min=1))
                .max())
            if not path_check["round_vs_check_rel_err"] <= HS_TOL:
                raise AssertionError(f"LM FACADE {key}: round 1 selected "
                                     f"on {losses.tolist()}, the checked "
                                     f"K1 call gave {k1_path.tolist()}")
        losses = losses.cpu()
        if rnd == 1 and not (bool(torch.isfinite(losses).all()) and
                             select_range[0] <= float(losses.min())
                             and float(losses.max()) <= select_range[1]):
            raise AssertionError(f"LM FACADE {key}: round-1 selection "
                                 f"losses {losses.tolist()} outside "
                                 f"{select_range}")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        rounds.append({"round": rnd, "wall_s": wall,
                       "selection_losses": losses.tolist(),
                       "cluster_id": info["cluster_id"].tolist(),
                       "launches": counts})
        log(f"LM FACADE {key} round {rnd}: {wall:.3f} s, selection losses "
            f"{losses.tolist()}, cluster ids "
            f"{info['cluster_id'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    # where the time goes: one more round under the profiler
    if profile is None:
        profile = profiled(one_round)
    k1_names = lm_k1_by_name(key, path_check, profile)
    for leaf in tree_leaves(run.state.cores) + tree_leaves(run.state.heads):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"LM FACADE {key}: non-finite parameters")
    out = {**p, "arch": arch, "dtype": cfg.dtype, "n": run.n,
           "init_s": init_s, "rounds": rounds,
           "round_1_s": rounds[0]["wall_s"],
           "rounds_2_3_s": [r["wall_s"] for r in rounds[1:]],
           "peak_mem_bytes": peak, "bytes_per_round": want_bytes,
           "launches_per_round": want, "k1_path_check": path_check,
           "k1_by_name": k1_names, "profiled_round": profile}
    rec.setdefault("lm_facade", {})[key] = out
    log(f"LM FACADE {key} profile", json.dumps(profile))
    log(f"LM FACADE {key}: round 1 {out['round_1_s']:.3f} s, rounds 2-3 "
        f"{out['rounds_2_3_s']} s, peak memory {peak / 1e9:.2f} GB, "
        f"bytes/round {want_bytes:.0f}")
    del run, drawn
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def host_seconds_in(cls, name: str):
    """The static method ``cls.<name>`` timed on the host clock inside the
    block: yields [seconds, calls]."""
    inner, acc = getattr(cls, name), [0.0, 0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
            acc[1] += 1

    setattr(cls, name, staticmethod(timed))
    try:
        yield acc
    finally:
        setattr(cls, name, staticmethod(inner))


def lm_k1_by_name(key: str, path_check: dict, profile: dict) -> dict:
    """K1's kernels by name in an LM round's profile against its body
    (``hs_ops.body_for`` on the operands ``lm_select_check`` built), or
    raise; None where the profiler recorded no device time (not
    measured)."""
    (rows, t, d), (_, k, _, v) = path_check["operands"]
    dtype = torch.bfloat16 if path_check["dtype"] == "bfloat16" \
        else torch.float32
    body = hs_ops.body_for(rows, k, t, d, v, dtype)
    want = {name: 0 for name in K1_NAMES}
    want[K1_BODY_KERNEL[body]] = 1
    if body != "fma":
        want[K1_LM_MERGE] = 1
    if body == "tensor_core":
        want[K1_PAD_KERNEL] = int(d % 8 != 0) + int(v % 8 != 0)
    if body == "fp32_tensor_core":
        want[K1_SPLIT_KERNEL] = 1
        want[K1_PAD_KERNEL] = int(v % 4 != 0)
    got = ({name: profile["kernels"][name][0] for name in K1_NAMES}
           if profile.get("device_busy_s") is not None else None)
    out = {"body": body, "want": want, "got": got}
    log(f"LM FACADE {key} K1 by kernel name", json.dumps(out))
    if got is not None and got != want:
        raise AssertionError(f"LM FACADE {key}: K1's kernels by name {got}, "
                             f"want {want}")
    return out


def smoke_lm_facade_phase(rec) -> dict:
    """The smoke LM FACADE rounds (fp32) of ``SMOKE_LM_ARCHS`` (GQA, RWKV,
    MLA and MoE) on the card and on the CPU from the same draws: selection
    losses and parameters within SMOKE_LM_TOL, cluster ids and bytes
    equal. Returns K1's launches on the card by the body its operands
    take ({body: launches})."""
    t0 = time.perf_counter()
    k1 = {}
    for arch in SMOKE_LM_ARCHS:
        cfg = get_config(arch, smoke=True)
        runs = {}
        for device in ("cuda", "cpu"):
            run = LMFacade(cfg, device=device, **SMOKE_LM)
            with counted() as counts:
                runs[device] = (run, [run.round()
                                      for _ in range(SMOKE_LM_ROUNDS)])
            if device == "cuda":
                # step 2c's operands: one stream of T tokens a (node, head)
                body = hs_ops.body_for(1, 1, 1, cfg.d_model,
                                       cfg.vocab_size, torch.float32)
                k1[body] = k1.get(body, 0) + counts["head_losses"]
        (gpu, gi), (cpu, ci) = runs["cuda"], runs["cpu"]
        loss_diff = max(float((a["selection_losses"].cpu()
                               - b["selection_losses"]).abs().max())
                        for a, b in zip(gi, ci))
        same_cid = all(torch.equal(a["cluster_id"].cpu(), b["cluster_id"])
                       for a, b in zip(gi, ci))
        same_bytes = [a["round_bytes"] for a in gi] == [b["round_bytes"]
                                                         for b in ci]
        param_diff = max(
            float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-3))
            for a, b in zip(tree_leaves(gpu.state.cores)
                            + tree_leaves(gpu.state.heads),
                            tree_leaves(cpu.state.cores)
                            + tree_leaves(cpu.state.heads)))
        out = {"selection_loss_max_diff": loss_diff,
               "param_max_rel_diff": param_diff,
               "cluster_ids_equal": same_cid, "bytes_equal": same_bytes,
               "tol": SMOKE_LM_TOL}
        log(f"smoke LM FACADE {arch}: card vs CPU {json.dumps(out)}")
        if not (loss_diff <= SMOKE_LM_TOL and param_diff <= SMOKE_LM_TOL
                and same_cid and same_bytes):
            raise AssertionError(f"smoke LM FACADE {arch}: card and CPU "
                                 f"disagree {out}")
        rec.setdefault("smoke_lm_facade", {})[arch] = out
    rec["smoke_lm_facade_s"] = time.perf_counter() - t0
    rec["smoke_lm_facade_k1"] = k1
    log(f"smoke LM FACADE: {rec['smoke_lm_facade_s']:.1f} s, K1 {k1}")
    return k1


def check(name, got, want, tol, rtol=None, **info):
    """Max abs error of ``got`` against ``want``; raises beyond ``tol``
    absolute plus ``rtol`` (default ``tol``) relative, as
    ``assert_allclose``."""
    rtol = tol if rtol is None else rtol
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= tol + rtol * want.abs()).all())
    rec = dict(info, max_abs_err=err, tol=tol, rtol=rtol)
    log(f"{name} check", json.dumps(rec))
    if not (ok and np.isfinite(err)):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def fa_inputs(b, hq, hkv, s, d, dtype, seed, qk_std=0.3):
    g = torch.Generator().manual_seed(seed)
    return [(std * torch.randn((b, s, h, d), generator=g)).to(dtype).cuda()
            for h, std in ((hq, qk_std), (hkv, qk_std), (hkv, 0.3))]


def fa_plain(q, k, v, window=0, causal=True):
    """The wrapper's plain version, in the model's layout."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def fa_library(q, k, v, causal=True, window=0):
    """One PyTorch call for the same function (the yardstick; the port
    never calls it): SDPA with GQA, causal or not, and with a window as a
    boolean mask of the visible (query, key) pairs."""
    mask = None
    if window:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(q.shape[1], device=q.device)[None, :]
        mask = (i - j < window) & ((j <= i) if causal else True)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True).transpose(1, 2)


def fa_bound(q, k, v, window=0, causal=True):
    """The least time for attention of these (unpadded) tensors: q, k and
    v read once and the output ([B, S, Hq, Dv]) written once, and 2 Dqk +
    2 Dv operations a visible (query, key) pair and query head."""
    b, s, hq, dq = q.shape
    dv = v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * hq * dv) * \
        q.element_size()
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    seen = ((j <= i) if causal else True) & \
        ((i - j < window) if window else True)
    seen = np.broadcast_to(seen, (s, s))
    flops = 2 * (dq + dv) * int(seen.sum()) * b * hq  # QK^T, PV
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, flops


def flash_attention_phase(rec):
    checks = []
    both = (torch.float32, torch.bfloat16)
    cases = [(shape, dt, True, 0, 0.3) for shape in FA_SHAPES for dt in both]
    cases += [((1, 2, 2, 256, 64), dt, True, w, 0.3) for w in (32, 128)
              for dt in both]
    cases += [(shape, torch.bfloat16, causal, w, std)
              for shape, causal, w, std in FA_BF16_CASES]
    # the LM FACADE path's step-2c feature pass (bf16, causal, its window)
    cases.append((FA_LM, torch.bfloat16, True, LM_CFG.sliding_window, 0.3))
    # stablelm-12b's serving shape (D 160), and D 160 non-causal at a
    # ragged S (its one-ulp misses at large scores are counted by
    # tools/fa_accuracy.py)
    cases += [(FA_D160, dt, True, 0, 0.3) for dt in both]
    cases.append(((1, 4, 2, 130, 160), torch.bfloat16, False, 0, 0.3))
    # the hybrid, audio and VLM families' shapes (hymba past its window,
    # whisper's non-causal encoder at S 1500, llava's image prefix)
    cases += [(shape, dt, causal, w, 0.3)
              for shape, causal, w, _ in FA_FAMILIES.values() for dt in both]
    # last: the serving shape in bf16, whose error the kernels line reports
    cases += [(shape, dt, True, 0, 0.3) for dt in both
              for shape in ((1, 4, 2, 200, 64), FA_LONG, FA_SERVE)]
    for i, (shape, dtype, causal, window, qk_std) in enumerate(cases):
        q, k, v = fa_inputs(*shape, dtype, seed=i, qk_std=qk_std)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa_plain(q.float(), k.float(), v.float(), window, causal)
        checks.append(check("flash_attention", got, want, *FA_TOL[dtype],
                            shape=list(shape), dtype=str(dtype),
                            causal=causal, window=window, qk_std=qk_std))
        del got, want
    # MLA at minicpm3-4b's width through models.attention's padded call,
    # against the plain sdpa on the unpadded tensors
    mla_checks = []
    for i, dtype in enumerate(both):
        q, k, v = mla_inputs(*FA_MLA, dtype, seed=100 + i)
        got = attention.mla_attention(q, k, v)
        torch.cuda.synchronize()
        want = mla_plain(q.float(), k.float(), v.float())
        mla_checks.append(check("flash_attention mla", got, want,
                                *FA_TOL[dtype], shape=list(FA_MLA),
                                dtype=str(dtype), padded_d=min(
                                    d for d in attention.HEAD_DIMS
                                    if d >= max(FA_MLA[3:]))))
        del got, want
    rec["flash_attention_checks"] = checks
    rec["flash_attention_mla_checks"] = mla_checks

    timing = {label: fa_timing(label, shape, calls) for label, shape, calls
              in (("serve", FA_SERVE, 50), ("long", FA_LONG, 5),
                  ("d160", FA_D160, 50))}
    timing["mla"] = mla_timing(FA_MLA, 50)
    for label, (shape, causal, w, calls) in FA_FAMILIES.items():
        timing[label] = fa_timing(label, shape, calls, causal=causal,
                                  window=w)
    rec["flash_attention_timing"] = timing
    shapes = {"d160": dict(timing["d160"], max_abs_err=[
        c["max_abs_err"] for c in checks if c["shape"] == list(FA_D160)]),
        "mla": dict(timing["mla"], max_abs_err=[
            c["max_abs_err"] for c in mla_checks])}
    for label, (shape, _, _, _) in FA_FAMILIES.items():
        shapes[label] = dict(timing[label], max_abs_err=[
            c["max_abs_err"] for c in checks if c["shape"] == list(shape)])
    t = timing["serve"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "launches": None, "max_abs_err": checks[-1]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shapes": shapes}


def mla_inputs(b, h, s, dq, dv, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [(0.3 * torch.randn((b, s, h, d), generator=g)).to(dtype).cuda()
            for d in (dq, dq, dv)]


def mla_plain(q, k, v):
    """The plain ``sdpa`` of ``models.attention`` on the unpadded MLA
    tensors (the differentiable attention the model trains through)."""
    pos = torch.arange(q.shape[1], device=q.device)[None].expand(
        q.shape[0], -1)
    return attention.sdpa(q, k, v, pos, pos)


def mla_library(q, k, v):
    """One PyTorch call for the same function on the unpadded tensors (it
    takes a v head dim other than q's and k's)."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)


def mla_timing(shape, calls) -> dict:
    """MLA's kernel call as the model makes it (``attention.mla_attention``:
    the pads, the launch at D 128 and the slice), the kernel alone on
    tensors padded beforehand, the plain ``sdpa`` and SDPA on the unpadded
    tensors, in bf16; the bound from the unpadded work."""
    q, k, v = mla_inputs(*shape, torch.bfloat16, seed=99)
    d = min(x for x in attention.HEAD_DIMS if x >= max(shape[3:]))
    qp, kp, vp = (F.pad(x, (0, d - x.shape[-1])) for x in (q, k, v))
    scale = 1.0 / shape[3] ** 0.5
    bound_ms, bound_by, nbytes, flops = fa_bound(q, k, v)
    t = {"shape": list(shape), "padded_d": d, "dtype": "bf16",
         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
         "flops": flops}
    for key, fn in (("ms", lambda: attention.mla_attention(q, k, v)),
                    ("kernel_ms", lambda: flash_attention(qp, kp, vp,
                                                          scale=scale)),
                    ("plain_ms", lambda: mla_plain(q, k, v)),
                    ("library_ms", lambda: mla_library(q, k, v)),
                    ("ms_again", lambda: attention.mla_attention(q, k, v)),
                    ("plain_ms_again", lambda: mla_plain(q, k, v))):
        t[key] = graph_ms(fn, calls=calls)
    log("flash_attention timing mla", json.dumps(t))
    return t


def fa_timing(label, shape, calls, causal=True, window=0) -> dict:
    """K2, its plain version and SDPA timed in bf16 at ``shape``, beside
    the bound (each graph and its memory released after its timing)."""
    q, k, v = fa_inputs(*shape, torch.bfloat16, seed=99)
    bound_ms, bound_by, nbytes, flops = fa_bound(q, k, v, window, causal)
    t = {"shape": list(shape), "dtype": "bf16", "causal": causal,
         "window": window, "bound_ms": bound_ms, "bound_by": bound_by,
         "bytes": nbytes, "flops": flops,
         "library": ("scaled_dot_product_attention, GQA, "
                     + ("boolean window mask" if window else
                        "is_causal" if causal else "no mask"))}

    def kernel():
        return flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return fa_plain(q, k, v, window, causal)

    def library():
        return fa_library(q, k, v, causal, window)

    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library), ("ms_again", kernel),
                    ("plain_ms_again", plain)):
        t[key] = graph_ms(fn, calls=calls)
    log(f"flash_attention timing {label}", json.dumps(t))
    return t


def wkv_inputs(b, s, h, hd, seed, log_decay=0.0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.3 * torch.randn((3, b, s, h, hd), generator=g)).unbind(0)
    w = torch.exp(-torch.exp(log_decay + 0.3 * torch.randn((b, s, h, hd),
                                                           generator=g)))
    u = 0.3 * torch.randn((h, hd), generator=g)
    return [x.contiguous().cuda() for x in (r, k, v, w, u)]


def wkv_bound(r, sm_clock_hz):
    b, s, h, hd = r.shape
    nbytes = 4 * (5 * r.numel() + b * h * hd * hd + h * hd)
    flops = 5 * b * s * h * hd * hd      # y: 2 hd^2, state: 3 hd^2
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    # S dependent steps: at least one fp32 FMA latency each on the state
    serial_ms = s * FMA_LATENCY_CYCLES / sm_clock_hz * 1e3
    # issue floor: the steps of one (b, h) run on one SM, each about 3 hd^2
    # fp32 instructions over its 128 lanes, in waves of one (b, h) per SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-b * h // sms)
    issue_ms = waves * s * 3 * hd * hd / 128 / sm_clock_hz * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, flops, \
        serial_ms, issue_ms


def wkv_phase(rec, sm_clock_hz):
    checks = []
    cases = [(shape, 0.0) for shape in RW_SHAPES + [RW_RAGGED]]
    cases += RW_CASES + [(RW_TRAIN, 0.0), (RW_SERVE, 0.0)]
    for i, (shape, log_decay) in enumerate(cases):
        args = wkv_inputs(*shape, seed=i, log_decay=log_decay)
        y, s_f = wkv(*args)
        torch.cuda.synchronize()
        y_ref, s_ref = wkv_scan(*args)
        c = check("wkv y", y, y_ref, RW_TOL, shape=list(shape),
                  log_decay=log_decay)
        c["state_max_abs_err"] = check("wkv state", s_f, s_ref, RW_TOL,
                                       shape=list(shape),
                                       log_decay=log_decay)["max_abs_err"]
        checks.append(c)
    rec["wkv_checks"] = checks

    timing = {label: wkv_timing(shape, sm_clock_hz) for label, shape in
              (("train", RW_TRAIN), ("serve", RW_SERVE))}
    rec["wkv_timing"] = timing
    log("wkv timing", json.dumps(timing))
    t = timing["serve"]
    fwd = {"name": "wkv", "route": "cuda",
           "source": "src/repro_torch/csrc/wkv.cu",
           "replaces": "src/repro/kernels/rwkv6/kernel.py:53",
           "launches": None,
           "max_abs_err": max(checks[-1]["max_abs_err"],
                              checks[-1]["state_max_abs_err"]),
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": None, "train": timing["train"]}
    return fwd, wkv_backward_phase(rec, sm_clock_hz)


def wkv_backward_phase(rec, sm_clock_hz) -> dict:
    """K3's backward (``wkv_backward``) against the float64 witness at
    ``RW_BWD_CASES``, with y's gradient alone and with the final state's,
    the same bits twice; timed at the round's shape beside its bound and
    the plain version (autograd through ``wkv_scan``), and one
    ``wkv_train`` backward as training runs it (events and host clock);
    returns its entry of the kernels line (launches filled in later)."""
    checks = [wkv_backward_check(shape, log_decay, with_state, seed=200 + i)
              for i, (shape, log_decay) in enumerate(RW_BWD_CASES)
              for with_state in (False, True)]
    rec["wkv_backward_checks"] = checks
    t = wkv_backward_timing(RW_TRAIN, sm_clock_hz)
    t["wkv_train_backward"] = wkv_train_backward_timing(RW_TRAIN)
    rec["wkv_backward_timing"] = t
    log("wkv backward timing", json.dumps(t))
    return {"name": "wkv_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv_backward.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:53 (its "
                        "gradient; the TPU kernel is forward-only)",
            "launches": None, "max_abs_err": checks[0]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "train": t}


def wkv_grad_seeds(shape, seed, with_state):
    """An output gradient for y and, ``with_state``, for the final state,
    drawn from ``seed`` on the CPU and moved to the card."""
    b, s, h, hd = shape
    g = torch.Generator().manual_seed(seed)
    gy = torch.randn((b, s, h, hd), generator=g).cuda()
    gs = (torch.randn((b, h, hd, hd), generator=g).cuda() if with_state
          else None)
    return gy, gs


def wkv_plain_grads(args, gy, gs, dtype):
    """(dr, dk, dv, dw, du): autograd through the plain ``wkv_scan`` on the
    card, the inputs and output gradients cast to ``dtype``."""
    leaves = [x.detach().to(dtype).requires_grad_() for x in args]
    y, s_final = wkv_scan(*leaves)
    outs, grads = [y], [gy.to(dtype)]
    if gs is not None:
        outs.append(s_final)
        grads.append(gs.to(dtype))
    return torch.autograd.grad(outs, leaves, grads, materialize_grads=True)


def wkv_backward_check(shape, log_decay, with_state, seed,
                       explicit=True) -> dict:
    """K3's backward at ``shape`` against the plain loop in float64 (the
    witness) beside the plain fp32 loop (the control), each of dr, dk, dv,
    dw and du relative to the witness's largest |gradient|, by the gate of
    ``RW_BWD_FACTOR``, ``RW_BWD_FLOOR`` and ``RW_TOL``; two calls on the
    same inputs give the same bits; with ``explicit``, the kernel's order
    in plain PyTorch (``wkv_backward_scan`` in the kernel's chunks, fp32)
    within ``RW_TOL`` of the witness too; or raise."""
    args = wkv_inputs(*shape, seed=seed, log_decay=log_decay)
    gy, gs = wkv_grad_seeds(shape, seed + 1000, with_state)
    got = wkv_backward(*args, gy, gs)
    again = wkv_backward(*args, gy, gs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    plain = wkv_plain_grads(args, gy, gs, torch.float32)
    witness = wkv_plain_grads(args, gy, gs, torch.float64)
    chunk = wkv_ops._backward_library().wkv_backward_chunk(shape[3])
    order = (wkv_backward_scan(*args, gy, gs, chunk=chunk) if explicit
             else (None,) * 5)
    leaves, ok = {}, same
    for name, g, p, x, o in zip(("dr", "dk", "dv", "dw", "du"), got, plain,
                                witness, order):
        scale = float(x.abs().max())
        finite = bool(torch.isfinite(g).all())
        e_o = None
        if scale == 0.0:        # w's gradient at S 1 without the state's
            e_k, e_p = float(g.abs().max()), float(p.abs().max())
            passes = e_k == 0.0
        else:
            e_k = float((g.double() - x).abs().max()) / scale
            e_p = float((p.double() - x).abs().max()) / scale
            passes = e_k <= min(max(RW_BWD_FACTOR * e_p, RW_BWD_FLOOR),
                                RW_TOL)
            if o is not None:
                e_o = float((o.double() - x).abs().max()) / scale
                passes = passes and e_o <= RW_TOL
        leaves[name] = {"scale": scale, "kernel_rel": e_k, "plain_rel": e_p,
                        "explicit_rel": e_o,
                        "ratio": e_k / e_p if e_p else None,
                        "max_abs_err_vs_plain": float((g - p).abs().max()),
                        "ok": passes and finite}
        ok = ok and passes and finite
    rec = {"shape": list(shape), "log_decay": log_decay,
           "with_state": with_state, "same_bits_twice": same,
           "max_abs_err": max(v["max_abs_err_vs_plain"]
                              for v in leaves.values()),
           "leaves": leaves}
    log("wkv backward check", json.dumps(rec))
    if not ok:
        raise AssertionError(f"wkv backward fails its gate against the "
                             f"float64 witness: {rec}")
    return rec


def wkv_backward_bound(r, sm_clock_hz):
    """The backward's bound at r's shape for y's gradient alone: bytes (r,
    k, v, w, dy and u read, dr, dk, dv, dw and du written) and the
    function's 14 hd^2 fp32 operations a step and
    (b, h) (the state 3, dr, dk, dv and dw 2 each, dS 3); the issue floor
    of the design's 10 fp32 instructions an element a step (the state in
    each of its two forward passes 2, the walk 6) over one SM's 128 lanes,
    in waves of one (b, h) per SM."""
    b, s, h, hd = r.shape
    nbytes = 4 * (9 * r.numel() + 2 * h * hd)
    flops = 14 * b * s * h * hd * hd
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-b * h // sms)
    issue_ms = waves * s * 10 * hd * hd / 128 / sm_clock_hz * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, flops, \
        issue_ms


def wkv_backward_timing(shape, sm_clock_hz, calls=20, reps=7,
                        plain=True) -> dict:
    """K3's backward (y's gradient alone, as training runs it) timed at
    ``shape`` by CUDA-graph replays, beside its bound, its issue floor,
    its workspace and, with ``plain``, the plain version (autograd through
    ``wkv_scan``, between events)."""
    args = wkv_inputs(*shape, seed=98)
    gy, _ = wkv_grad_seeds(shape, 97, False)
    bound_ms, bound_by, nbytes, flops, issue_ms = wkv_backward_bound(
        args[0], sm_clock_hz)
    b, s, h, hd = shape
    chunk = wkv_ops._backward_library().wkv_backward_chunk(hd)
    t = {"shape": list(shape), "bound_ms": bound_ms, "bound_by": bound_by,
         "bytes": nbytes, "flops": flops, "issue_floor_ms": issue_ms,
         "workspace_bytes": 4 * b * h * -(-s // chunk) * hd * hd,
         "sm_clock_hz": sm_clock_hz}

    def kernel():
        return wkv_backward(*args, gy)

    t["ms"] = graph_ms(kernel, calls=calls, reps=reps)
    if plain:
        t["plain_ms"] = event_ms(
            lambda: wkv_plain_grads(args, gy, None, torch.float32))
    t["ms_again"] = graph_ms(kernel, calls=calls, reps=reps)
    return t


def wkv_timing(shape, sm_clock_hz) -> dict:
    """K3 and its plain version timed at ``shape``, beside the bound and
    the serial and issue floors."""
    args = wkv_inputs(*shape, seed=99)
    bound_ms, bound_by, nbytes, flops, serial_ms, issue_ms = wkv_bound(
        args[0], sm_clock_hz)
    t = {"shape": list(shape), "bound_ms": bound_ms,
         "bound_by": bound_by, "bytes": nbytes, "flops": flops,
         "serial_floor_ms": serial_ms, "issue_floor_ms": issue_ms,
         "sm_clock_hz": sm_clock_hz}
    for key, fn, calls in (("ms", wkv, 50), ("plain_ms", wkv_scan, 2),
                           ("ms_again", wkv, 50)):
        t[key] = graph_ms(lambda: fn(*args), calls=calls)
    return t


def wkv_train_backward_timing(shape, reps: int = 5) -> dict:
    """One ``wkv_train`` backward at ``shape`` as the training path runs it
    (eager: one launch of the backward kernel): CUDA events and the host
    clock around ``torch.autograd.grad`` of y, the median of ``reps``
    after one warm-up."""
    leaves = [x.requires_grad_() for x in wkv_inputs(*shape, seed=98)]
    y, _ = wkv_train(*leaves)
    grad_y = torch.randn_like(y)
    device_ms, host_ms = [], []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        torch.autograd.grad(y, leaves, grad_y, retain_graph=True)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    return {"shape": list(shape), "events_ms": statistics.median(
        device_ms[1:]), "host_ms": statistics.median(host_ms[1:])}


def device_profile(fn, host_spans=(), kernels=(), host=True) -> dict:
    """Host wall time of ``fn()`` (ending in a synchronise) and the device
    time of the kernels it ran, by ``torch.profiler``: busy time (the
    union of the kernels' intervals, since kernels of forked streams, a
    graph's branches among them, run side by side; ``kernel_s`` is their
    sum) and share, and the largest kernels by name ([name, seconds,
    launches recorded]); for each
    string in ``host_spans``, the host time of the profiler's host events
    whose names hold it (their own and their children's) and their count.
    The profiler's raw events are read as they come (a round of hymba's
    plain scan records about a million; building its event tree would
    take minutes), and the seconds the profiler took to stop and to be read
    are recorded; for each string in ``kernels``, the device kernels whose
    names hold it, as [events, seconds]. Where the profiler records no
    device events, the device numbers are None (not measured). With
    ``host`` False the profiler records the device's activity alone (no
    host operators: a round of the plain SSM scan records millions, and
    the profiler then takes tens of seconds to stop), and ``host_spans``
    find nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                            else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    by_name, count, intervals = {}, {}, []
    spans = {name: [0.0, 0] for name in host_spans}
    events = prof.profiler.kineto_results.events()
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            by_name[name] = by_name.get(name, 0.0) + e.duration_ns() * 1e-9
            count[name] = count.get(name, 0) + 1
            intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            for span in spans:
                if span in name:
                    spans[span][0] += e.duration_ns() * 1e-9
                    spans[span][1] += 1
    busy, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    busy *= 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_s": wall, "device_busy_s": busy if by_name else None,
           "busy_share": busy / wall if by_name else None,
           "kernel_s": sum(by_name.values()) if by_name else None,
           "kernel_names": len(by_name),
           "top_kernels_s": [[n[:80], t, count[n]] for n, t in top],
           "events": len(events), "profiler_stop_s": t1 - t0 - wall,
           "profiler_read_s": time.perf_counter() - t1}
    if kernels:
        out["kernels"] = {k: [sum(c for n, c in count.items() if k in n),
                              sum(t for n, t in by_name.items() if k in n)]
                          for k in kernels}
    if spans:
        out["host_spans"] = {name: {"host_s": secs, "events": n,
                                    "share_of_wall": secs / wall}
                             for name, (secs, n) in spans.items()}
    return out


def serve_phase(rec, arch: str, kernel, traced: bool = True,
                n_layers: int | None = None) -> int:
    """Serve ``arch`` at full width on the card (``n_layers``: keep only
    that many of its layers, every width as published); returns
    ``kernel``'s launches in the measured run. ``traced``: serve once more
    under both of the CLI's overlays (``traced_serve``)."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    cut = None
    if n_layers is not None:
        cut = f"{n_layers} of {cfg.n_layers} layers, every width as published"
        cfg = cfg.replace(n_layers=n_layers)
    settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    queue = make_requests(np.random.default_rng(0), N_REQUESTS,
                          SERVE["prompt_len"], cfg.vocab_size)
    serve(cfg, params, queue[:1], device="cuda",
          **dict(SERVE, gen_len=2))                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    with counted() as counts:
        res = serve(cfg, params, queue, device="cuda", **SERVE)
    batches = len(res.batch_sizes)
    want = {fn.__name__: 0 for fn in KERNELS}
    want[kernel.__name__] = cfg.n_layers * batches
    if counts != want:
        raise AssertionError(f"{arch}: kernel launches {counts}, want {want}")
    if not res.finite:
        raise AssertionError(f"{arch}: non-finite logits")
    if res.tokens.shape != (N_REQUESTS, SERVE["gen_len"]):
        raise AssertionError(f"{arch}: tokens {res.tokens.shape}")

    # decode steps alone launch no kernel
    toks = torch.from_numpy(np.stack([q[:16] for q in queue[:2]])).cuda()
    logits, cache = transformer.prefill(cfg, params, toks, cache_extra=4)
    pos = torch.full((2,), 16, dtype=torch.int32, device="cuda")
    with counted() as decode_counts:
        for _ in range(4):
            logits, cache = transformer.decode_step(
                cfg, params, cache, logits.argmax(-1)[:, None], pos)
            pos = pos + 1
        torch.cuda.synchronize()
    if any(decode_counts.values()):
        raise AssertionError(f"{arch}: decode launched {decode_counts}")
    del logits, cache
    traced = (traced_serve(arch, cfg, params, queue, res, want) if traced
              else None)

    # where the time goes: one batch's prefill, then 8 decode steps
    batch = np.zeros((SERVE["batch"], SERVE["prompt_len"]), np.int32)
    for i, q in enumerate(queue[:SERVE["batch"]]):
        batch[i, :len(q)] = q
    toks = torch.from_numpy(batch).cuda()
    state = {}

    def run_prefill():
        state["out"] = transformer.prefill(
            cfg, params, toks, cache_extra=SERVE["gen_len"])

    def run_decode():
        logits, cache = state["out"]
        pos = torch.full((SERVE["batch"],), SERVE["prompt_len"],
                         dtype=torch.int32, device="cuda")
        for _ in range(8):
            logits, cache = transformer.decode_step(
                cfg, params, cache, logits.argmax(-1)[:, None], pos)
            pos = pos + 1

    profiles = {"prefill": device_profile(run_prefill),
                "decode_8_steps": device_profile(run_decode)}
    log(f"serve {arch} profile", json.dumps(profiles))
    del state
    peak = torch.cuda.max_memory_allocated()
    image_prefill = (vlm_prefill(arch, cfg, params)
                     if cfg.arch_type == "vlm" else None)

    out = {"launches": counts, "batches": batches, "n_layers": cfg.n_layers,
           "cut": cut, "params": api.param_count(params),
           "param_bytes": api.param_bytes(params), "init_s": init_s,
           "init_peak_bytes": init_peak,
           "prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "prefill_tok_s": res.prefill_tok_s,
           "decode_tok_s": res.decode_tok_s,
           "peak_mem_bytes": peak,
           "first_tokens": res.tokens[:, :8].tolist(), **SERVE,
           "requests": N_REQUESTS, "profile": profiles, "traced": traced,
           "image_prefill": image_prefill}
    del params
    settled_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    rec.setdefault("serve", {})[arch] = out
    log(f"serve {arch}{f' ({cut})' if cut else ''}: {out['params']} "
        f"params, {out['param_bytes'] / 1e9:.2f} GB, init peak "
        f"{init_peak / 1e9:.2f} GB, peak {out['peak_mem_bytes'] / 1e9:.2f} "
        f"GB; {batches} batches, {counts[kernel.__name__]} "
        f"{kernel.__name__} launches; prefill {res.prefill_tok_s:.1f} "
        f"tok/s, decode {res.decode_tok_s:.1f} tok/s (per batch prefill "
        f"{res.prefill_s} s, decode {res.decode_s} s); phase "
        f"{out['phase_s']:.1f} s")
    return counts[kernel.__name__]


def vlm_prefill(arch, cfg, params) -> dict:
    """A VLM batch with its image prefix (``VLM_PREFILL``): each request's
    ``n_image_tokens`` patch embeddings in front of its prompt, prefilled
    in one call (K2 once a layer, at S = n_img + prompt), then greedy
    decode steps at positions ``n_img + prompt ..`` (no kernel); after an
    untimed warm-up. Prefill tokens per second count the image and the
    text positions. Finite logits; the prefill's profile and the peak
    memory."""
    b, s, gen = (VLM_PREFILL[k] for k in ("batch", "prompt_len",
                                          "gen_len"))
    n_img = cfg.n_image_tokens
    g = torch.Generator("cuda").manual_seed(1)
    img = (VLM_PREFILL["img_std"] * torch.randn(
        (b, n_img, cfg.d_model), generator=g, device="cuda")).to(cfg.dt)
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=g,
                         device="cuda", dtype=torch.int32)

    def run_prefill():
        return transformer.prefill(cfg, params, toks, img_embeds=img,
                                   cache_extra=gen)

    run_prefill()                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted() as pre_counts:
        t0 = time.perf_counter()
        logits, cache = run_prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    out_tokens = []
    pos = torch.full((b,), n_img + s, dtype=torch.int32, device="cuda")
    with counted() as dec_counts:
        t0 = time.perf_counter()
        for _ in range(gen):
            last = logits.argmax(-1)
            out_tokens.append(last)
            logits, cache = transformer.decode_step(cfg, params, cache,
                                                    last[:, None], pos)
            finite &= torch.isfinite(logits).all()
            pos = pos + 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    slots = int(cache["slot_pos"].shape[-1])
    del logits, cache
    want = {fn.__name__: 0 for fn in KERNELS}
    want_pre = dict(want, flash_attention=cfg.n_layers)
    out = {"launches": pre_counts, "decode_launches": dec_counts,
           "batch": b, "image_positions": n_img, "prompt_len": s,
           "gen_len": gen, "cache_slots": slots, "prefill_s": prefill_s,
           "prefill_tok_s": b * (n_img + s) / prefill_s,
           "prefill_tok_s_counts": "image and text positions",
           "decode_s": decode_s, "decode_tok_s": b * gen / decode_s,
           "peak_mem_bytes": peak, "finite": bool(finite),
           "first_tokens": torch.stack(out_tokens, 1)[:, :8].tolist()}
    out["profile"] = device_profile(run_prefill)
    log(f"serve {arch} image-prefix prefill: {json.dumps(out)}")
    if not (pre_counts == want_pre and dec_counts == want and out["finite"]
            and slots == n_img + s + gen):
        raise AssertionError(f"{arch} image-prefix prefill: {out}")
    return out


def whisper_phase(rec) -> int:
    """whisper-tiny at full width (bf16, parameters from the port's init on
    the card; ``WHISPER``): frames ``[B, 1500, 384]`` from a seeded
    generator (the audio frontend is a stub); ``encode`` (K2 once an
    encoder layer, non-causal at S 1500), the teacher-forced ``forward``
    of a 64-token decoder prompt (K2 once an encoder layer and once a
    decoder self-attention layer: 8 a call; cross-attention is the plain
    ``sdpa``), then ``init_cache`` (its encode: K2 once an encoder layer)
    with room for the prompt and the generated tokens, the prompt decoded
    step by step and 32 greedy steps (no kernel); each timed after an
    untimed warm-up. Finite features and logits; returns K2's launches in
    one ``forward``."""
    t_phase = time.perf_counter()
    cfg = WHISPER_CFG
    b, s, gen = WHISPER["batch"], WHISPER["prompt_len"], WHISPER["gen_len"]
    settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                         device="cuda").to(cfg.dt)
    prompt = torch.randint(1, cfg.vocab_size, (b, s), generator=g,
                           device="cuda", dtype=torch.int32)
    whisper.forward(cfg, params, prompt, frames)        # warm-up
    torch.cuda.synchronize()

    def timed(fn):
        with counted() as counts:
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return value, secs, counts

    enc, encode_s, enc_counts = timed(
        lambda: whisper.encode(cfg, params, frames))
    (feats, _), forward_s, fwd_counts = timed(
        lambda: whisper.forward(cfg, params, prompt, frames))
    cache, init_s, init_counts = timed(
        lambda: whisper.init_cache(cfg, params, frames, b, s + gen))
    state = {"cache": cache, "finite": torch.isfinite(enc).all()
             & torch.isfinite(feats).all(), "tokens": []}

    def step(tok, pos):
        logits, state["cache"] = whisper.decode_step(
            cfg, params, state["cache"], tok[:, None],
            torch.full((b,), pos, dtype=torch.int32, device="cuda"))
        state["finite"] &= torch.isfinite(logits).all()
        return logits

    def decode_prompt():
        for t in range(s):
            state["logits"] = step(prompt[:, t], t)

    def decode_greedy():
        for t in range(gen):
            last = state["logits"].argmax(-1)
            state["tokens"].append(last)
            state["logits"] = step(last, s + t)

    _, prompt_s, prompt_counts = timed(decode_prompt)
    _, decode_s, decode_counts = timed(decode_greedy)
    finite = bool(state["finite"])
    none = {fn.__name__: 0 for fn in KERNELS}
    out = {"launches": {"encode": enc_counts, "forward": fwd_counts,
                        "init_cache": init_counts,
                        "prompt_decode": prompt_counts,
                        "greedy_decode": decode_counts},
           "batch": b, "frames": cfg.encoder_seq, "prompt_len": s,
           "gen_len": gen, "params": api.param_count(params),
           "param_bytes": api.param_bytes(params), "encode_s": encode_s,
           "forward_s": forward_s, "init_cache_s": init_s,
           "prompt_decode_s": prompt_s, "decode_s": decode_s,
           "decode_tok_s": b * gen / decode_s, "finite": finite,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "first_tokens": torch.stack(state["tokens"], 1)[:, :8].tolist()}
    del params, state, cache, enc, feats
    settled_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    rec["whisper"] = out
    log(f"whisper-tiny: {json.dumps(out)}")
    want = {"encode": dict(none, flash_attention=cfg.encoder_layers),
            "forward": dict(none, flash_attention=cfg.encoder_layers
                            + cfg.n_layers),
            "init_cache": dict(none, flash_attention=cfg.encoder_layers),
            "prompt_decode": none, "greedy_decode": none}
    if out["launches"] != want or not finite:
        raise AssertionError(f"whisper-tiny: launches {out['launches']}, "
                             f"want {want}; finite {finite}")
    return fwd_counts["flash_attention"]


def smoke_whisper(out: dict) -> None:
    """whisper-tiny's smoke config (fp32, ``WHISPER_SMOKE``) on the card
    and on the CPU with the same parameters, frames and prompt: ``encode``
    within SMOKE_LOGIT_TOL; the prompt decoded step by step from
    ``init_cache`` then greedy steps, tokens equal; on the card, the
    decode logits at the prompt's positions against the teacher-forced
    ``forward``'s within SMOKE_LOGIT_TOL, and K2's launches (encode,
    forward and init_cache: encoder layers, encoder and decoder layers,
    encoder layers)."""
    cfg = get_config("whisper-tiny", smoke=True)
    b, s, gen = (WHISPER_SMOKE[k] for k in ("batch", "prompt_len",
                                            "gen_len"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    prompt = torch.randint(1, cfg.vocab_size, (b, s), generator=g,
                           dtype=torch.int32)

    def run(device):
        p = tree_map(lambda t: t.to(device), params)
        fr, pr = frames.to(device), prompt.to(device)
        enc = whisper.encode(cfg, p, fr)
        feats, _ = whisper.forward(cfg, p, pr, fr)
        full = (feats @ whisper.lm_head_weight(p)).float()
        cache = whisper.init_cache(cfg, p, fr, b, s + gen)
        at_prompt, tokens = [], []
        for t in range(s + gen):
            if t < s:
                tok = pr[:, t]
            else:
                tok = logits.argmax(-1)
                tokens.append(tok)
            logits, cache = whisper.decode_step(
                cfg, p, cache, tok[:, None],
                torch.full((b,), t, dtype=torch.int32, device=device))
            if t < s:
                at_prompt.append(logits)
        return (enc.cpu(), full.cpu(), torch.stack(at_prompt, 1).cpu(),
                torch.stack(tokens, 1).cpu())

    cpu = run("cpu")
    with counted() as counts:
        gpu = run("cuda")
    res = {"encode_max_diff": float((gpu[0] - cpu[0]).abs().max()),
           "forward_logit_max_diff": float((gpu[1] - cpu[1]).abs().max()),
           "decode_vs_forward_max_diff": float(
               (gpu[2] - gpu[1]).abs().max()),
           "tokens_equal": bool(torch.equal(gpu[3], cpu[3])),
           "launches": counts}
    want = dict({fn.__name__: 0 for fn in KERNELS},
                flash_attention=3 * cfg.encoder_layers + cfg.n_layers)
    out["whisper-tiny"] = res
    log(f"smoke whisper-tiny: card vs CPU {json.dumps(res)}")
    if not (res["tokens_equal"] and counts == want
            and res["encode_max_diff"] <= SMOKE_LOGIT_TOL
            and res["forward_logit_max_diff"] <= SMOKE_LOGIT_TOL
            and res["decode_vs_forward_max_diff"] <= SMOKE_LOGIT_TOL):
        raise AssertionError(f"whisper-tiny smoke: {res}, launches want "
                             f"{want}")


def traced_serve(arch, cfg, params, queue, plain, want) -> dict:
    """The serve of ``serve_phase`` again with both of the CLI's overlays:
    ``net=edge-v2`` (the wire model's simulated seconds) and a tracer into
    ``build/obs/serve-<arch>.jsonl``. The same tokens as the untraced run
    (``plain``), the same kernel launches (``want``), and the trace's
    records counted: a ``prefill`` and a ``decode`` span and a
    ``queue.wait`` event a batch, one ``slo`` event; its prefill tokens
    per second beside the untraced run's."""
    path = ROOT / "build" / "obs" / f"serve-{arch}.jsonl"
    net = NetworkConfig.preset("edge-v2")
    tracer = Tracer(sink=JsonlSink(path))
    with counted() as counts:
        res = serve(cfg, params, queue, device="cuda", net=net,
                    tracer=tracer, **SERVE)
    tracer.sink.close()
    recs = read_jsonl(path)
    batches = len(res.batch_sizes)
    names = [r["name"] for r in recs]
    got = {"launches": counts, "records": len(recs),
           "prefill_spans": names.count("prefill"),
           "decode_spans": names.count("decode"),
           "queue_wait_events": names.count("queue.wait"),
           "slo_events": names.count("slo"),
           "sim_net_s": res.comm.seconds[-1], "net_gb": res.comm.total_gb,
           "prefill_tok_s": res.prefill_tok_s,
           "untraced_prefill_tok_s": plain.prefill_tok_s,
           "prefill_tok_s_vs_untraced": (res.prefill_tok_s
                                         / plain.prefill_tok_s),
           "decode_tok_s": res.decode_tok_s,
           "untraced_decode_tok_s": plain.decode_tok_s,
           "tokens_equal": bool(np.array_equal(res.tokens, plain.tokens))}
    log(f"serve {arch} traced --net edge-v2: {json.dumps(got)}")
    if not (counts == want and got["tokens_equal"] and res.finite
            and got["prefill_spans"] == got["decode_spans"] == batches
            and got["queue_wait_events"] == batches
            and got["slo_events"] == 1 and names[-1] == "slo"
            and got["sim_net_s"] > 0):
        raise AssertionError(f"{arch} traced serve: {json.dumps(got)}")
    return got


def smoke_serve_phase(rec):
    """The smoke configs of ``SMOKE_SERVE_ARCHS`` (fp32; the VLM text
    only, as ``serve`` takes it) served on the card and on the CPU with
    the same parameters, and hymba-smoke once more past its window
    (``SMOKE_SERVE_LONG``): equal greedy tokens, prefill logits within
    1e-4; then whisper-smoke (``smoke_whisper``)."""
    t0 = time.perf_counter()
    out = {}
    runs = [(arch, arch, SMOKE_SERVE) for arch in SMOKE_SERVE_ARCHS]
    runs += [(f"{arch} prompt {kw['prompt_len']}", arch, kw)
             for arch, kw in SMOKE_SERVE_LONG.items()]
    for label, arch, kw in runs:
        cfg = get_config(arch, smoke=True)
        params = api.init_params(cfg, torch.Generator().manual_seed(0))
        queue = make_requests(np.random.default_rng(0), 4,
                              kw["prompt_len"], cfg.vocab_size)
        cpu = serve(cfg, params, queue, device="cpu", **kw)
        gpu = serve(cfg, tree_map(lambda t: t.cuda(), params), queue,
                    device="cuda", **kw)
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(gpu.prefill_logits, cpu.prefill_logits))
        same = bool(np.array_equal(gpu.tokens, cpu.tokens))
        out[label] = {"prefill_logit_max_diff": diff, "tokens_equal": same,
                      "prompt_len": kw["prompt_len"],
                      "window": cfg.sliding_window}
        log(f"smoke serve {label}: card vs CPU {json.dumps(out[label])}")
        if not (same and diff <= SMOKE_LOGIT_TOL and gpu.finite):
            raise AssertionError(f"{label}: card and CPU disagree {out}")
    smoke_whisper(out)
    rec["smoke_serve"] = out
    rec["smoke_serve_s"] = time.perf_counter() - t0
    log(f"smoke serve: {rec['smoke_serve_s']:.1f} s")


def to_device(tree, dev):
    """A step's arguments (dicts, tuples, a ``FacadeState``, tensors and
    plain values) with every tensor on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def float_leaves(tree) -> list:
    """The floating-point tensors of a step's output, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in float_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in float_leaves(v)]
    return []


def step_launches(cfg, kind: str, n_nodes: int = 2) -> dict:
    """Each kernel's launches in one call of a step: K2 once a prefill
    layer (whisper: its encoder twice, ``encode`` and ``forward``, and its
    decoder once), K3 once a prefill layer and, under remat, twice a
    training layer (the forward and its recompute) and its backward once;
    FACADE's step one K1
    call and its feature pass's K2 or K3 once a layer and node; decode
    none."""
    want = {fn.__name__: 0 for fn in KERNELS}
    if kind == "prefill":
        if cfg.encoder_layers:
            want["flash_attention"] = 2 * cfg.encoder_layers + cfg.n_layers
        else:
            want["wkv" if cfg.rwkv else "flash_attention"] = cfg.n_layers
    elif kind == "train" and cfg.rwkv:
        want["wkv"] = 2 * cfg.n_layers
        want["wkv_backward"] = cfg.n_layers
    elif kind == "facade":
        want["head_losses"] = 1
        want["wkv" if cfg.rwkv else "flash_attention"] = \
            n_nodes * cfg.n_layers
    return want


def build_step(arch, shape, cfg, batch, **kw):
    if shape == "facade_pod":
        return steps.build_facade_case(arch, batch_per_node=batch, cfg=cfg,
                                       **kw)
    return steps.build_case(arch, shape, batch=batch, cfg=cfg, **kw)


def step_loss(kind, out):
    """The loss a step reports: the metrics' ``ce`` (train), the least
    selection loss (FACADE), else None."""
    if kind == "train":
        return float(out[2]["ce"])
    if kind == "facade":
        return float(out[1]["selection_losses"].min())
    return None


def step_first_call(arch, shape, cfg, batch):
    """Build the case at ``batch`` on the card and run its warm-up call;
    -> (case, output, launches, seconds). An out-of-memory error leaves
    the frame (and frees the case) to the caller's halving."""
    case = build_step(arch, shape, cfg, batch)
    torch.cuda.synchronize()
    with counted() as counts:
        t0 = time.perf_counter()
        out = case.step_fn(*case.args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return case, out, counts, wall


def step_config(arch, shape, n_layers):
    """(config, cut or None) of a ``STEP_CASES`` entry."""
    cfg = (get_config(arch) if shape == "facade_pod"
           else steps.resolve_config(arch, shape))
    if n_layers is None:
        return cfg, None
    return (cfg.replace(n_layers=n_layers),
            f"{n_layers} of {cfg.n_layers} layers, every width as published")


def step_case(arch, shape, first_batch, n_layers) -> dict:
    """One of ``STEP_CASES`` on the card: the largest batch that fits
    (halving from ``first_batch`` on an out-of-memory error), a warm-up
    call and ``STEP_CALLS`` timed calls (1 where the warm-up took over
    ``STEP_LONG_S``; host clock around a synchronised call), each call's
    launches against ``step_launches``, finite outputs, a training or
    FACADE loss within ``STEP_LOSS_SPAN`` of ln V; FACADE's step also
    twice bit for bit (``facade_repeat``). Its roofline terms come from
    ``trace_roofline`` in a worker process."""
    t_case = time.perf_counter()
    cfg, cut = step_config(arch, shape, n_layers)
    batch, tried = first_batch, []
    while True:
        settled_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            case, out, counts, first_s = step_first_call(arch, shape, cfg,
                                                         batch)
            break
        except torch.cuda.OutOfMemoryError:
            tried.append(batch)
        gc.collect()
        if batch == 1:
            raise AssertionError(f"steps {arch} {shape}: batch 1 does not "
                                 f"fit")
        batch //= 2
    fit_s = time.perf_counter() - t_case
    first_peak = torch.cuda.max_memory_allocated()
    want = step_launches(cfg, case.kind)
    label = f"{arch} {shape}"
    if counts != want:
        raise AssertionError(f"steps {label}: launches {counts}, want {want}")
    loss = step_loss(case.kind, out)
    ln_v = float(np.log(cfg.vocab_size))
    if loss is not None and not (ln_v + STEP_LOSS_SPAN[0] <= loss
                                 <= ln_v + STEP_LOSS_SPAN[1]):
        raise AssertionError(f"steps {label}: first loss {loss}, ln V "
                             f"{ln_v}")
    repeat = None
    if case.kind == "facade":
        repeat = facade_repeat(case, out)
    walls = []
    for _ in range(STEP_CALLS if first_s <= STEP_LONG_S else 1):
        del out
        torch.cuda.synchronize()
        with counted() as c:
            t0 = time.perf_counter()
            out = case.step_fn(*case.args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if c != want:
            raise AssertionError(f"steps {label}: launches {c}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    for leaf in float_leaves(out):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"steps {label}: non-finite output")
    n_tokens = case.n_tokens
    del out, case
    settled_allocated()
    wall = statistics.median(walls)
    rec = {"arch": arch, "shape": shape, "batch": batch,
           "batches_out_of_memory": tried, "fit_s": fit_s, "cut": cut,
           "n_layers": cfg.n_layers, "tokens": n_tokens,
           "warmup_s": first_s, "wall_s": walls, "median_s": wall,
           "tok_s": n_tokens / wall, "peak_bytes": peak,
           "warmup_peak_bytes": first_peak, "launches": want,
           "calls": 1 + len(walls), "first_loss": loss, "ln_v": ln_v,
           "facade_repeat": repeat, "case_s": time.perf_counter() - t_case}
    log(f"steps {label}: B {batch} (out of memory at {tried}, "
        f"{fit_s:.1f} s to fit), {n_tokens} tokens, median {wall:.4f} s "
        f"of {len(walls)}, {rec['tok_s']:.1f} tok/s, peak "
        f"{peak / 1e9:.2f} GB, launches {want}, loss {loss}; case "
        f"{rec['case_s']:.1f} s")
    return rec


def trace_roofline(arch, shape, batch, n_layers) -> dict:
    """The roofline terms of ``roofline/analysis.py`` of a ``STEP_CASES``
    entry at the run's batch: the same step traced on fake tensors on the
    CPU (run in a worker process, beside the card's work)."""
    torch.set_num_threads(TRACE_THREADS)
    t0 = time.perf_counter()
    cfg, _ = step_config(arch, shape, n_layers)
    fake = build_step(arch, shape, cfg, batch, abstract=True)
    cost = count_step(fake.step_fn, fake.args, fake.context)
    params = fake.args[0].cores if fake.kind == "facade" else fake.args[0]
    report = analyze_step(
        cost, arch=arch, shape=shape, mesh_name=MESH_NAME, chips=1, hw=HW,
        n_params_active=dryrun.active_param_count(cfg, params),
        n_tokens=fake.n_tokens,
        kind="train" if fake.kind == "facade" else fake.kind)
    return dict(report.row(), trace_s=time.perf_counter() - t0)


def state_leaves(out) -> list:
    state = out[0]
    return (tree_leaves(state.cores) + tree_leaves(state.heads)
            + [state.cluster_id])


def facade_repeat(case, first) -> dict:
    """FACADE's step run again on the same inputs, against the warm-up
    call's state bit for bit; where they differ, twice more under
    ``device.deterministic()`` (as ``run_experiment`` runs) and compared
    again. Returns the outcome and the seconds a call took each way."""
    saved = [x.cpu() for x in state_leaves(first)]
    del first

    def again():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = case.step_fn(*case.args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def diff(out, ref):
        got = state_leaves(out)
        return max(float((a.cpu().float() - b.float()).abs().max())
                   for a, b in zip(got, ref))

    out, secs = again()
    d = diff(out, saved)
    rec = {"equal": d == 0.0, "max_abs_diff": d, "s": secs,
           "deterministic_equal": None}
    del out
    if d != 0.0:
        with device_mod.deterministic():
            out, s1 = again()
            ref = [x.cpu() for x in state_leaves(out)]
            del out
            out, s2 = again()
            rec.update(deterministic_equal=diff(out, ref) == 0.0,
                       deterministic_max_abs_diff=diff(out, ref),
                       deterministic_s=[s1, s2])
            del out
    log("steps facade repeat", json.dumps(rec))
    return rec


def event_ms(fn, reps: int = 1) -> float:
    """Device time of ``fn()`` between CUDA events, after one warm-up
    call: for plain versions of thousands of launches, which a CUDA graph
    would take long to capture; the median of ``reps``."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fa_steps_check() -> dict:
    """K2 at the prefill_32k length: held against its plain version (run
    in fp32 on the same bf16 values, ``FA_TOL``) at ``FA_STEPS_CHECK``,
    and timed, with SDPA and its bound, at ``FA_STEPS_TIME``."""
    q, k, v = fa_inputs(*FA_STEPS_CHECK, torch.bfloat16, seed=91)
    got = flash_attention(q, k, v, causal=True)
    want = fa_plain(q.float(), k.float(), v.float())
    c = check("flash_attention steps", got, want,
              *FA_TOL[torch.bfloat16], shape=list(FA_STEPS_CHECK),
              dtype="bf16")
    del got, want
    t = {"check": c, "check_ms": graph_ms(
        lambda: flash_attention(q, k, v, causal=True), calls=2, reps=3),
         "plain_ms_check_shape": event_ms(lambda: fa_plain(q, k, v))}
    del q, k, v
    settled_allocated()
    q, k, v = fa_inputs(*FA_STEPS_TIME, torch.bfloat16, seed=92)
    bound_ms, bound_by, nbytes, flops = fa_bound(q, k, v)
    t.update(shape=list(FA_STEPS_TIME), bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, flops=flops,
             ms=graph_ms(lambda: flash_attention(q, k, v, causal=True),
                         calls=1, reps=3),
             library_ms=graph_ms(lambda: fa_library(q, k, v), calls=2,
                                 reps=3),
             library="scaled_dot_product_attention, GQA, is_causal")
    t["ms_again"] = graph_ms(lambda: flash_attention(q, k, v, causal=True),
                             calls=1, reps=3)
    del q, k, v
    settled_allocated()
    log("flash_attention steps", json.dumps(t))
    return t


def wkv_steps_check(sm_clock_hz) -> dict:
    """K3 at the prefill_32k length: held against its plain version
    (``RW_TOL`` on y and the final state) at ``RW_STEPS``, timed there
    and at rwkv6-1.6b's prefill batch, beside the bound; the plain
    recurrence timed once between events."""
    args = wkv_inputs(*RW_STEPS, seed=93)
    y, s_f = wkv(*args)
    torch.cuda.synchronize()
    y_ref, s_ref = wkv_scan(*args)
    c = check("wkv steps y", y, y_ref, RW_TOL, shape=list(RW_STEPS))
    c["state_max_abs_err"] = check("wkv steps state", s_f, s_ref, RW_TOL,
                                   shape=list(RW_STEPS))["max_abs_err"]
    del y, s_f, y_ref, s_ref
    bound = wkv_bound(args[0], sm_clock_hz)
    t = {"check": c, "shape": list(RW_STEPS), "bound_ms": bound[0],
         "bound_by": bound[1], "bytes": bound[2], "flops": bound[3],
         "serial_floor_ms": bound[4], "issue_floor_ms": bound[5],
         "ms": graph_ms(lambda: wkv(*args), calls=2, reps=3),
         "plain_ms": event_ms(lambda: wkv_scan(*args)),
         "library_ms": None}
    del args
    return t


def wkv_backward_steps_check(sm_clock_hz, batch) -> dict:
    """K3's backward at train_4k's length: the float64 witness's gate on one
    batch row (``RW_BWD_LONG``, y's gradient alone), the plain fp32 loop
    timed there between events, and the kernel timed at rwkv6-1.6b's
    train_4k shape at the case's ``batch``, beside its bound."""
    check = wkv_backward_check(RW_BWD_LONG, 0.0, False, seed=95,
                               explicit=False)
    args = wkv_inputs(*RW_BWD_LONG, seed=95)
    gy, _ = wkv_grad_seeds(RW_BWD_LONG, 1095, False)
    plain_ms = event_ms(lambda: wkv_plain_grads(args, gy, None,
                                                torch.float32))
    del args, gy
    settled_allocated()
    shape = (batch,) + RW_BWD_LONG[1:]
    t = wkv_backward_timing(shape, sm_clock_hz, calls=2, reps=3,
                            plain=False)
    t.update(check=check, plain_ms_check_shape=plain_ms,
             check_shape=list(RW_BWD_LONG), library_ms=None)
    settled_allocated()
    log("wkv backward steps", json.dumps(t))
    return t


def hs_lm_chunked(feats, heads, labels, fn, chunk=2048):
    """The LM-regime step-2c loss per (node, head) with its logits made
    ``chunk`` tokens at a time: ``fn(f, w, lab)`` gives a chunk's summed
    NLL (the plain version's arithmetic, or the library's), over the
    node's valid tokens."""
    n, k = heads.shape[:2]
    out = torch.zeros((n, k), dtype=torch.float32, device=feats.device)
    for i in range(n):
        count = (labels[i] >= 0).sum().clamp(min=1).float()
        for j in range(k):
            for c0 in range(0, feats.shape[1], chunk):
                out[i, j] += fn(feats[i, c0:c0 + chunk], heads[i, j],
                                labels[i, c0:c0 + chunk])
            out[i, j] /= count
    return out


def hs_plain_chunk(f, w, lab):
    """``head_losses_ref``'s arithmetic on one chunk: fp32 logits of the
    values as given, log-sum-exp less the gold logit, summed over the
    valid tokens."""
    logits = f.float() @ w.float()
    gold = logits.gather(-1, lab.long().clamp(min=0)[:, None])[:, 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    return torch.where(lab >= 0, nll, torch.zeros_like(nll)).sum()


def hs_library_chunk(f, w, lab):
    """The library yardstick on one chunk: a bf16 ``matmul`` and
    ``cross_entropy`` on its fp32 logits, summed."""
    return F.cross_entropy(torch.matmul(f, w).float(), lab.long(),
                           ignore_index=-1, reduction="sum")


def hs_steps_check(t_tokens: int) -> dict:
    """K1's LM body at the FACADE step's shape (n·K 4, T the step's node
    batch times 4096, D 2048, V 128,256, bf16, every label valid): held
    against its plain version made in token chunks (``HS_TOL``, equal
    argmins), timed beside its bound, the chunked plain version and the
    chunked library call."""
    shape = (4, 1, t_tokens, LM_CFG.d_model, LM_CFG.vocab_size)
    feats, heads, labels = hs_lm_case(*shape, seed=94, drop=0.0)
    got = head_losses(feats, heads, labels)
    want = hs_lm_chunked(feats, heads, labels, hs_plain_chunk)
    torch.cuda.synchronize()
    c = hs_check("head_select steps", got, want, shape=list(shape),
                 dtype="bf16")
    bound_ms, bound_by, nbytes, flops = hs_bound(feats, heads, labels)
    t = {"check": c, "shape": list(shape), "bound_ms": bound_ms,
         "bound_by": bound_by, "bytes": nbytes, "flops": flops,
         "ms": graph_ms(lambda: head_losses(feats, heads, labels), calls=2,
                        reps=3),
         "plain_ms": event_ms(lambda: hs_lm_chunked(
             feats, heads, labels, hs_plain_chunk)),
         "library_ms": event_ms(lambda: hs_lm_chunked(
             feats, heads, labels, hs_library_chunk)),
         "library": "per (node, head) and 2048-token chunk a bf16 matmul "
                    "and cross_entropy"}
    del feats, heads, labels
    settled_allocated()
    log("head_select steps", json.dumps(t))
    return t


def steps_smoke_phase() -> dict:
    """The smoke configs' steps (``STEPS_SMOKE``, fp32, B 2, S
    ``STEPS_SMOKE_SEQ``) on the card and on the CPU from the same
    arguments: logits, caches and FACADE's states and losses within
    ``SMOKE_LOGIT_TOL`` (absolute and relative), argmax tokens and
    cluster ids equal; a training step's loss and moments within it and
    its parameters where the gradient exceeds 1e-6 (elsewhere within twice
    the step's size, ``2 lr``: Adam's first step, ``lr·g/(|g| + eps)``,
    divides a gradient near its eps by its own magnitude, so each side may
    move such a parameter by up to lr either way)."""
    out = {}
    for arch, shape in STEPS_SMOKE:
        cfg = get_config(arch, smoke=True)
        case = build_step(arch, shape, cfg, 2, device="cpu")
        args = list(case.args)
        if case.kind in ("train", "prefill"):
            bi = 2 if case.kind == "train" else 1
            args[bi] = {k: (x[:, :STEPS_SMOKE_SEQ] if k in
                            ("tokens", "labels", "mask") else x)
                        for k, x in args[bi].items()}
        if case.kind == "facade":
            args[1] = {k: x[..., :STEPS_SMOKE_SEQ] for k, x in
                       args[1].items()}
        cpu = case.step_fn(*args)
        gpu = to_device(case.step_fn(*to_device(args, "cuda")), "cpu")
        torch.cuda.synchronize()
        rec = {"kind": case.kind}
        if case.kind == "train":
            rec["loss_diff"] = abs(float(gpu[2]["ce"]) - float(cpu[2]["ce"]))
            pairs = zip(tree_leaves(gpu[0]), tree_leaves(cpu[0]),
                        tree_leaves(cpu[1]["m"]))
            small = big = 0.0
            for g, c, m in pairs:
                sel = (m / 0.1).abs() > 1e-6
                d = (g - c).abs()
                big = max(big, float((d[sel] / c[sel].abs().clamp(
                    min=1)).max()) if bool(sel.any()) else 0.0)
                small = max(small, float(d.max()))
            rec.update(param_rel_diff=big, param_max_diff=small,
                       moments_diff=max(
                           float((a - b).abs().max()) for a, b in zip(
                               tree_leaves(gpu[1]["m"])
                               + tree_leaves(gpu[1]["v"]),
                               tree_leaves(cpu[1]["m"])
                               + tree_leaves(cpu[1]["v"]))))
            ok = (rec["loss_diff"] <= SMOKE_LOGIT_TOL
                  and big <= SMOKE_LOGIT_TOL and small <= 2 * 3e-4
                  and rec["moments_diff"] <= SMOKE_LOGIT_TOL)
        elif case.kind == "facade":
            rec.update(
                loss_diff=float((gpu[1]["selection_losses"]
                                 - cpu[1]["selection_losses"]).abs().max()),
                ids_equal=bool(torch.equal(gpu[0].cluster_id,
                                           cpu[0].cluster_id)),
                state_rel_diff=max(
                    float((a - b).abs().max() / b.abs().max().clamp(
                        min=1e-3)) for a, b in zip(state_leaves(gpu)[:-1],
                                                   state_leaves(cpu)[:-1])))
            ok = (rec["loss_diff"] <= SMOKE_LM_TOL and rec["ids_equal"]
                  and rec["state_rel_diff"] <= SMOKE_LM_TOL)
        else:
            logits_g, logits_c = gpu[0], cpu[0]
            rec.update(
                logit_diff=float((logits_g - logits_c).abs().max()),
                tokens_equal=bool(torch.equal(logits_g.argmax(-1),
                                              logits_c.argmax(-1))),
                rest_diff=max((float((a.float() - b.float()).abs().max())
                               for a, b in zip(float_leaves(gpu[1]),
                                               float_leaves(cpu[1]))),
                              default=0.0))
            ok = (rec["logit_diff"] <= SMOKE_LOGIT_TOL and rec["tokens_equal"]
                  and rec["rest_diff"] <= SMOKE_LOGIT_TOL)
        out[f"{arch} {shape}"] = rec
        log(f"steps smoke {arch} {shape}: card vs CPU {json.dumps(rec)}")
        if not ok:
            raise AssertionError(f"steps smoke {arch} {shape}: card and CPU "
                                 f"disagree {rec}")
    return out


def steps_phase(rec, sm_clock_hz) -> dict:
    """The step builders of ``launch/steps.py`` at full width on the card
    (``STEP_CASES``), the kernels held against their plain versions at
    the steps' lengths, and the smoke configs' steps card against CPU;
    returns each kernel's record of those shapes and launches."""
    t0 = time.perf_counter()
    settled_allocated()
    kernels = {"flash_attention": fa_steps_check(),
               "wkv": wkv_steps_check(sm_clock_hz)}
    cases, traces = {}, {}
    with concurrent.futures.ProcessPoolExecutor(
            TRACE_WORKERS, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        for arch, shape, first, n_layers in STEP_CASES:
            label = f"{arch} {shape}"
            cases[label] = step_case(arch, shape, first, n_layers)
            traces[label] = pool.submit(trace_roofline, arch, shape,
                                        cases[label]["batch"], n_layers)
        facade_batch = cases["llama3.2-1b facade_pod"]["batch"]
        kernels["head_losses"] = hs_steps_check(facade_batch * 4096)
        kernels["wkv_backward"] = wkv_backward_steps_check(
            sm_clock_hz, cases["rwkv6-1.6b train_4k"]["batch"])
        for label, fut in traces.items():
            c = cases[label]
            c["roofline"] = row = fut.result()
            c["wall_over_compute"] = c["median_s"] / row["t_compute_s"]
            c["wall_over_memory"] = c["median_s"] / row["t_memory_s"]
            log(f"steps {label} roofline: compute {row['t_compute_s']:.4g}"
                f" s, memory {row['t_memory_s']:.4g} s ({row['dominant']}),"
                f" measured / compute {c['wall_over_compute']:.3g}, "
                f"measured / memory {c['wall_over_memory']:.3g}, traced in "
                f"{row['trace_s']:.1f} s")
    for name, entry in kernels.items():
        entry["launches"] = {label: c["launches"][name] * c["calls"]
                             for label, c in cases.items()
                             if c["launches"][name]}
    smoke = steps_smoke_phase()
    rec["steps"] = {"cases": cases, "kernels": kernels, "smoke": smoke,
                    "phase_s": time.perf_counter() - t0}
    log(f"steps phase: {rec['steps']['phase_s']:.1f} s")
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    rec = {"nvidia_smi": smi, "device": kind,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    t0 = time.perf_counter()
    hs = kernel_phase(rec)
    hs_f32, hs_tc32, hs_padded = head_select_wide_phase(rec)
    fa = flash_attention_phase(rec)
    rw, rw_bwd = wkv_phase(rec, sm_clock_hz)
    ds = paper_lenet_data(rec)
    hs["launches"] = main_path_phase(rec, ds)
    engine_phase(rec, ds)
    # K1's launches on the driver paths: pipelined and serialized runs
    # (target_acc exits included), a resumed run of FACADE, the sweep
    hs["driver_launches"] = {"pipeline": pipeline_phase(rec, ds),
                             "resume": resume_phase(rec, ds),
                             "sweep": sweep_phase(rec, ds),
                             "netsim": netsim_phase(rec, ds),
                             "faults": faults_phase(rec, ds),
                             "topo": topo_phase(rec, ds),
                             "obs": obs_phase(rec, ds),
                             "mesh": mesh_phase(rec, ds)}
    resnet8_launches = resnet8_paper_phase(rec)
    hs["resnet8"] = dict(resnet8_select_phase(rec),
                         launches=resnet8_launches)
    small_input_phase(rec)
    hs["lm"]["launches"] = lm_facade_phase(rec, "llama3.2-1b")["head_losses"]
    rwkv_launches = lm_facade_phase(rec, "rwkv6-1.6b")
    hs["lm"]["rwkv"]["launches"] = rwkv_launches["head_losses"]
    # K1's wider paths as a user runs them: hymba's FACADE (the tensor
    # cores through the padded copy), and in fp32 a llama round and the
    # smoke LM rounds, each counted on the fp32 body its operands take
    hs_padded["launches"] = lm_facade_phase(rec, "hymba-1.5b")["head_losses"]
    f32_paths = {body: {} for body in F32_BODIES}
    f32_round = lm_facade_phase(rec, "llama3.2-1b fp32")["head_losses"]
    f32_paths[rec["lm_facade"]["llama3.2-1b fp32"]["k1_by_name"]["body"]][
        "llama3.2-1b fp32 round"] = f32_round
    for body, n in smoke_lm_facade_phase(rec).items():
        f32_paths[body]["smoke LM rounds"] = n
    for entry in (hs_f32, hs_tc32):
        entry["launches_by_path"] = f32_paths[entry["body"]]
        entry["launches"] = sum(f32_paths[entry["body"]].values())
    # K3's and its backward's launches on their third path: the launcher's
    # lm mode on RWKV
    lm_mode_rwkv = lm_mode_phase(rec)["rwkv6-1.6b"]["launches"]
    rw["train"]["lm_mode_launches"] = lm_mode_rwkv["wkv"]
    rw_bwd["lm_mode_launches"] = lm_mode_rwkv["wkv_backward"]
    fa["launches"] = serve_phase(rec, "llama3.2-1b", flash_attention)
    rw["launches"] = serve_phase(rec, "rwkv6-1.6b", wkv)
    # K2 in every prefill layer of SERVE_MORE's configs
    fa["launches_by_arch"] = {"llama3.2-1b": fa["launches"]}
    for arch, n_layers in SERVE_MORE.items():
        fa["launches_by_arch"][arch] = serve_phase(
            rec, arch, flash_attention, traced=False, n_layers=n_layers)
    # ... in llava's image-prefix prefill, and in whisper's forward
    fa["launches_by_arch"]["llava-next-34b image prefix"] = rec["serve"][
        "llava-next-34b"]["image_prefill"]["launches"]["flash_attention"]
    fa["launches_by_arch"]["whisper-tiny forward"] = whisper_phase(rec)
    # K2's and K3's launches in the traced serves (--net edge-v2 and a
    # JSONL tracer)
    fa["traced_serve_launches"] = rec["serve"]["llama3.2-1b"]["traced"][
        "launches"]["flash_attention"]
    rw["traced_serve_launches"] = rec["serve"]["rwkv6-1.6b"]["traced"][
        "launches"]["wkv"]
    # K3's launches on its second path: the RWKV FACADE rounds
    rw["train"]["launches"] = rwkv_launches["wkv"]
    rw["train"]["launches_per_round"] = (rwkv_launches["wkv"]
                                         // LM_ROUNDS["rwkv6-1.6b"])
    # K3's backward on its main path: the RWKV FACADE rounds' local steps
    rw_bwd["launches"] = rwkv_launches["wkv_backward"]
    rw_bwd["launches_per_round"] = (rwkv_launches["wkv_backward"]
                                    // LM_ROUNDS["rwkv6-1.6b"])
    smoke_serve_phase(rec)
    # the per-arch steps at full width; K1, K2 and K3 at their lengths
    on_steps = steps_phase(rec, sm_clock_hz)
    hs["steps"] = on_steps["head_losses"]
    fa["steps"] = on_steps["flash_attention"]
    rw["steps"] = on_steps["wkv"]
    rw_bwd["steps"] = on_steps["wkv_backward"]
    # K1, K2 and K3 on the DTensor path of the language models' mesh
    on_mesh = lm_mesh_phase(rec)
    hs["lm_mesh"] = on_mesh["head_losses"]
    fa["lm_mesh"] = on_mesh["flash_attention"]
    rw["lm_mesh"] = on_mesh["wkv"]
    # K1 and K2 on the examples' paths, as a user runs them
    on_examples = examples_phase(rec)
    hs["examples"] = on_examples["head_losses"]
    fa["examples"] = on_examples["flash_attention"]
    # after the timed phases: a profiler run and one more graph timing
    split = head_select_lm_split()
    if split["body_ms"] is None:
        split = dict(head_select_lm_split_apart(), in_this_process=split)
        log("head_select lm split (own process)", json.dumps(split))
    hs["lm"].update(split)
    rec["head_select_lm"].update(split)
    fa["lm_feature_pass"] = rec["flash_attention_timing"][
        "lm_feature_pass"] = fa_timing("lm_feature_pass", FA_LM, 50)
    prof = engine_profile_phase(rec, ds)
    hs["engine"] = {"launches_in_segment": prof["launches"]["head_losses"],
                    "us_per_replayed_round": prof["k1_us_per_round"]}
    # each of K1's bodies on the line: the FMA body (the FACADE path), the
    # tensor cores at llama's LM round, with a ragged V at hymba's, and the
    # two fp32 bodies at the fp32 llama round's
    lm = rec["head_select_lm"]
    hs_tc = {"name": "head_select_tensor_core", "body": "tensor_core",
             **{key: hs[key] for key in ("route", "source", "replaces")},
             "launches": hs["lm"]["launches"],
             **{key: lm[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "shape")}}
    hs["body"] = "fma"
    entries = [hs, hs_tc, hs_padded, hs_f32, hs_tc32, fa, rw, rw_bwd]
    rec["kernels"] = entries
    rec["total_s"] = time.perf_counter() - t0
    log(f"total_s {rec['total_s']:.1f}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
