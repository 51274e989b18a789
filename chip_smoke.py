#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. **Build** the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc
   -c`` per source, all started together, then one link) and print the
   build time, ptxas' register/spill report per kernel and the card's
   name and power limit.
2. **Kernel vs plain** on random planes made from a seed on the card:
   ``paxos_apply`` at 5 x 2^20 lanes and at ragged lane counts,
   ``paxos_propose`` at 5 x 800 lanes and ragged counts, idle lanes and
   mixed per-machine quorum parameters; its staged entry
   ``paxos_propose_staged`` at 5 x 800 with 0, 1, 19, 127 and all 4000
   lanes staged, at 3 x 1667 and 12289 x 1 with ragged counts (the whole
   table compared after each in-place call, all lanes staged equal to the
   whole-stack kernel, a duplicate or out-of-range coordinate refused).
   Every output plane must equal the plain PyTorch version run on the card
   (0 mismatches).
3. **Full-width serve**: ``Cluster(machine_cls=BatchedMachine)`` on the
   card at 5 replicas x 800 sessions x 2^20 key lanes, the kv_mixed
   10/20/70 rmw/write/read mix over 2^20 keys, batched-smoke network
   faults; one plain seed and one all-aboard seed with a crash/restart of
   machine 4 mid-run.  Completions must equal the port's scalar cluster
   on the same seed, the safety checkers must be green, both kernels must
   have launched (``paxos_propose`` through its staged entry, once an
   issuer wave), and a sample of the fused calls is replayed through the
   plain versions on the card (a staged call against the whole-stack
   plain version).  Then ``[serve_mesh]``: the same two seeds on 4
   spawned ranks on the one card, joined in a gloo group through a
   ``FileStore`` in a temporary directory, with
   ``BatchedMachine(shards=4)``: each rank holds its lane block of the KV
   stack, (18, 5, 2^18), and of the table, (65, 5, 200), launches both
   kernels on them (every ``paxos_apply`` launch on the whole block) and
   all-gathers each wave's compact outputs.  Each rank's completions,
   the SHA-256 of its host mirrors and of its device blocks must equal
   ``[serve]``'s run of the same seed and block, the checkers green, both
   kernels launched on every rank (as many times as its engine called
   them), and an early and a late call of each kernel replayed through
   the plain versions bit for bit; a failing rank stops the others, and
   a rank still running after 300 s is killed.  Prints each rank's
   waves, launches, lanes a launch, host ms from a launch to its end,
   gathers with their bytes and seconds, and its wall against
   ``[serve]``'s.  Then ``[train_mesh]``, every family's sharded train
   step, in five cases at full width cut in depth, on 4 ranks on the one
   card spawned once for all of them, as a (2, 2) (data, model) mesh over
   gloo: qwen1.5-4b at 2 of 40 layers, rwkv6-7b at 1 of 32, zamba2-7b's
   unit (6 Mamba2 layers and the shared block), mixtral-8x7b at 1 of 32
   (its shard_map TP MoE), 2 x 1024 tokens a step, and whisper-large-v3
   at 4 + 4 of 32 + 32 layers over 2 x 1500 frames and 2 x 64 tokens;
   placed as DTensors by ``launch/steps.place_cell`` (FSDP over "data";
   heads, mlp, experts' ff and vocab over "model"; ZeRO-1 moments; the
   batch over "data"), DTensor's collectives through buffers the ranks of
   each group map on the card (``parallel/peer_staged.py``, CUDA IPC).
   Two AdamW steps a case on each rank; once a case's ranks have written
   their blocks (and wait), the same model and batch in one process on
   the card (mixtral routed block by block, as each data rank routes):
   each step's loss and grad norm within 1e-5 relative, every gradient
   leaf of step 1 within 1e-4 of its max |g|, every parameter after the
   steps within 2e-4, which a planted wrong-sign gradient block must
   exceed (qwen's), each rank's moments on the card in the blocks
   ``opt_state_specs`` gives, each float kernel's first call within 1e-4
   of its plain version on its block, and its launches a rank, counted
   from 0 just before the steps, twice a prefill's a step (the forward
   and its remat recompute; mixtral's MoE all-reduce once a layer a
   step); a case still running after 240 s is killed.  Prints each
   case's collectives of one step (``launch/collectives.py``), what each
   rank staged, the bytes written for the gates, ms a step and peak GB a
   rank against one process's.  Then ``[decode_mesh]``, the decode cell
   over the same kind of group: ``place_cell`` of a decode cell (the
   parameters drawn a leaf at a time into ``build_cell``'s serve layout,
   no weight over
   "data"; the caches' blocks by ``cache_shardings``) served through
   ``DecodeEngine.generate`` on the placed parameters, in four cases:
   qwen1.5-4b at 4 of 40 layers in ``decode_32k``'s layout cut to
   batch 4 and 2048 cache slots, a 16-token prompt and 4 generated;
   gemma3-12b cut to one unit (6 of 48 layers) at ``long_500k``'s, batch
   1 and 64 slots with the KV sequence over "data" (32 a rank), a
   40-token prompt and 32 generated, so the global layer's writes cross
   into data rank 1's block and clamp at the last slot, and the local
   rings wrap;
   rwkv6-7b at 4 of 32 layers in ``decode_32k``'s layout as qwen1.5-4b's
   (its WKV state by batch and heads); zamba2-7b cut to one unit (6
   Mamba2 layers and the shared block) in ``long_500k``'s as gemma3's
   (the SSM state by heads, the shared block's KV sequence over "data");
   mixtral-8x7b at 2 of 32 layers in ``decode_32k``'s layout as
   qwen1.5-4b's (the shard_map MoE, its experts' ff dim over "model",
   routing each data rank's batch block); whisper-large-v3 (32 encoder
   layers, 8 of 32 decoder layers) in the same layout, 1500 encoder
   frames (the cross caches by batch and heads).
   Against the same model, weights and prompts served in one process on
   the card (mixtral's routing there block by block, as on the mesh):
   generated tokens equal (the smallest top-1/top-2 gap at a
   pick printed), every step's logits and every rank's cache and state
   blocks within 1e-5 of their max, the prefill cell of the same prompts
   on the same mesh (the float kernels on each rank's blocks, counts set
   to 0 just before: ``flash_attention`` 4 and 6 times a rank, ``wkv6``
   4 times on (2, 32, 16, 64), ``ssd`` 6 times on (1, 40, 56, 64) and
   ``flash_attention`` once on (1, 16, 40, 112), mixtral's 2 times and
   whisper's 48) within 1e-3 of the last prompt step's logits (of the
   same prefill in one process for mixtral and whisper), each kernel's
   first call within 1e-4 of its plain version on its block (timed on
   rank 0 by CUDA events), mixtral's decode one MoE all-reduce a layer
   a step, and no parameter gathered (the counted step's all-gathers exactly zamba2's
   in-projection activations, none elsewhere; a step's staged
   all-gathers smaller than any parameter block where a case gathers
   none).  Prints a step's collectives, what rank 0 staged a step, ms a
   step a rank beside one process's, peak GB a rank and the phase's
   seconds.
4. **Schedule replay** (``repro_torch.core.replay``): the port's scalar
   cluster with both trace taps at the serve phase's width and seeds (5 x
   800 sessions x 2^20 keys, 4000 ops; seed 0 plain, seed 1 all-aboard
   with machine 4 crashed and restarted) replayed on the card per
   machine, fused, sharded over 4 shards (``paxos_apply``) and on the
   issuer side (the whole-stack ``paxos_propose``), each held reply for
   reply, registry for registry and plane for plane to the scalar
   handlers and shadows, each kernel launched once a batch or wave;
   seed 0's batched cluster's own traces must replay with the scalar
   cluster's stats; a reply lane flipped on one wave and a KV lane no
   message touched flipped on another must each raise the replay's
   mismatch, naming the machine and key.
5. **Timings** of each kernel at the main path's shapes (CUDA events,
   median after warm-up), its bound and its plain version's time; the
   staged entry at 19 and 4000 lanes; the whole-stack issuer wave (the
   whole-stack step, scatters, gather, pull) against the staged wave in
   turns on the card, and one profiled pass counting the staged wave's
   device operations; the card's busy share over 40 ticks of the serve
   path.
6. **Open-loop load** through the operations layer: ``OpenLoopHarness``
   on ``Cluster(machine_cls=BatchedMachine)`` at 5 replicas x 800 sessions
   x 2^20 Zipf(0.99) keys, the kv_mixed mix, 25 ops a tick for 200 ticks,
   2 % drops and duplicates, machine 4 crashed at tick 60 and restarted at
   85, a partition [0, 1, 2] | [3, 4] over ticks 120-150; seed 0 plain and
   seed 1 all-aboard, each with a sampled ``FlightRecorder``.  Completions,
   latency reports and path counts must equal the port's scalar cluster's,
   and the completions the reference's recorded run of the same spec
   (``tests/data/open_loop_reference.json``, by count and SHA-256); the
   path counters must reconcile with the history on both clusters; the
   checkers must say what they say of the reference's run (seed 0 green;
   seed 1 the reference protocol's linearizability fault, word for word);
   both kernels must have launched and a sample of the fused calls replays
   through the plain versions.  Prints each seed's bench lane, the
   recorder's ``engine.*`` counters, the host time inside the recorder's
   hooks, the batched wall time with the recorder in mode ``off`` and in
   mode ``sampled`` in turns, and the device's busy share over one run
   traced on the device, against that run's own wall.  A failure dumps the
   recorder under ``build/flight_dumps/`` and re-raises.
7. **Live reconfiguration**: the storm of ``scripts/reconfig_smoke.py``
   from 5 members (5 -> 6 -> 7 -> 6 -> 7 -> 6: a partition [2] | [0]
   across the two joins, machine 2 crashed across the first leave, the
   leaver rejoined) at 800 sessions over keys 1 .. 2^20 - 1, 4000 ops
   split 14 : 10 : 8, on the batched cluster on the card and on the scalar
   cluster.  Completions equal, checkers green (view transitions
   included), epoch 5 with 6 members, plane rows reloaded, both kernels
   launched, the first fused call at each machine count replayed through
   the plain versions, and a member's snapshot equal to its KV row on the
   card; the whole-row catch-up held to the per-key one on 4096 sampled
   lanes (reads, and two installs into fresh joiners on the card); prints
   the seconds and bytes of every snapshot taken and installed.
8. **The fault smokes** (``[smokes]``): the port's drivers
   ``scripts/torch_{batched,reconfig,open_loop}_smoke.py`` on the card at
   the reference scripts' own settings (5 machines x 2 sessions over 3
   keys; storms 3 -> 4 -> 5 -> 4 -> 5 -> 4; open loop over 48 Zipf keys):
   the batched smoke's 20 seeds, then its 7 ``KERNEL_SEEDS`` at 4 shards,
   the 20 storms and all 20 open-loop specs through the batched cluster
   (the scripts' ``check_seed`` over every seed; the open-loop script's
   own ``main`` takes only its ``BATCHED_SEEDS`` batched), each seed
   completion-identical to the port's scalar cluster with the checkers
   green and both select networks launched (the drivers raise
   otherwise); each smoke's counts set to 0 just before it.  The first
   fused call at each new shape (stacks grown from a few lanes, 1-lane
   waves, 3 to 5 machines) is replayed through the plain versions.  Then
   seed 0 with ``--inject-failure``'s corrupted commit record must be
   caught by the checkers, leave its dump under ``build/flight_dumps/``
   and be summarised by ``scripts/torch_trace_report.py``.  Prints each
   smoke's seconds and launches.
9. **Float kernels vs plain** on unit-normal inputs made on the card:
   ``flash_attention`` at zamba2's, gemma3's local, qwen1.5's ragged,
   Sq < Sk, non-causal and MQA shapes, a window straddling key tiles,
   mixtral's 4096-token window slid past its edge (Sq = Sk = 4608, GQA
   32/8), qwen2-vl's GQA 64/8, whisper's cross-attention (Sq = 64 and
   Sq = 1 against Sk = 1500, non-causal) and the dense family's 4096-token
   prefills (gemma3's global layer at head dim 256, phi3's head dim 96,
   qwen2.5's GQA 40/8) and kimi-k2's (GQA 64/8, head dim 112),
   ``mamba2_ssd`` at zamba2's layer, ragged T (T = 65 and 4097 are ragged
   by one step against its 64-step chunks), G = 2 and N = 128,
   ``rwkv6_wkv`` at rwkv6-7b's prefill and the smoke
   config's heads, ragged T (T = 65 and 4097 against its 64-step chunks),
   ragged V, K = 40 and B = 2 (decays exp(-exp(x)), x uniform on [-6, 1]),
   strong decays with exact zeros, and w = 1 over 4096 steps, each in
   float32 and bfloat16.
10. **Full-width zamba2-7b** (81 layers, d_model 3584, float32 weights from
   a seeded ``torch.Generator`` on the card): one prefill of 2 x 128
   tokens, the main path of its float kernels (their counts set to 0 just
   before it and read just after: 13 flash attention, 81 SSD), held
   against the teacher-forced ``decode_step`` loop over the same tokens
   (same top-1, max logit error <= 1e-3 of max |logit|); a sample of its
   kernel calls replayed through the plain versions; then ``DecodeEngine``
   routes 4 sessions through ``PaxosRegistry(n_machines=5)`` over
   ``BatchedMachine`` (sticky across two engines) and generates 32 steps.
11. **bf16 zamba2-7b prefill** at 1 x 4096 tokens (cut from the dry-run's
   ``prefill_32k``, batch 32): wall time, peak memory and one
   ``torch.profiler`` pass; a float kernel's time a call is its CUDA
   kernels' device time over its wrapper's calls in that pass.
12. **Full-width rwkv6-7b** (32 layers, d_model 4096, 7.5e9 float32
   weights, drawn after zamba2's are freed): phase 10 again, with 32
   ``rwkv6_wkv`` launches in the prefill.
13. **bf16 rwkv6-7b prefill** at 1 x 4096 tokens, as phase 11.
14. **mixtral-8x7b** (``[mixtral]``) at full width (8 experts top-2 x
    14336, 32 / 8 heads x 128, window 4096) cut to 4 of 32 layers
    (6,067,228,672 float32 parameters).  Gate 1: a prefill of 1 x 4608
    tokens, past the window's edge, through the kernels against the same
    prefill with ``attention_plain`` on the card (same top-1, max logit
    error <= 1e-3 of max |logit|, 4 flash-attention launches); prints how
    many top-2 expert choices differ between the two (expected 0).  Gate
    2: at capacity factor 8 (nothing drops) a prefill of 1 x 256 tokens
    against the teacher-forced ``decode_step`` loop, with the published
    factor's dropped assignments printed beside it.  Then
    ``DecodeEngine`` routes and generates 16 steps, and a bf16 prefill of
    1 x 4608 is timed and profiled, split into attention, MoE dispatch
    (the ``moe.dispatch`` and ``moe.combine`` ranges: routing, sort,
    scatter, gather), expert products (``moe.experts``) and the rest.
15. **qwen2-vl-72b** (``[qwen2_vl]``) at full width (64 / 8 heads x 128,
    M-RoPE sections (16, 24, 24)) cut to 2 of 80 layers (4,246,794,240
    float32 parameters).  Gate 1: 256 vision embeddings (a 16 x 16 grid
    in M-RoPE) and 512 text tokens through the kernels against the plain
    prefill (2 launches); gate 2: a text-only prefill of 2 x 128 against
    the teacher-forced decode.  Then its bf16 prefill.
16. **whisper-large-v3** (``[whisper]``) at full width and depth (32 + 32
    layers, 1,578,672,640 float32 parameters).  Gate 1: the prefill of 2
    x 1500 frames and 2 x 64 tokens through the kernels against the plain
    prefill (96 launches: 32 encoder, 32 self, 32 cross); gate 2: decode
    step 64 with cross caches from ``_enc_kv`` against the same step with
    ``attention_plain`` (32 launches).  The prefill against the
    teacher-forced decode is printed and not held: the reference's decode
    rotates by RoPE and its prefill does not.  Then ``DecodeEngine``
    generates 16 steps, and the bf16 prefill is timed and profiled.
17. **The dense family** (``[dense]``), one model resident at a time.
    gemma3-12b at full width and depth (48 layers = 8 x (5 local + 1
    global), head dim 256, GQA 16/8, window 1024, GeGLU, 12,772,028,160
    float32 parameters).  Gate 1: a prefill of 1 x 2048 tokens through the
    kernels against the same prefill with ``attention_plain`` (48 launches:
    40 windowed, 8 global, each counted by shape and window); the first
    and last unit's local and global calls replayed through the plain
    version.  Gate 2: the same weights cut to one unit (6 layers), a
    prefill of 1 x 1152 against the teacher-forced ``decode_step`` loop
    with caches of 1152 slots, so each local layer's 1024-slot ring wraps
    128 times.  Then the engine at full depth, and, with the float32
    weights freed, a bf16 prefill of 1 x 4096 split into attention, the
    MLP blocks (a profiler range "mlp") and the rest.  phi3-mini-3.8b (head
    dim 96) and qwen1.5-4b (MHA 20/20, qkv bias) at full depth, and
    qwen2.5-32b (GQA 40/8) cut to 16 of 64 layers: phase 10's gates (32,
    40 and 16 launches), then each one's bf16 prefill; qwen2.5's at full
    depth, 65.5 GB of weights drawn a slice at a time, or cut to the
    layers that fit the card's free memory (printed with the bytes).  Last,
    ``flash_attention`` in bf16 at each model's 1 x 4096 shape, gemma3's
    local and global apart, against its bound and SDPA.
18. **The parallel layer** (``[parallel]``): the one-card dry run
    (``repro_torch.launch.dryrun``, ``meta`` tensors, no compiler) of all
    34 ``ARCHS`` x ``SHAPES`` cells printed as the roofline table at the
    H100 datasheet's constants; then a one-rank NCCL group (``FileStore``
    in a temporary directory) and a 1 x 1 ``("data", "model")``
    ``DeviceMesh``.  mixtral-8x7b (TP, capacity factor 1.25) cut to 4
    layers as in phase 14: a float32 prefill of 1 x 1024 tokens under
    ``use_mesh`` (the shard_map MoE) against the same prefill without it
    (spmd): max logit error <= 1e-5 of max |logit|, every expert choice
    and drop equal, ``apply_moe_shardmap.all_reduces`` (``moe.all_reduce``)
    4 and ``flash_attention`` 4 launches (counts set to 0 just before the
    shard_map run), no all-reduce in the spmd run.  kimi-k2's MoE block at
    full width (d_model 7168, 384 experts top-8 x 2048; 33.8 GB bf16,
    drawn an expert at a time) on 1 x 512 tokens through the shard_map
    path (EP, ``e_local`` = 384) and through ``apply_moe_spmd``: expert
    choices equal, and equal bits (max |dy| 0) between the two paths and
    between two runs of spmd, in PyTorch's default mode (the combine adds
    in a fixed order), and both paths' bf16 device ms.  The group is
    destroyed at the end.
19. **Timings** of the three float kernels at their prefill shapes, their
    bounds, plain versions and, for attention, one
    ``scaled_dot_product_attention`` call (a yardstick the port never
    calls); then attention in bf16 at the zoo's shapes (qwen2-vl's, each
    of whisper's four, mixtral's window 4096, kimi-k2's) against its bound
    and SDPA (with a boolean band mask where a window applies, held to
    the kernel's output).
20. **Training** (``[train]``): zamba2-7b at full width cut to one unit
    (6 Mamba2 layers and one call of the shared attention block,
    902,732,256 float32 parameters), ``DataConfig(vocab=32000,
    seq_len=1024, batch=2, batches_per_shard=2)``, AdamW, remat on.
    Gate 1: ``train_loss`` through the kernels at step 0's parameters on
    the first batch's 2 x 256 tokens equals the mean next-token NLL of the
    teacher-forced ``decode_step`` loop (plain PyTorch) within 1e-4
    relative, with one launch of each kernel a layer that holds it.  Gate
    2: each float kernel's ``autograd.Function`` (the kernel forward, the
    plain recompute backward) against autograd through the plain version
    with the same upstream gradient: attention at (2, 32, 1024, 112)
    causal, a GQA + window case, whisper's encoder (2, 20, 1500, 64) and
    cross-attention (Sq 64, Sk 1500), both non-causal, and mixtral's (2,
    32/8, 1024, 128, window 4096), the SSD at (2, 1024, 112, 64, G=1,
    N=64), the WKV at (2, 64, 1024, 64); forwards within the kernels'
    tolerances, every input's gradient within 1e-5 relative, one launch a
    forward.  Gate 3: ``train`` for 4 steps (a checkpoint at 4) over
    ``PaxosRegistry(n_machines=5, machine_cls=BatchedMachine)``, registry
    replica 4 crashed, a new ``train`` to step 8: it resumes at 4 from a
    state equal bit for bit to the one saved, the registry commits 8, the
    shard cursor equals the shards consumed, every loss and grad norm is
    finite, steps 7-8 end below steps 1-2, every step launches 2
    flash-attention and 12 SSD kernels (forward and remat recompute), the
    Paxos kernels launch, and a membership change at run 2's checkpoint
    (step 8) reaches ``on_membership``.  Prints the ms a step, the peak
    memory, each kernel's forward against its backward recompute in
    device time, and the busy share of one profiled step.
21. **rwkv6-7b trained** (``[train_rwkv6]``, ``phase_train`` again): full
    width cut to 1 of 32 layers (755,290,112 float32 parameters),
    65536-token vocabulary, 2 x 1024 tokens a step.  Gate 1 as phase 20's
    (2 WKV launches, no attention or SSD); gate 2: the loss and every
    parameter leaf's gradient of ``train_loss`` through the kernel
    against the same with ``wkv6_plain`` swapped in (loss within 1e-5
    relative, each leaf within 1e-4 of its max |g|; 1 launch a forward,
    2 with the remat recompute); gate 3 as phase 20's with 2 WKV launches
    a step.
22. **The zoo's train steps** (``[train_zoo]``): mixtral-8x7b at 2 of 32
    layers (2 x 1024 tokens) and whisper-large-v3 whole (2 x 1500 frames,
    2 x 64 tokens), float32: the loss and every leaf's gradient through
    the kernels against the same with ``attention_plain`` (phase 21's
    tolerances; 2 and 96 launches a forward, twice that with the remat
    recompute; mixtral's expert choices and drops equal), then three
    ``make_train_step`` AdamW steps on the same batch with the loss
    falling.
23. **kimi-k2-1t-a32b** (``[kimi]``) at full width (d_model 7168, 384
    experts top-8 x 2048, 64/8 heads x 112): the memory earlier phases
    left is released and printed; in float32 cut to 1 of 61 layers
    (19,378,623,488 parameters, 77.51 GB, drawn a slice at a time) a
    prefill of 1 x 1024 through the kernel against ``attention_plain``
    (1 launch, expert choices equal), at capacity factor 8 (nothing
    drops, the count printed) a prefill of 1 x 256 against the
    teacher-forced decode, and the engine (31 ``paxos_apply`` and 65
    ``paxos_propose`` launches); then in bf16 cut to 2 layers (72.82 GB)
    a prefill of 1 x 4096 at the published capacity factor, split by the
    ``moe.*`` ranges.
24. **The examples** (``[examples]``): ``examples/torch_quickstart.py``
    (a 5-replica all-aboard registry over ``BatchedMachine``),
    ``examples/torch_serve_kvstore.py`` (its dense demo model's routes,
    reconfiguration, 12 generated steps and one prefill of the prompts:
    4 flash-attention launches, held to the decode path) and
    ``examples/torch_train_fault_tolerant.py --full`` (a dense 8-layer
    model trained 300 steps, registry replica 4 crashed, the trainer
    restarted at step 150, a descending loss; 2 flash-attention launches
    a layer a step).  In each example the first call of each kernel at
    each shape it meets (the registries' fused waves; attention at the
    prefill's and the train step's shapes) is recorded and replayed
    through the plain version: the select networks bit for bit,
    attention within 1e-4 of max |plain| (float32).  Prints the launches,
    the ms a step and the peak memory.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing the five kernels (with their
launches in zamba2's two training runs, ``train_launches``, for the four
on that path, and in rwkv6's, ``train_rwkv6_launches``, for the three on
its; for the select networks also ``serve_mesh_launches``, their
launches on each rank of phase 3's ``[serve_mesh]``, ``smoke_launches``,
their launches in each smoke of phase 8, ``examples_launches``, in each example of phase
24, and ``kimi_engine_launches``, in phase 23's engine; for
``flash_attention`` also ``train_mesh_launches``, its launches on each
rank of phase 3's ``[train_mesh]``, ``zoo_launches``,
its launches in the f32
prefills of phases 14-16, in whisper's decode step and in phase 18's
shard_map prefill, ``zoo_bf16_ms``, its device time a call in their bf16
prefills, ``dense_launches`` and ``dense_bf16_ms``, the same for phase
17, ``train_zoo_launches``, in phase 22's gradient gates and steps,
``kimi_launches`` and ``kimi_bf16_ms``, the same for phase 23,
``bf16_shape_ms``, its time, bound and SDPA time at each shape of phases
17 and 19, and ``examples_launches``, its launches in serve_kvstore's
prefill and in train_fault_tolerant's steps; for the select networks
``dense_engine_launches``, their launches in each engine of phase 17;
for the three float kernels ``decode_mesh_launches``, their launches on
each rank in the prefill cells of phase 3's ``[decode_mesh]`` by case,
and ``decode_mesh_rank0``, rank 0's first call there: its block, its
error against the plain version and its ms a call), and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the int32 rate of the
# CUDA cores (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per lane of each select network, counted from the
# straight-line CUDA source (compares, logic, selects, address math)
APPLY_OPS_PER_LANE = 260
PROPOSE_OPS_PER_LANE = 520
# table planes the issuer network reads (all 65 but ts_v, ts_m, has_value)
PROPOSE_TAB_READ = 62

M, SESSIONS, KEYS = 5, 800, 2 ** 20
N_OPS = 4000
# [serve]'s seeds: (seed, all-aboard, machine 4 crashed and restarted)
SERVE_SEEDS = ((0, False, False), (1, True, True))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# random planes on the card
# ---------------------------------------------------------------------------

def _randint(torch, g, lo, hi, shape, dev):
    return torch.randint(lo, hi, shape, generator=g, device=dev,
                         dtype=torch.int32)


def apply_inputs(torch, n, seed, dev):
    """(18, n) KV and (12, n) message+registry planes in small ranges so
    every branch of the receiver network is taken."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = _randint(torch, g, -1, 7, (18, n), dev)
    kv[0] = _randint(torch, g, 0, 3, (n,), dev)            # state
    msgreg = _randint(torch, g, -1, 8, (12, n), dev)
    msgreg[0] = _randint(torch, g, 0, 8, (n,), dev)        # kind, 0 = NOOP
    msgreg[10] = _randint(torch, g, 0, 2, (n,), dev)       # has_value
    msgreg[11] = _randint(torch, g, 0, 2, (n,), dev)       # is_registered
    return kv, msgreg


def propose_inputs(torch, pv, m, s, seed, dev):
    """(65, n) tables, (13, n) steered replies (a third idle) and a (4, m)
    block of mixed per-machine quorum parameters."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = m * s
    idx = {f: i for i, f in enumerate(pv.ProposerTable._fields)}
    tab = _randint(torch, g, -1, 5, (65, n), dev)
    tab[idx["phase"]] = _randint(torch, g, 0, 5, (n,), dev)
    abd = _randint(torch, g, 0, 6, (n,), dev)
    tab[idx["abd_phase"]] = torch.where(abd == 5, 9, abd)
    for f in ("lid", "abd_lid"):
        tab[idx[f]] = _randint(torch, g, 0, 2, (n,), dev)
    for f in ("rep_bits", "ack_bits", "abd_rep_bits", "abd_ack_bits",
              "abd_store_bits"):
        tab[idx[f]] = _randint(torch, g, 0, 256, (n,), dev)
    tab[idx["lth_counter"]][::7] = 2 ** 31 - 1               # wraps on +1
    kinds = torch.tensor([-1, -1, -1, 3, 4, 5, 7, 9, 11], dtype=torch.int32,
                         device=dev)
    rep = _randint(torch, g, -1, 6, (13, n), dev)
    rep[0] = kinds[_randint(torch, g, 0, len(kinds), (n,), dev).long()]
    rep[1] = _randint(torch, g, 0, 12, (n,), dev)            # opcode
    rep[2] = _randint(torch, g, -1, 9, (n,), dev)            # src
    rep[3] = _randint(torch, g, 0, 2, (n,), dev)             # lid
    n_machines = torch.tensor([3, 5, 7], dtype=torch.int32, device=dev)[
        _randint(torch, g, 0, 3, (m,), dev).long()]
    majority = n_machines // 2 + 1
    commit_need = torch.where(_randint(torch, g, 0, 2, (m,), dev) == 0, 1,
                              majority - 1).to(torch.int32)
    lth = _randint(torch, g, 1, 5, (m,), dev)
    params = torch.stack([n_machines, majority, commit_need, lth]).to(
        torch.int32).contiguous()
    return tab, rep, params


def staged_inputs(torch, rep, m, s, n_staged, seed, dev):
    """``n_staged`` distinct lanes of an ``m x s`` stack in random order and
    the packed ``(2 + 13, n_staged)`` buffer staging ``rep``'s columns
    there: (flat lane indices, staged buffer, host coordinates)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randperm(m * s, generator=g, device=dev)[:n_staged]
    staged = torch.cat([(idx // s)[None].to(torch.int32),
                        (idx % s)[None].to(torch.int32),
                        rep[:, idx]]).contiguous()
    return idx, staged, staged[:2].cpu().numpy()


# (m, s) of the stack, staged lane counts
STAGED_CASES = [((M, SESSIONS), (0, 1, 19, 127, M * SESSIONS)),
                ((3, 1667), (65, 777)), ((12289, 1), (4099,))]


class Agreement:
    """Accumulated kernel-vs-plain comparison of one kernel."""

    def __init__(self):
        self.mismatches = 0
        self.max_abs_err = 0
        self.compared = 0

    def add(self, torch, got, want, what):
        for a, b in zip(got, want):
            diff = (a.long() - b.long()).abs()
            self.mismatches += int((diff != 0).sum())
            self.max_abs_err = max(self.max_abs_err, int(diff.max()))
            self.compared += a.numel()
        if self.mismatches:
            raise AssertionError(f"{what}: {self.mismatches} elements "
                                 f"differ from the plain version")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _demangle(names, tool_dir):
    """``{mangled: "kernel<template args>"}`` through the toolkit's
    ``cu++filt`` (or binutils' ``c++filt``); the mangled name where
    neither is found."""
    tools = [pathlib.Path(tool_dir) / "cu++filt", shutil.which("cu++filt"),
             shutil.which("c++filt")]
    tool = next((str(t) for t in tools if t and pathlib.Path(t).is_file()),
                None)
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}
    return {n: _short_name(d) for n, d in zip(names, out)}


def _short_name(demangled: str) -> str:
    """``void <unnamed>::k<(int)7, (bool)0>(float const*, ...)`` ->
    ``k<7, 0>``: drop the return type, the namespace, the parameter list
    and the casts ``cu++filt`` puts on template arguments."""
    d = demangled.strip()
    if d.endswith(")"):                     # cut the trailing (params)
        depth = 0
        for i in range(len(d) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0:
                d = d[:i]
                break
    d = re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", d)
    for prefix in ("<unnamed>::", "(anonymous namespace)::"):
        d = d.replace(prefix, "")
    return d.removeprefix("void ").strip()


def phase_build(build):
    """Build the kernels; one line per kernel with ptxas' registers, static
    shared memory, stack and spills (the float kernels' tiles live in
    dynamic shared memory, whose size each .cu header states)."""
    lib = build.build()
    # another tree's package (scripts/chip_phases.py --src) may build
    # outside this one
    where = (lib.path.relative_to(ROOT) if lib.path.is_relative_to(ROOT)
             else lib.path)
    log(f"[build] nvcc {lib.build_seconds:.2f} s -> {where}")
    usage, kernel = {}, None
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line and "'" in line:
            kernel = line.split("'")[1]
            usage[kernel] = []
        elif kernel and ("registers" in line or "spill" in line):
            usage[kernel].append(line.replace("ptxas info    :", "").strip())
    names = _demangle(list(usage), pathlib.Path(build.nvcc()).parent) \
        if usage else {}
    for mangled, parts in usage.items():
        log(f"[build] {names[mangled]}: {'; '.join(parts)}")
    return lib


def phase_kernels(torch, apply_ops, propose_ops, pv, dev):
    apply_ok, propose_ok = Agreement(), Agreement()
    for i, n in enumerate((M * KEYS, 1, 127, 5000, 12289)):
        kv, msgreg = apply_inputs(torch, n, 100 + i, dev)
        got = apply_ops.paxos_apply(kv, msgreg)
        want = apply_ops.paxos_apply_plain(kv, msgreg)
        torch.cuda.synchronize()
        apply_ok.add(torch, got, want, f"paxos_apply n={n}")
        log(f"[kernels] paxos_apply n={n}: 0 mismatches over "
            f"{sum(t.numel() for t in got)} outputs")
    for i, (m, s) in enumerate(((M, SESSIONS), (1, 1), (1, 127),
                                (3, 1667), (12289, 1))):
        tab, rep, params = propose_inputs(torch, pv, m, s, 200 + i, dev)
        got = propose_ops.paxos_propose(tab, rep, params, s)
        want = propose_ops.paxos_propose_plain(tab, rep, params, s)
        torch.cuda.synchronize()
        propose_ok.add(torch, got, want, f"paxos_propose {m}x{s}")
        decisions = torch.unique(got[1][0]).numel()
        log(f"[kernels] paxos_propose {m}x{s}: 0 mismatches over "
            f"{sum(t.numel() for t in got)} outputs, {decisions} distinct "
            f"decisions")
    for i, ((m, s), counts) in enumerate(STAGED_CASES):
        tab, rep, params = propose_inputs(torch, pv, m, s, 250 + i, dev)
        for j, n_staged in enumerate(counts):
            phase_staged_case(torch, propose_ops, tab, rep, params, m, s,
                              n_staged, 260 + 10 * i + j, propose_ok, dev)
    _staged_refusals(torch, propose_ops, pv, dev)
    return apply_ok, propose_ok


def phase_staged_case(torch, propose_ops, tab, rep, params, m, s, n_staged,
                      seed, propose_ok, dev):
    """The staged kernel against its plain version on clones of one table:
    the compact outputs and the whole table after the in-place call (the
    unstaged lanes untouched); with every lane staged, also against the
    whole-stack kernel."""
    idx, staged, coords = staged_inputs(torch, rep, m, s, n_staged, seed, dev)
    tab_k, tab_p = tab.clone(), tab.clone()
    got = propose_ops.paxos_propose_staged(tab_k, staged, params, s,
                                           coords=coords)
    want = propose_ops.paxos_propose_staged_plain(tab_p, staged, params, s)
    torch.cuda.synchronize()
    what = f"paxos_propose_staged {m}x{s} L={n_staged}"
    pairs = [(tab_k, tab_p)] + ([(got, want)] if n_staged else [])
    propose_ok.add(torch, *zip(*pairs), what)
    note = ""
    if n_staged == m * s:
        whole_tab, whole_act = propose_ops.paxos_propose(
            tab, propose_ops.dense_replies(staged, m, s), params, s)
        rows = torch.from_numpy(propose_ops.CHANGED_ROWS).to(dev)
        torch.cuda.synchronize()
        propose_ok.add(torch, [tab_k, got[:14], got[14:]],
                       [whole_tab, whole_act[:, idx],
                        whole_tab[rows][:, idx]],
                       f"{what} vs the whole-stack kernel")
        note = "; equal to the whole-stack kernel"
    changed = int((tab_k != tab).any(0).sum())
    log(f"[kernels] {what}: 0 mismatches over {got.numel()} outputs and "
        f"the whole {tuple(tab.shape)} table ({changed} lanes changed, "
        f"{torch.unique(got[0]).numel() if n_staged else 0} distinct "
        f"decisions){note}")


def _staged_refusals(torch, propose_ops, pv, dev):
    """A duplicate or out-of-range staged coordinate raises before any
    launch."""
    import numpy as np

    tab, rep, params = propose_inputs(torch, pv, 2, 4, 290, dev)
    for what, coords in (("duplicate", [[1, 0, 1], [3, 2, 3]]),
                         ("row out of range", [[0, 2], [0, 1]]),
                         ("lane out of range", [[0, 1], [4, 1]])):
        c = np.array(coords, np.int32)
        staged = torch.cat([torch.from_numpy(c).to(dev),
                            rep[:, :c.shape[1]]]).contiguous()
        before = propose_ops.paxos_propose.launches
        try:
            propose_ops.paxos_propose_staged(tab, staged, params, 4, coords=c)
        except ValueError as exc:
            if propose_ops.paxos_propose.launches != before:
                raise AssertionError(f"staged {what}: launched before "
                                     f"refusing")
            log(f"[kernels] paxos_propose_staged {what}: refused ({exc})")
            continue
        raise AssertionError(f"paxos_propose_staged accepted a {what}")


def _make_cluster(mods, machine_cls, seed, aboard, n_ops, trace=False):
    cfg = mods.ProtocolConfig(n_machines=M, sessions_per_machine=SESSIONS,
                              all_aboard=aboard)
    net = mods.NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                         heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = mods.Cluster(cfg, net, machine_cls=machine_cls)
    if trace:
        cl.enable_msg_trace()
        cl.enable_issuer_trace()
    mods.workload(cl, n_ops=n_ops, keys=KEYS, seed=seed, rmw_frac=0.1,
                  write_frac=0.2)
    return cl


def _serve_cluster(mods, machine_cls, seed, aboard, crash, n_ops,
                   trace=False):
    t0 = time.perf_counter()
    cl = _make_cluster(mods, machine_cls, seed, aboard, n_ops, trace)
    if crash:
        cl.step(8)
        cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
        cl.crash(4)
        cl.step(6)
        cl.restart(4)
    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"seed {seed}: cluster did not quiesce")
    return cl, time.perf_counter() - t0


def _snapshot(v):
    """A copy of a tensor (outside any autograd graph) or array argument;
    other values as they are."""
    if hasattr(v, "clone"):
        return v.detach().clone()
    return v.copy() if hasattr(v, "copy") else v


class Recorder:
    """Clones the inputs and outputs of a few fused calls on the card;
    ``after`` names positional arguments updated in place, which are
    cloned again after the call and kept after the outputs."""

    def __init__(self, torch, fn, keep, after=()):
        self.torch, self.fn, self.keep = torch, fn, set(keep)
        self.after = tuple(after)
        self.calls = 0
        self.samples = []

    def __call__(self, *args, **kw):
        i = self.calls
        self.calls += 1
        if i not in self.keep:
            return self.fn(*args, **kw)
        ins = [_snapshot(a) for a in args]
        kw_in = {k: _snapshot(v) for k, v in kw.items()}
        outs = self.fn(*args, **kw)
        kept = outs if isinstance(outs, (tuple, list)) else [outs]
        self.samples.append((i, ins, kw_in,
                             [o.detach().clone() for o in kept]
                             + [args[j].clone() for j in self.after]))
        return outs


def phase_serve(torch, mods, dev, n_ops):
    ce = mods.cluster_engine
    rec_r = Recorder(torch, ce._fused_receiver_step, (0, 7, 70, 400))
    # the staged issuer step updates the table (argument 0) in place
    rec_i = Recorder(torch, ce.paxos_propose_staged, (0, 7, 70, 400),
                     after=(0,))
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    runs = []
    # the main path: counts start at 0 here and are read right after
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        for seed, aboard, crash in SERVE_SEEDS:
            torch.cuda.synchronize()
            batched, t_b = _serve_cluster(mods, batched_cls, seed, aboard,
                                          crash, n_ops)
            torch.cuda.synchronize()
            runs.append((seed, aboard, crash, batched, t_b))
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[serve] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # every paxos_propose launch came from the staged entry, one a wave
    issuer_calls = sum(r[3].engine.stats["fused_issuer_calls"] for r in runs)
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"paxos_propose launched {launches['paxos_propose']} times, the "
            f"staged entry was called {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    log(f"[serve] paxos_propose: all {issuer_calls} launches through the "
        f"staged entry, one an issuer wave")

    waves_all = 0
    for seed, aboard, crash, batched, t_b in runs:
        scalar, t_s = _serve_cluster(mods, mods.Machine, seed, aboard,
                                     crash, n_ops)
        got = mods.completion_tuples(batched)
        want = mods.completion_tuples(scalar)
        if got != want:
            first = next((a, b) for a, b in zip(got, want) if a != b) \
                if len(got) == len(want) else (len(got), len(want))
            raise AssertionError(f"seed {seed}: batched completions differ "
                                 f"from scalar: {first}")
        t0 = time.perf_counter()
        mods.checkers.check_all(batched)
        t_chk = time.perf_counter() - t0
        eng = batched.engine
        for stack in (eng.kv, eng.tab):
            if stack.dev.device != dev:
                raise AssertionError(f"a plane stack is on {stack.dev.device}"
                                     f", not on {dev}")
        tel = eng.telemetry()
        waves = tel["waves"]
        waves_all += waves
        kv_shape = tuple(eng.kv.dev.shape)
        log(f"[serve] seed {seed} ({'all-aboard + crash/restart m4' if crash else 'plain'}): "
            f"{len(got)} completions identical to scalar, checkers green "
            f"({t_chk:.2f} s); KV stack {kv_shape} "
            f"({eng.kv.dev.numel() * 4 / 1e9:.3f} GB on {eng.kv.dev.device}), "
            f"tab stack {tuple(eng.tab.dev.shape)}")
        log(f"[serve] seed {seed}: ticks {batched.rounds}, waves {waves}, "
            f"receiver calls {tel['fused_receiver_calls']} "
            f"({tel['fused_receiver_lanes'] / max(1, tel['fused_receiver_calls']):.2f} lanes/call), "
            f"issuer calls {tel['fused_issuer_calls']} "
            f"({tel['fused_issuer_lanes'] / max(1, tel['fused_issuer_calls']):.2f} lanes/call), "
            f"host<->device {tel['transfer_bytes'] / max(1, waves):.0f} B/wave "
            f"({tel['transfer_bytes']} B total: staging up "
            f"{tel['stage_h2d_bytes']}, replies/actions down "
            f"{tel['gather_d2h_bytes']}, KV up {eng.kv.h2d_bytes} / down "
            f"{eng.kv.d2h_bytes}, tab up {eng.tab.h2d_bytes} / down "
            f"{eng.tab.d2h_bytes}; {tel['plane_syncs']} uploads), "
            f"batched wall {t_b:.2f} s, scalar wall {t_s:.2f} s")
        iss_waves = tel["fused_issuer_calls"]
        log(f"[serve] seed {seed}: issuer waves {iss_waves}, host waits "
            f"{tel['issuer_wave_syncs']} "
            f"({tel['issuer_wave_syncs'] / max(1, iss_waves):.2f} a wave), "
            f"tab pull bytes {eng.tab.d2h_bytes}")
    return runs, rec_r, rec_i, launches, waves_all


def phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok):
    for i, ins, _, outs in rec_r.samples:
        kv, msgreg = ins[0], ins[1]
        _, m, k = kv.shape
        want = mods.apply_ops.paxos_apply_plain(kv.view(18, m * k),
                                                msgreg.view(12, m * k))
        got = [outs[0].view(18, m * k), outs[1].view(11, m * k),
               outs[2].view(m * k)]
        apply_ok.add(torch, got, want, f"recorded receiver call {i}")
        log(f"[replay] receiver call {i} ({m}x{k} lanes): equal to plain")
    ops = mods.propose_ops
    for i, ins, _, outs in rec_i.samples:
        # the staged call against the whole-stack plain version: its
        # replies scattered into an idle stack, the whole table compared
        tab, staged, params, s = ins
        out, tab_after = outs
        m = params.shape[1]
        want_tab, want_act = ops.paxos_propose_plain(
            tab, ops.dense_replies(staged, m, s), params, s)
        idx = staged[0].long() * s + staged[1].long()
        rows = torch.from_numpy(ops.CHANGED_ROWS).to(tab.device)
        propose_ok.add(torch, [tab_after, out[:14], out[14:]],
                       [want_tab, want_act[:, idx], want_tab[rows][:, idx]],
                       f"recorded issuer call {i}")
        log(f"[replay] issuer call {i} ({staged.shape[1]} staged lanes of "
            f"{m}x{s}): table and actions equal to the whole-stack plain "
            f"version")
    if not rec_r.samples or not rec_i.samples:
        raise AssertionError("no fused call was recorded")


# ---------------------------------------------------------------------------
# the serve path's lane blocks over ranks
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_RANK_LIMIT = 300.0   # seconds; a rank still running then is killed
MESH_KEEP = (0, 1000)     # the early and the late call a rank replays


def _digest(*arrays) -> str:
    """SHA-256 of numpy arrays' bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def serve_fingerprints(mods, runs):
    """What ``[serve_mesh]`` holds its ranks to, kept on the host: each
    seed's completion digest and wall, the SHA-256 of the engine's host
    mirrors, and of each of the ``MESH_RANKS`` lane blocks of its final
    device stacks."""
    out = {}
    for seed, _aboard, _crash, batched, t_b in runs:
        eng = batched.engine
        blocks = {}
        for tag in ("kv", "tab"):
            st = getattr(eng, tag)
            lps = st.n_lanes // MESH_RANKS
            blocks[tag] = [
                _digest(st.dev[:, :, r * lps:(r + 1) * lps].cpu().numpy())
                for r in range(MESH_RANKS)]
        got = mods.completion_tuples(batched)
        out[seed] = {"completions": mods.completion_digest(got),
                     "n": len(got), "wall": t_b, "blocks": blocks,
                     "mirror": _digest(eng.kv.host, eng.tab.host)}
    return out


def serve_mesh_rank(rank, world, workdir, n_ops):
    """One rank of ``[serve_mesh]``, a spawned process: joins the gloo
    group through the ``FileStore`` in ``workdir``, runs the serve seeds
    with ``BatchedMachine(shards=world)`` on ``cuda:0`` (every rank on the
    one card) and saves what the parent gates to ``rank<r>.pt``; its log
    goes to ``rank<r>.log``."""
    import torch
    import torch.distributed as dist

    work = pathlib.Path(workdir)
    with open(work / f"rank{rank}.log", "w") as f, \
            contextlib.redirect_stdout(f):
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{work}/store",
                                rank=rank, world_size=world)
        try:
            res = _serve_mesh_rank_body(torch, world, dev, n_ops)
        finally:
            dist.destroy_process_group()
        torch.save(res, work / f"rank{rank}.pt")


def _serve_mesh_rank_body(torch, world, dev, n_ops):
    mods = load_modules()
    ce = mods.cluster_engine
    shapes = collections.Counter()
    # host seconds from each launch to the end of its work on the device
    # (the engine waits for it right after anyway, to bring the columns
    # down): with four ranks' contexts on one card, the waits show what
    # sharing it costs
    waits = collections.Counter()
    rec_r = Recorder(torch, ce._fused_receiver_step, MESH_KEEP)
    rec_i = Recorder(torch, ce.paxos_propose_staged, MESH_KEEP, after=(0,))

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(torch, dev)
        waits[name] += time.perf_counter() - t0
        return out

    def receiver(kv, msgreg, out=None):
        shapes[f"paxos_apply {tuple(kv.shape)}"] += 1
        return timed("paxos_apply", rec_r, kv, msgreg, out=out)

    def issuer(tab, staged, params, n_lanes, **kw):
        shapes[f"paxos_propose {(tab.shape[0], params.shape[1], n_lanes)}"] \
            += 1
        return timed("paxos_propose", rec_i, tab, staged, params, n_lanes,
                     **kw)

    machine_cls = functools.partial(mods.BatchedMachine, device=dev,
                                    shards=world)
    runs = {}
    # the main path: counts start at 0 here and are read right after
    _zero_select_counts(mods)
    ce._fused_receiver_step, ce.paxos_propose_staged = receiver, issuer
    try:
        for seed, aboard, crash in SERVE_SEEDS:
            _sync(torch, dev)
            cl, wall = _serve_cluster(mods, machine_cls, seed, aboard, crash,
                                      n_ops)
            _sync(torch, dev)
            mods.checkers.check_all(cl)
            eng = cl.engine
            want = {"kv": (18, M, KEYS // world),
                    "tab": (65, M, SESSIONS // world)}
            for tag, shape in want.items():
                st = getattr(eng, tag)
                if (eng.mesh is None or not st.lane_sharded
                        or tuple(st.dev.shape) != shape
                        or st.dev.device.type != dev.type):
                    raise AssertionError(
                        f"seed {seed}: {tag} stack {tuple(st.dev.shape)} on "
                        f"{st.dev.device}, mesh {eng.mesh}; want the lane "
                        f"block {shape} on {dev}")
            got = mods.completion_tuples(cl)
            runs[seed] = {
                "completions": mods.completion_digest(got), "n": len(got),
                "wall": wall, "ticks": cl.rounds,
                "mirror": _digest(eng.kv.host, eng.tab.host),
                "blocks": {tag: _digest(getattr(eng, tag).dev.cpu().numpy())
                           for tag in want},
                "telemetry": eng.telemetry()}
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = mods.select_launches()
    mods.require_launches(launches, dev)
    apply_ok, propose_ok = Agreement(), Agreement()
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    return {"runs": runs, "launches": dict(launches), "shapes": dict(shapes),
            "waits": dict(waits),
            "replayed": [len(rec_r.samples), len(rec_i.samples)],
            "compared": [apply_ok.compared, propose_ok.compared]}


def _rank_tails(procs, work, tag):
    """Print the tail of each rank's log and kill the ranks still alive."""
    for r in range(len(procs)):
        path = work / f"rank{r}.log"
        tail = path.read_text()[-2000:] if path.is_file() else ""
        log(f"[{tag}] rank {r} log tail:\n{tail}")
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)


def _join_ranks(procs, work, limit, tag="serve_mesh"):
    """Wait for every rank; a rank that fails stops the others at once,
    and a rank still running at ``limit`` seconds is killed.  Raises with
    the tail of each rank's log."""
    deadline = time.monotonic() + limit
    try:
        while True:
            codes = {r: p.exitcode for r, p in enumerate(procs)}
            bad = {r: c for r, c in codes.items() if c not in (None, 0)}
            if bad:
                raise AssertionError(f"[{tag}] ranks exited with codes "
                                     f"{bad}")
            if all(c == 0 for c in codes.values()):
                return
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[{tag}] ranks {[r for r, c in codes.items() if c is None]} "
                    f"still running after {limit:.0f} s; killed")
            time.sleep(0.2)
    except AssertionError:
        _rank_tails(procs, work, tag)
        raise
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)


def phase_serve_mesh(torch, mods, n_ops, want):
    """``[serve]``'s seeds on ``MESH_RANKS`` spawned ranks on the one card,
    a gloo group, ``BatchedMachine(shards=MESH_RANKS)``: each rank holds
    its lane block of the KV and proposer stacks and launches both kernels
    on it.  Each rank's completions, host mirrors and device blocks must
    equal ``[serve]``'s run of the same seed (``want``, from
    :func:`serve_fingerprints`)."""
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="serve_mesh_") as tmp:
        work = pathlib.Path(tmp)
        procs = [ctx.Process(target=serve_mesh_rank,
                             args=(r, MESH_RANKS, tmp, n_ops))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        _join_ranks(procs, work, MESH_RANK_LIMIT)
        ranks = [torch.load(work / f"rank{r}.pt")
                 for r in range(MESH_RANKS)]
    block = {"kv": (18, M, KEYS // MESH_RANKS),
             "tab": (65, M, SESSIONS // MESH_RANKS)}
    log(f"[serve_mesh] {MESH_RANKS} ranks on {torch.cuda.get_device_name(0)}"
        f", gloo group; blocks a rank: KV {block['kv']} "
        f"({18 * M * KEYS // MESH_RANKS * 4 / 1e6:.1f} MB), tab "
        f"{block['tab']}")
    launches = {k: [] for k in mods.cluster_engine.SELECT_NETWORKS}
    for r, res in enumerate(ranks):
        for k in launches:
            launches[k].append(res["launches"][k])
        apply_shape = f"paxos_apply {block['kv']}"
        if set(k for k in res["shapes"] if k.startswith("paxos_apply")) \
                != {apply_shape}:
            raise AssertionError(f"[serve_mesh] rank {r}: paxos_apply ran "
                                 f"at {res['shapes']}, not {apply_shape}")
        calls = {"paxos_apply": 0, "paxos_propose": 0}
        for seed, run in res["runs"].items():
            w = want[seed]
            what = f"[serve_mesh] rank {r} seed {seed}"
            if (run["completions"], run["n"]) != (w["completions"], w["n"]):
                raise AssertionError(f"{what}: {run['n']} completions differ "
                                     f"from [serve]'s {w['n']}")
            if run["mirror"] != w["mirror"]:
                raise AssertionError(f"{what}: host mirror differs from "
                                     f"[serve]'s")
            for tag in ("kv", "tab"):
                if run["blocks"][tag] != w["blocks"][tag][r]:
                    raise AssertionError(f"{what}: {tag} block differs from "
                                         f"block {r} of [serve]'s stack")
            t = run["telemetry"]
            for k in calls:
                calls[k] += t[f"rank_{k}_calls"]
            log(f"{what}: {run['n']} completions, mirror and blocks equal to "
                f"[serve]'s; waves {t['waves']}, paxos_apply "
                f"{t['rank_paxos_apply_calls']} launches "
                f"({t['rank_receiver_lanes'] / max(1, t['rank_paxos_apply_calls']):.2f} lanes a launch), "
                f"paxos_propose {t['rank_paxos_propose_calls']} "
                f"({t['rank_issuer_lanes'] / max(1, t['rank_paxos_propose_calls']):.2f}), "
                f"gathers {t['mesh_gathers']} ({t['mesh_gather_bytes']} B, "
                f"{t['mesh_gather_s']:.2f} s); wall {run['wall']:.2f} s "
                f"against [serve]'s {w['wall']:.2f} s")
        if calls != {k: res["launches"][k] for k in calls}:
            raise AssertionError(f"[serve_mesh] rank {r}: launches "
                                 f"{res['launches']} against engine calls "
                                 f"{calls}")
        wait_ms = {k: round(res["waits"][k] * 1e3 / max(1, n), 3)
                   for k, n in res["launches"].items()}
        log(f"[serve_mesh] rank {r}: launches {json.dumps(res['launches'])}"
            f", launch to end {json.dumps(wait_ms)} ms a call (host clock, "
            f"the recorded calls' clones included); {res['replayed'][0]} "
            f"receiver and {res['replayed'][1]} issuer calls replayed "
            f"bit-equal through the plain versions")
    for seed in want:
        tels = [res["runs"][seed]["telemetry"] for res in ranks]
        walls = [res["runs"][seed]["wall"] for res in ranks]
        log(f"[serve_mesh] seed {seed}, all ranks: paxos_apply "
            f"{sum(t['rank_paxos_apply_calls'] for t in tels)} launches, "
            f"paxos_propose {sum(t['rank_paxos_propose_calls'] for t in tels)}"
            f", receiver lanes {sum(t['rank_receiver_lanes'] for t in tels)} "
            f"(of {tels[0]['fused_receiver_lanes']}), gathers "
            f"{sum(t['mesh_gathers'] for t in tels)} "
            f"({sum(t['mesh_gather_bytes'] for t in tels)} B, "
            f"{sum(t['mesh_gather_s'] for t in tels):.2f} s); wall "
            f"{max(walls):.2f} s (slowest rank) against [serve]'s "
            f"{want[seed]['wall']:.2f} s")
    seconds = time.perf_counter() - t_phase
    log(f"[serve_mesh] phase {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# [train_mesh]: the sharded train step, four ranks on the one card
# ---------------------------------------------------------------------------

# name -> (arch, its cut as dataclasses.replace fields, steps): every
# family at full width, cut in depth to what four ranks and one process
# hold on one card in turn and to the script's time limit.  "dense"
# qwen1.5-4b at 2 of 40 layers (936,537,600 float32 parameters; 4 layers
# and 3 steps until the other families came: with them the script ran
# over the 1110 s of phases it aims at on an H100 at 700 W); "ssm"
# rwkv6-7b at 1 of 32 (755,290,112; its 65536-word vocabulary is most of
# them); "hybrid" zamba2-7b's one unit, 6 Mamba2 layers and the shared
# block (902,732,256; a cut below one unit leaves the shared block's
# leaves unused); "moe" mixtral-8x7b at 1 of 32 (1,713,418,240), the
# shard_map TP MoE its config publishes; "encdec" whisper-large-v3 at 4 of
# its 32 encoder and 4 of its 32 decoder layers (293,808,640) over
# [train_zoo]'s 2 x 1500 frames and 2 x 64 tokens
TRAIN_MESH_CASES = {
    "dense": ("qwen1.5-4b", dict(n_layers=2), 2),
    "ssm": ("rwkv6-7b", dict(n_layers=1), 2),
    "hybrid": ("zamba2-7b", dict(n_layers=6), 2),
    "moe": ("mixtral-8x7b", dict(n_layers=1, moe_impl="shardmap"), 2),
    "encdec": ("whisper-large-v3", dict(n_layers=4, n_enc_layers=4), 2),
}
TRAIN_MESH_SHAPE = (2, 2)  # (data, model)
TRAIN_MESH_TOKENS = 1024  # 2 x 1024 tokens a step, as the other train phases
# seconds a case may take on the ranks, and the ranks may wait for the
# parent's gates of a case; a rank still running then is killed
TRAIN_MESH_LIMIT = 240.0
# every parameter after the steps against one process's, in every case: a
# few times the worst of sound runs (5.57e-05 for qwen, and 4.45e-05,
# 8.18e-05, 4.17e-05 and 1.23e-05 for the other families, on an H100 80GB
# HBM3 at 700 W), below what one wrong-sign gradient block moves (the
# phase's planted reading; 4.4e-04 in each family where it was planted)
TRAIN_MESH_PARAM_TOL = 2e-4
# the planted fault, in "dense": this leaf's gradient negated on one
# "model" block of its first layer, in this step (1-based; step 1's
# gradients are held leaf by leaf, the later steps' only through the
# parameters)
TRAIN_MESH_PLANT = ("units/0/mlp/w_up", 2)


def train_mesh_cfg(mods, name):
    arch, cut, _ = TRAIN_MESH_CASES[name]
    return dataclasses.replace(mods.ARCHS[arch], **cut)


def _block_bounds(t):
    """(start, stop) a dim of this rank's block of DTensor ``t`` in the
    whole tensor (Shard and Replicate placements, mesh dims in order)."""
    coord = t.device_mesh.get_coordinate()
    start, size = [0] * t.dim(), list(t.shape)
    for mdim, pl in enumerate(t.placements):
        if pl.is_shard():
            n = t.device_mesh.size(mdim)
            size[pl.dim] //= n
            start[pl.dim] += coord[mdim] * size[pl.dim]
    return tuple((a, a + n) for a, n in zip(start, size))


def train_mesh_batch(torch, cfg, dev):
    """A step's batch, drawn on the card from a seed (the same on every
    rank and in the one-process run): 2 x TRAIN_MESH_TOKENS tokens, or an
    encoder-decoder's 2 x enc_seq frames and 2 x WHISPER_TOKENS tokens."""
    g = torch.Generator(device=dev).manual_seed(27)
    n = TRAIN_MESH_TOKENS
    batch = {}
    if cfg.family == "encdec":
        n = WHISPER_TOKENS
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=g, device=dev)
    batch["tokens"] = torch.randint(1, cfg.vocab, (2, n), generator=g,
                                    device=dev, dtype=torch.int32)
    return batch


def mesh_rank(rank, world, workdir, phase, *args):
    """One rank of ``[train_mesh]`` or ``[decode_mesh]`` (``phase``), a
    spawned process: joins the gloo group through the ``FileStore`` in
    ``workdir`` on ``cuda:0`` (every rank on the one card), runs the
    phase's rank body (with ``args``) and saves what it returns for the
    parent's gates to ``rank<r>.pt``; its log goes to ``rank<r>.log``."""
    import torch
    import torch.distributed as dist

    body = {"train_mesh": _train_mesh_rank_body,
            "decode_mesh": _decode_mesh_rank_body}[phase]
    work = pathlib.Path(workdir)
    with open(work / f"rank{rank}.log", "w") as f, \
            contextlib.redirect_stdout(f):
        torch.set_num_threads(2)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{work}/store",
                                rank=rank, world_size=world)
        try:
            res = body(torch, dev, work, *args)
        finally:
            dist.destroy_process_group()
        if res is not None:
            torch.save(res, work / f"rank{rank}.pt")


@contextlib.contextmanager
def first_calls(mods):
    """Each float kernel's wrapper in models/blocks.py wrapped to keep its
    first call: ``{kernel: (inputs, keywords, output)}``, detached
    copies."""
    first = {}

    def record(kernel):
        wrapper = _wrapper(mods, kernel)

        def call(*args, **kw):
            out = wrapper(*args, **kw)
            if kernel not in first:
                first[kernel] = ([a.detach().clone() for a in args], kw,
                                 out.detach().clone())
            return out
        return call

    for kernel in FLOAT_KERNELS:
        setattr(mods.blocks, FLOAT_KERNELS[kernel][1], record(kernel))
    try:
        yield first
    finally:
        for kernel in FLOAT_KERNELS:
            setattr(mods.blocks, FLOAT_KERNELS[kernel][1],
                    _wrapper(mods, kernel))


def _train_mesh_rank_body(torch, dev, work, go):
    """Every case of TRAIN_MESH_CASES on this rank, in order: the case's
    results go to ``rank<r>.<case>.pt`` (``.json`` beside it says it is
    whole: its bytes and the seconds the save took), then the rank frees
    the case's tensors and the caching allocator and waits for the
    parent's ``go`` of the case before the next one starts."""
    import gc

    mods = load_modules()
    mesh = mods.make_device_mesh(TRAIN_MESH_SHAPE, dev)
    rank = mesh.get_rank()
    for i, name in enumerate(TRAIN_MESH_CASES):
        res = _train_mesh_case(torch, mods, mesh, name, dev)
        path = work / f"rank{rank}.{name}.pt"
        t0 = time.perf_counter()
        torch.save(res, path)
        done = {"bytes": path.stat().st_size,
                "save_s": time.perf_counter() - t0}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        (work / f"rank{rank}.{name}.json").write_text(json.dumps(done))
        log(f"[train_mesh] {name}: saved {done['bytes']} B in "
            f"{done['save_s']:.2f} s")
        if not go[i].wait(TRAIN_MESH_LIMIT):
            raise RuntimeError(f"[train_mesh] {name}: no go from the parent "
                               f"after {TRAIN_MESH_LIMIT:.0f} s")
    return None


def _train_mesh_case(torch, mods, mesh, name, dev):
    """One case on this rank: the train cell placed by ``place_cell``
    (the parameters a leaf at a time), its steps (counts at 0 just before
    them, read just after; step 1's own gradients, its collectives and
    each float kernel's first call kept), and the rank's blocks of the
    gradients (laid out as their parameters) and of the parameters after
    the steps."""
    cfg = train_mesh_cfg(mods, name)
    n_steps = TRAIN_MESH_CASES[name][2]
    batch = train_mesh_batch(torch, cfg, dev)
    opt_cfg = mods.AdamWConfig(**TRAIN_OPT)
    cell = mods.Shape("train_mesh", batch["tokens"].shape[1], 2, "train")
    torch.cuda.reset_peak_memory_stats()
    with mods.PeerStaged() as staged:
        t0 = time.perf_counter()
        fn, (params, opt_state, placed) = mods.place_cell(
            cfg, cell, mesh, batch, opt_cfg=opt_cfg)
        del batch
        torch.cuda.synchronize()
        t_place = time.perf_counter() - t0
        value_and_grad = mods.steps._value_and_grad
        grads = []

        def record_grads(*a, **kw):
            # the first step's own gradients, kept before its update
            loss, g = value_and_grad(*a, **kw)
            grads.extend(x.detach().clone() for x in g)
            return loss, g

        # the main path: counts at 0 just before the steps, read just after
        losses, norms, walls = [], [], []
        _zero_kernel_counts(mods)
        moe = mods.blocks.apply_moe_shardmap.all_reduces
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                mods.steps._value_and_grad = record_grads
                try:
                    with first_calls(mods) as first, \
                            mods.CollectiveCounter() as counter:
                        params, opt_state, m = fn(params, opt_state, placed)
                finally:
                    mods.steps._value_and_grad = value_and_grad
            else:
                params, opt_state, m = fn(params, opt_state, placed)
            losses.append(float(m["loss"].full_tensor()))
            norms.append(float(m["grad_norm"].full_tensor()))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            log(f"[train_mesh] {name} step {i + 1}: loss {losses[-1]:.7f}, "
                f"grad norm {norms[-1]:.7f}, {walls[-1]:.1f} ms")
        launches = _kernel_counts(mods)
        moe = mods.blocks.apply_moe_shardmap.all_reduces - moe
        # a gradient may hold partial sums: lay it out as its parameter
        grad_blocks = []
        for g, p in zip(grads, mods.leaves(params)):
            g = g.redistribute(mesh, p.placements)
            grad_blocks.append((_block_bounds(g), g.to_local().cpu()))
        del grads, g
    leaves = mods.leaves(params)
    param_blocks = [(_block_bounds(p), p.to_local().cpu()) for p in leaves]
    moments = [(tuple(t.to_local().shape), str(t.placements),
                str(t.to_local().device), str(t.dtype))
               for t in mods.leaves(opt_state.m) + mods.leaves(opt_state.v)]
    step = int(opt_state.step.to_local())
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, placed, leaves, fn
    # each kernel's first call, against its plain version on its block
    kernels = {}
    with torch.no_grad():
        for kernel, (args, kw, out) in first.items():
            want = _plain(mods, kernel)(*args, **kw)
            kernels[kernel] = {"block": tuple(args[0].shape),
                               "err": float((out - want).abs().max()),
                               "scale": float(want.abs().max())}
    del first
    return {"coord": tuple(mesh.get_coordinate()), "losses": losses,
            "grad_norms": norms, "walls_ms": walls, "place_s": t_place,
            "launches": launches, "moe_all_reduces": moe,
            "collectives": counter.result(),
            "staged": {k: (staged.ops[k], staged.bytes[k],
                           staged.seconds[k]) for k in staged.ops},
            "grads": grad_blocks, "params": param_blocks,
            "block_bytes": sum(t.numel() * t.element_size()
                               for _, t in grad_blocks + param_blocks),
            "moments": moments, "step": step, "kernels": kernels,
            "peak_gb": peak, "buffer_gb": staged.peak_buffer_bytes / 1e9}


def _await_case(procs, work, name, deadline, tag):
    """Each rank's ``.json`` note of case ``name``, once every rank has
    written its results; raises at once when a rank has failed, or when
    the case is not written by ``deadline`` (``time.monotonic()``)."""
    notes = [work / f"rank{r}.{name}.json" for r in range(len(procs))]
    while not all(p.is_file() for p in notes):
        bad = {r: p.exitcode for r, p in enumerate(procs)
               if p.exitcode not in (None, 0)}
        if bad:
            raise AssertionError(f"[{tag}] ranks exited with codes {bad}")
        if time.monotonic() > deadline:
            raise AssertionError(
                f"[{tag}] {name}: ranks "
                f"{[r for r, p in enumerate(notes) if not p.is_file()]} "
                f"still running after {TRAIN_MESH_LIMIT:.0f} s; killed")
        time.sleep(0.2)
    return [json.loads(p.read_text()) for p in notes]


def _mesh_heads(cfg):
    """The widths of a config's mixers, for the mesh phases' logs."""
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
             f"{cfg.rwkv_head_dim}" if cfg.family == "ssm" else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    if cfg.family == "hybrid":
        heads += (f", {cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
                  f"state {cfg.ssm_state}")
    if cfg.family == "moe":
        heads += (f", {cfg.n_experts} experts of d_ff {cfg.expert_d_ff}, "
                  f"top {cfg.top_k}, moe_impl {cfg.moe_impl} "
                  f"({cfg.moe_strategy})")
    if cfg.family == "encdec":
        heads += (f", {cfg.n_enc_layers} encoder layers over "
                  f"{cfg.enc_seq} frames")
    return heads


def train_mesh_want(mods, cfg, n_steps):
    """(each float kernel's launches a rank over the steps, the shard_map
    MoE's all-reduces a rank): every kernel as a prefill launches it
    (``expected_launches``), twice a step (the forward and its remat
    recompute), and one all-reduce a MoE layer a step: the recompute
    (``checkpoint``'s early stop) ends with the last tensor the backward
    saved, before the layer's all-reduce."""
    model = mods.build_model(cfg)
    kernels = {k: 2 * n * n_steps
               for k, n in expected_launches(model).items()}
    moe = 0
    if cfg.family == "moe" and cfg.moe_impl == "shardmap":
        moe = cfg.n_layers * n_steps
    return kernels, moe


def train_one_process(torch, mods, cfg, n_steps, dev, plant=None):
    """The case's steps in this process on the same model, parameters and
    batch (a shard_map MoE routed block by block, as each data rank
    routes: ``moe_blocks``): losses, grad norms, step 1's gradients (none
    when ``plant``, which negates its leaf's block in its step), the
    parameters after the steps and ms a step."""
    model = mods.build_model(cfg)
    names = [nm for nm, _ in _named_leaves(model.param_shapes())]
    opt_cfg = mods.AdamWConfig(**TRAIN_OPT)
    batch = train_mesh_batch(torch, cfg, dev)
    params = model.init(0, device=dev)
    state = mods.adamw.init(opt_cfg, params)
    fn = mods.make_train_step(model, opt_cfg)
    value_and_grad = mods.steps._value_and_grad
    first, losses, norms, walls = [], [], [], []

    def hook(*a, **kw):
        loss, g = value_and_grad(*a, **kw)
        if plant is None and not losses:
            first.extend(x.detach().clone() for x in g)
        elif plant is not None and len(losses) + 1 == plant[1]:
            x = g[names.index(plant[0])][0]
            x[..., :x.shape[-1] // 2].neg_()
        return loss, g

    mods.steps._value_and_grad = hook
    try:
        with moe_blocks(torch, mods, cfg, TRAIN_MESH_SHAPE[0]):
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = fn(params, state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        mods.steps._value_and_grad = value_and_grad
    return losses, norms, first, mods.leaves(params), walls


def _train_mesh_gates(torch, mods, name, ranks, dev):
    """Case ``name``'s ranks (their results, by rank) against the same
    model and batch in one process on the card; raises on a gate that
    fails, else returns the case's figures."""
    tag = "train_mesh"
    what = f"[{tag}] {name}"
    cfg = train_mesh_cfg(mods, name)
    n_steps = TRAIN_MESH_CASES[name][2]
    model = mods.build_model(cfg)
    names = [nm for nm, _ in _named_leaves(model.param_shapes())]
    plant = TRAIN_MESH_PLANT if name == "dense" else None
    torch.cuda.reset_peak_memory_stats()
    losses, norms, grads, final, one_ms = train_one_process(
        torch, mods, cfg, n_steps, dev)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{what} one process: losses {losses}, grad norms {norms}; ms a "
        f"step {[round(x, 1) for x in one_ms]}; peak {one_peak:.2f} GB")
    specs = mods.steps.opt_state_specs(model.param_specs(),
                                       mods.AdamWConfig(**TRAIN_OPT))
    mesh_shape = mods.MeshShape(("data", "model"), TRAIN_MESH_SHAPE)
    want_moments = mods.leaves(mods.steps.param_shardings(
        specs.m, model.param_shapes(), mesh_shape))
    want_launches, want_moe = train_mesh_want(mods, cfg, n_steps)
    grad_worst, param_worst, beyond, total = [], 0.0, 0, 0
    for r, res in enumerate(ranks):
        who = f"{what} rank {r} {res['coord']}"
        for got, want, kind in ((res["losses"], losses, "loss"),
                                (res["grad_norms"], norms, "grad norm")):
            rel = max(abs(a / b - 1) for a, b in zip(got, want))
            if len(got) != n_steps or not rel <= LOSS_TOL:
                raise AssertionError(f"{who}: {kind} {got} against one "
                                     f"process {want}: {rel:.3e}")
        for (bounds, block), g, nm in zip(res["grads"], grads, names):
            ref = g[tuple(slice(*b) for b in bounds)]
            grad_worst.append((float((block.to(dev) - ref).abs().max())
                               / max(float(g.abs().max()), 1e-30), nm))
        for (bounds, block), p in zip(res["params"], final):
            diff = (block.to(dev) - p[tuple(slice(*b) for b in bounds)]).abs()
            param_worst = max(param_worst, float(diff.max()))
            beyond += int((diff > 1e-6).sum())
            total += diff.numel()
        if res["step"] != n_steps:
            raise AssertionError(f"{who}: step counter {res['step']}")
        for (local, placement, device, dtype), sh, p in zip(
                res["moments"], want_moments * 2, final * 2):
            if (local != sh.shard_shape(tuple(p.shape))
                    or placement != str(sh.placements)
                    or not device.startswith(dev.type)):
                raise AssertionError(f"{who}: a moment's block {local} "
                                     f"{placement} on {device}, want "
                                     f"{sh.shard_shape(tuple(p.shape))} "
                                     f"{sh.placements} on the card")
        line = []
        for kernel, n in want_launches.items():
            if res["launches"][kernel] != n:
                raise AssertionError(f"{who}: {kernel} launched "
                                     f"{res['launches'][kernel]} times, "
                                     f"want {n}")
            k = res["kernels"].get(kernel)
            if not n:
                continue
            rel = k["err"] / max(k["scale"], 1e-30)
            line.append(f"{kernel} {n} times, its first call on the block "
                        f"{k['block']} within {rel:.3e} of the plain "
                        f"version")
            if not rel <= FLOAT_TOL["float32"]:
                raise AssertionError(f"{who}: {kernel}'s first call on its "
                                     f"block disagrees with the plain "
                                     f"version: {rel:.3e}")
        if res["moe_all_reduces"] != want_moe:
            raise AssertionError(f"{who}: the MoE all-reduced "
                                 f"{res['moe_all_reduces']} times, want "
                                 f"{want_moe}")
        log(f"{who}: launched {'; '.join(line)} (tolerance "
            f"{FLOAT_TOL['float32']:g}); MoE all-reduces "
            f"{res['moe_all_reduces']}; ms a step "
            f"{[round(x, 1) for x in res['walls_ms']]}; placed in "
            f"{res['place_s']:.1f} s; peak {res['peak_gb']:.2f} GB allocated"
            f" and {res['buffer_gb']:.2f} GB of collective buffers")
    grad_worst.sort(reverse=True)
    log(f"{what} step 1's gradient leaves over all ranks' blocks, max "
        f"|g - g_one| over max |g_one|, worst three: "
        f"{', '.join(f'{nm} {e:.3e}' for e, nm in grad_worst[:3])} "
        f"(tolerance {LEAF_TOL:g})")
    del grads
    plant_worst = None
    if plant is not None:
        # the parameter gate's reach: one block of a later step's gradient
        # with the wrong sign, in the same one-process run
        *_, planted, _ = train_one_process(torch, mods, cfg, n_steps, dev,
                                           plant)
        plant_worst = max(float((a - b).abs().max())
                          for a, b in zip(planted, final))
        del planted
    log(f"{what} parameters after {n_steps} steps: max |p - p_one| "
        f"{param_worst:.3e} (bound {TRAIN_MESH_PARAM_TOL:g}); {beyond} of "
        f"{total} elements beyond 1e-6 ({beyond / total:.3e})"
        + (f"; with {plant[0]}'s step {plant[1]} gradient negated on one "
           f"block of its first layer {plant_worst:.3e}" if plant else ""))
    if (not grad_worst[0][0] <= LEAF_TOL
            or not param_worst <= TRAIN_MESH_PARAM_TOL):
        raise AssertionError(f"{what}: the sharded step's gradients or "
                             f"parameters differ from one process's")
    if plant is not None and not plant_worst > TRAIN_MESH_PARAM_TOL:
        raise AssertionError(f"{what}: the parameter gate cannot see a "
                             f"wrong-sign gradient block")
    counts = [res["collectives"] for res in ranks]
    if any(c != counts[0] for c in counts) or not counts[0]["count"]:
        raise AssertionError(f"{what}: the ranks' collectives differ or "
                             f"are none: {counts}")
    log(f"{what} collectives of step 1 a rank (launch/collectives.py, "
        f"bytes a device): {json.dumps(counts[0])}")
    for r, res in enumerate(ranks):
        log(f"{what} rank {r} collectives staged through the group's "
            f"buffers over the placing and the steps (calls, device bytes, "
            f"host s): "
            f"{json.dumps(res['staged'])}")
    step_ms = [statistics.median(res["walls_ms"][1:]) for res in ranks]
    out = {"launches": [{k: res["launches"][k] for k, n in
                         want_launches.items() if n} for res in ranks],
           "kernels": {k: ranks[0]["kernels"][k]
                       for k, n in want_launches.items() if n},
           "moe_all_reduces": want_moe, "collectives": counts[0],
           "step_ms": step_ms, "one_ms": statistics.median(one_ms[1:]),
           "peak_gb": [res["peak_gb"] for res in ranks],
           "buffer_gb": [res["buffer_gb"] for res in ranks],
           "one_peak_gb": one_peak, "param_worst": param_worst,
           "plant_worst": plant_worst}
    del final
    return out


def phase_train_mesh(torch, mods, dev):
    """Every family's train step over ranks: TRAIN_MESH_CASES on a
    TRAIN_MESH_SHAPE (data, model) mesh of spawned ranks on the one card
    (gloo, DTensor's collectives through buffers each group maps on the
    card, ``parallel/peer_staged.py``), spawned once
    for all cases: FSDP over "data", heads, mlp, experts' ff and vocab
    over "model", ZeRO-1 moments, the batch over "data"; the parameters
    drawn a leaf at a time by ``place_cell``, AdamW at TRAIN_OPT.  Each
    case, once its ranks have written it, is held to the same model and
    batch in one process on the card (a shard_map MoE routed block by
    block, as each data rank routes), while the ranks wait: each step's
    loss and grad norm within LOSS_TOL relative, step 1's gradient leaves
    (the first timed step's own) within LEAF_TOL of each leaf's max |g|,
    every parameter after the steps within TRAIN_MESH_PARAM_TOL, which one
    planted wrong-sign gradient block (TRAIN_MESH_PLANT, in "dense") must
    exceed; each rank's moments the blocks ``opt_state_specs`` gives, on
    the card; each float kernel launched on every rank twice a step as
    often as a prefill launches it (counts at 0 just before the steps),
    its first call within FLOAT_TOL of its plain version on its block;
    the shard_map MoE's all-reduce once a layer a step."""
    import tempfile

    import torch.multiprocessing as mp

    tag = "train_mesh"
    t_phase = time.perf_counter()
    require_free(torch, tag)
    world = math.prod(TRAIN_MESH_SHAPE)
    for name, (arch, cut, n_steps) in TRAIN_MESH_CASES.items():
        cfg = train_mesh_cfg(mods, name)
        n = sum(math.prod(t.shape) for t in
                _leaves(mods.build_model(cfg).param_shapes()))
        kernels, moe = train_mesh_want(mods, cfg, n_steps)
        tokens = ("2 x 1500 frames and 2 x 64 tokens"
                  if cfg.family == "encdec"
                  else f"2 x {TRAIN_MESH_TOKENS} tokens")
        log(f"[{tag}] {name}: {arch} at full width (d_model {cfg.d_model}, "
            f"{_mesh_heads(cfg)}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) cut to "
            f"{cut}: {n:,} float32 parameters, {n * 16 / 1e9:.2f} GB with "
            f"gradients and moments ({n * 16 / world / 1e9:.2f} GB a rank); "
            f"{tokens} a step, {n_steps} steps; launches a rank by design "
            f"{json.dumps({k: v for k, v in kernels.items() if v})}, MoE "
            f"all-reduces {moe}")
    log(f"[{tag}] {world} ranks on {torch.cuda.get_device_name(0)} as a "
        f"{TRAIN_MESH_SHAPE} (data, model) mesh, gloo, spawned once")
    ctx = mp.get_context("spawn")
    go = [ctx.Event() for _ in TRAIN_MESH_CASES]
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_mesh_") as tmp:
        work = pathlib.Path(tmp)
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, world, tmp, "train_mesh", go))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for i, name in enumerate(TRAIN_MESH_CASES):
                t_case = time.perf_counter()
                notes = _await_case(procs, work, name,
                                    time.monotonic() + TRAIN_MESH_LIMIT, tag)
                t_ranks = time.perf_counter() - t_case
                t1 = time.perf_counter()
                # mapped, not read: the gates read each block once, from
                # the page cache the ranks just wrote
                ranks = [torch.load(work / f"rank{r}.{name}.pt", mmap=True)
                         for r in range(world)]
                t_load = time.perf_counter() - t1
                written = [n["bytes"] for n in notes]
                log(f"[{tag}] {name}: each rank wrote its gradient and "
                    f"parameter blocks for the gates: "
                    f"{[res['block_bytes'] for res in ranks]} B of blocks "
                    f"in files of {written} B ({sum(written) / 1e9:.2f} GB "
                    f"together), saved in "
                    f"{[round(n['save_s'], 2) for n in notes]} s, mapped "
                    f"here in {t_load:.2f} s")
                out[name] = _train_mesh_gates(torch, mods, name, ranks, dev)
                del ranks
                for r in range(world):
                    (work / f"rank{r}.{name}.pt").unlink()
                release_memory(torch, tag)
                seconds = time.perf_counter() - t_case
                case = out[name]
                case.update(ranks_s=t_ranks, io_bytes=sum(written),
                            load_s=t_load, seconds=seconds)
                held = case["peak_gb"] + case["buffer_gb"]
                log(f"[{tag}] {name}: ms a step a rank (median of steps "
                    f"2-{TRAIN_MESH_CASES[name][2]}) "
                    f"{[round(x, 1) for x in case['step_ms']]}, one process "
                    f"{case['one_ms']:.1f}; peak GB a rank "
                    f"{[round(x, 2) for x in case['peak_gb']]} allocated and "
                    f"{[round(x, 2) for x in case['buffer_gb']]} of buffers "
                    f"({sum(held):.2f} together), one process "
                    f"{case['one_peak_gb']:.2f}; case {seconds:.1f} s (ranks "
                    f"{t_ranks:.1f} s)")
                go[i].set()
            for p in procs:
                p.join(60)
            bad = {r: p.exitcode for r, p in enumerate(procs)
                   if p.exitcode != 0}
            if bad:
                raise AssertionError(f"[{tag}] ranks exited with codes "
                                     f"{bad}")
        except BaseException:
            _rank_tails(procs, work, tag)
            raise
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] ranks spawned to joined {time.perf_counter() - t0:.1f} s; "
        f"phase {seconds:.1f} s")
    return {"cases": out, "seconds": seconds}


# ---------------------------------------------------------------------------
# [decode_mesh]: the decode cell over ranks, four ranks on the one card
# ---------------------------------------------------------------------------

DECODE_MESH_SHAPE = (2, 2)  # (data, model)
# name -> (arch, layers, batch, cache slots, prompt tokens, generated):
# "serve" is decode_32k's layout (batch 4 of 128, a cache of 2048 slots of
# 32,768), qwen1.5-4b at 4 of 40 layers (whole until the recurrent cases
# came, 20 until the MoE and encoder-decoder ones, 8 until every family
# trained in [train_mesh]: its steps a rank were most of the phase, and
# the script's 1200 s limit is shared); "seq" long_500k's (batch 1, a
# cache of 64 slots of 524,288, 32 a data rank), gemma3-12b cut to one
# unit (5 local
# layers and a global one): its 72 tokens cross from data rank 0's block
# into rank 1's, wrap the local rings and clamp the global layer's write
# at its last slot.  "serve" generates 4 tokens (16 picks over its batch),
# not 16, to keep the phase near 100 s: its step a rank takes 1.2 s on an
# H100 (PERF.md section 5); the 16-token prompt is the prefill's (gate 4).
# The recurrent families: "ssm" is rwkv6-7b at 4 of 32 layers (8 until
# the MoE and encoder-decoder cases came) in decode_32k's layout (batch 4 of 128: 2 a data rank; its WKV state by
# batch and heads, 32 of 64 a model rank); "hybrid" zamba2-7b cut to one
# unit (6 Mamba2 layers and the shared block) in long_500k's, as "seq"
# (the shared block's KV sequence over "data", its writes crossing into
# data rank 1's block and clamping at the last slot; the SSM state's 112
# heads, 56 a model rank).  The MoE and encoder-decoder families: "moe" is
# mixtral-8x7b at 2 of 32 layers (3.2 B float32 parameters, 6.5 GB a
# rank in build_cell's serve layout, the experts' ff dim over "model" as
# the shard_map path's in_specs want it) in decode_32k's layout; its
# shard_map MoE routes each data rank's 2 tokens a step on their own (the
# capacity from the block's tokens), one all-reduce over "model" a layer;
# "encdec" whisper-large-v3 with its 32 encoder layers over 1500 frames
# whole and 8 of its 32 decoder layers (whole, the script ran 1115 s of
# phases on an H100 at 700 W, over the 1080 s it aimed at; 16 until every
# family trained in [train_mesh], when it ran 1126.8 s, over 1110) in the
# same layout, its cross caches by batch and heads (zero, as the engine
# leaves them; the prefill cell encodes frames drawn from a seed)
DECODE_MESH_CASES = {"serve": ("qwen1.5-4b", 4, 4, 2048, 16, 4),
                     "seq": ("gemma3-12b", 6, 1, 64, 40, 32),
                     "ssm": ("rwkv6-7b", 4, 4, 2048, 16, 4),
                     "hybrid": ("zamba2-7b", 6, 1, 64, 40, 32),
                     "moe": ("mixtral-8x7b", 2, 4, 2048, 16, 4),
                     "encdec": ("whisper-large-v3", 8, 4, 2048, 16, 4)}
DECODE_MESH_LIMIT = 300.0  # seconds; a rank still running then is killed
# every step's logits and every cache block against one process's, of
# the max |value|: [train_mesh]'s bound for its blocks' products
DECODE_MESH_TOL = 1e-5
DECODE_MESH_COUNT_AT = 2   # the step whose collectives are counted
ALL_GATHER = "_c10d_functional::all_gather_into_tensor"


def decode_mesh_prompts(torch, cfg, b, n):
    """The case's prompts, drawn on the host from a seed (the same on
    every rank and in the one-process run)."""
    g = torch.Generator().manual_seed(28)
    return torch.randint(1, cfg.vocab, (b, n), generator=g).tolist()


def decode_mesh_batch(torch, cfg, prompts, dev):
    """The prefill cell's inputs: the prompts, and an encoder-decoder's
    frames [B, enc_seq, d] drawn on the card from a seed (the same on
    every rank and in the one-process run)."""
    batch = {"tokens": torch.tensor(prompts, dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        g = torch.Generator(device=dev).manual_seed(30)
        batch["frames"] = torch.randn((len(prompts), cfg.enc_seq,
                                       cfg.d_model), generator=g, device=dev)
    return batch


@contextlib.contextmanager
def moe_blocks(torch, mods, cfg, n):
    """In one process, a shard_map MoE config routed as on a mesh of ``n``
    data ranks: each MoE layer routes each of the batch's ``n`` blocks on
    its own (``apply_moe_spmd`` on the block, the capacity from its
    tokens; a batch ``n`` does not divide stays whole, as the data axes
    drop), as each data rank does, aux the blocks' mean; other configs as
    they are."""
    if cfg.family != "moe" or cfg.moe_impl != "shardmap":
        yield
        return
    whole = mods.lm.apply_moe

    def apply(cfg, p, x):
        k = n if x.shape[0] % n == 0 else 1
        ys, aux = zip(*[mods.blocks.apply_moe_spmd(cfg, p, c)
                        for c in x.chunk(k)])
        return torch.cat(ys), torch.stack(aux).mean()

    mods.lm.apply_moe = apply
    try:
        yield
    finally:
        mods.lm.apply_moe = whole


def _decode_mesh_rank_body(torch, dev, work):
    mods = load_modules()
    mesh = mods.make_device_mesh(DECODE_MESH_SHAPE, dev)
    with mods.PeerStaged() as staged:
        return {name: _decode_mesh_case(torch, mods, mesh, staged, name, dev)
                for name in DECODE_MESH_CASES}


class DecodeRecorder:
    """Wraps a model's ``decode_step`` as ``DecodeEngine.generate`` calls
    it: each step's ms (synchronised), its logits whole (gathered after
    the timed step), the last caches, and on a mesh what ``staged`` took
    a step and the counter's collectives of step ``count_at`` with each
    all-gather's input shape."""

    def __init__(self, torch, mods, model, staged=None, count_at=None):
        self.torch, self.mods, self.step = torch, mods, model.decode_step
        self.staged, self.count_at = staged, count_at
        self.ms, self.logits, self.staged_steps = [], [], []
        self.caches, self.collectives, self.gathers = None, None, None
        model.decode_step = self

    def __call__(self, params, caches, tokens):
        torch = self.torch
        before = (None if self.staged is None else
                  (dict(self.staged.ops), dict(self.staged.bytes),
                   dict(self.staged.seconds)))
        counter = (_gather_counter(self.mods)
                   if len(self.ms) == self.count_at
                   else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counter:
            logits, caches = self.step(params, caches, tokens)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if len(self.ms) - 1 == self.count_at:
            self.collectives = counter.result()
            self.gathers = counter.shapes
        if before is not None:
            self.staged_steps.append({
                k: (self.staged.ops[k] - before[0].get(k, 0),
                    self.staged.bytes[k] - before[1].get(k, 0),
                    self.staged.seconds[k] - before[2].get(k, 0.0))
                for k in self.staged.ops})
        whole = logits.full_tensor() if hasattr(logits, "full_tensor") \
            else logits
        self.logits.append(whole.detach().clone())
        self.caches = caches
        return logits, caches


def _written(torch, t, bounds, n, name):
    """A cache leaf's block cut to the slots a run of ``n`` tokens wrote
    (the KV caches ``k`` and ``v``, [..., B, H, S, hd]; the other leaves,
    the recurrent states and lengths, whole) and the largest |value| of
    the slots it cut off (zero, as ``init_cache`` made them)."""
    if name not in ("k", "v"):
        return t.cpu(), 0.0
    start, stop = bounds[-2]
    keep = max(0, min(stop, n) - start)
    tail = t[..., keep:, :]
    return (t[..., :keep, :].cpu(),
            float(tail.abs().max()) if tail.numel() else 0.0)


def _leaf_names(tree, name=None):
    """Each leaf's key in a cache tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], k)]
    if isinstance(tree, (tuple, list)):
        return [n for t in tree for n in _leaf_names(t, name)]
    return [name]


def _gather_counter(mods):
    """The collective counter that also keeps each all-gather's input
    shape (``.shapes``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.collectives import collective_kind

    class Gathers(mods.CollectiveCounter):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (not any(issubclass(t, DTensor) for t in types) and
                    collective_kind(func._schema.name) == "all-gather"):
                self.shapes.append(tuple(args[0].shape))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Gathers()


def activation_gathers(mods, cfg, b):
    """The all-gathers' input shapes a decode step of ``cfg`` at batch
    ``b`` runs on DECODE_MESH_SHAPE by design: zamba2's in-projection
    [B/data, 1, cols/model] a Mamba2 layer (its columns pack z | x | B | C
    | dt, whose bounds an even cut does not keep: ``blocks._mamba_split``),
    none in the other families' steps (both head counts split or neither:
    no query gather)."""
    d, m = DECODE_MESH_SHAPE
    if cfg.family != "hybrid" or m == 1:
        return []
    cols = 2 * cfg.ssm_heads * cfg.ssm_head_dim + \
        2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    layers = mods.build_model(cfg)
    n = sum(k == "mamba" for k in list(layers.unit) * layers.repeats
            + list(layers.tail))
    return [(b // d if b % d == 0 else b, 1, cols // m)] * n


def _decode_mesh_case(torch, mods, mesh, staged, name, dev):
    """One case of ``[decode_mesh]`` on this rank: the decode cell placed
    by ``place_cell`` (the parameters a leaf at a time), served through
    ``DecodeEngine.generate`` on the placed parameters; then the prefill
    cell of the same model and prompts on the same mesh, through the
    float kernels on the rank's blocks (counts at 0 just before), each
    kernel's first call kept and, on rank 0, timed on its block."""
    arch, layers, b, slots, plen, gen = DECODE_MESH_CASES[name]
    cfg = _cut(mods, arch, layers)
    prompts = decode_mesh_prompts(torch, cfg, b, plen)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, (params, caches, _) = mods.place_cell(
        cfg, mods.Shape("decode_mesh", slots, b, "decode"), mesh,
        {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=dev)})
    del caches                     # the engine makes its own
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    layout = [(tuple(p.to_local().shape), str(p.placements),
               p.to_local().numel() * p.element_size())
              for p in mods.leaves(params)]
    model = mods.build_model(cfg)
    rec = DecodeRecorder(torch, mods, model, staged, DECODE_MESH_COUNT_AT)
    engine = mods.DecodeEngine(model, params, mods.ServeConfig(
        max_seq=slots, batch=b), device=dev)
    _zero_kernel_counts(mods)
    all_reduces = mods.blocks.apply_moe_shardmap.all_reduces
    t0 = time.perf_counter()
    generated = engine.generate(prompts, gen)
    t_decode = time.perf_counter() - t0
    decode_launches = _kernel_counts(mods)
    all_reduces = mods.blocks.apply_moe_shardmap.all_reduces - all_reduces
    caches = []
    for t, leaf in zip(mods.leaves(rec.caches), _leaf_names(rec.caches)):
        bounds = _block_bounds(t)
        block, tail = _written(torch, t.to_local(), bounds, plen + gen, leaf)
        caches.append((bounds, block, tail, str(t.placements)))
    logits = torch.stack(rec.logits).cpu()
    del rec.caches, rec.logits, params, engine
    # gate 4: the prefill cell of the same model and prompts on this mesh
    pfn, pargs = mods.place_cell(
        cfg, mods.Shape("decode_mesh", plen, b, "prefill"), mesh,
        decode_mesh_batch(torch, cfg, prompts, dev))
    _zero_kernel_counts(mods)
    t0 = time.perf_counter()
    with torch.no_grad(), first_calls(mods) as first:
        prefill = pfn(*pargs).full_tensor().cpu()
    t_prefill = time.perf_counter() - t0
    prefill_launches = _kernel_counts(mods)
    kernels = {}
    for kernel, (args, kw, out) in first.items():
        want = _plain(mods, kernel)(*args, **kw)
        ms = None
        if mesh.get_rank() == 0:
            # after the counts are read: these launches are not the path's
            ms = cuda_ms(torch, lambda: _wrapper(mods, kernel)(*args, **kw),
                         20)
        kernels[kernel] = {"block": tuple(args[0].shape),
                           "err": float((out - want).abs().max()),
                           "scale": float(want.abs().max()), "ms": ms}
    del pargs, first
    return {"coord": tuple(mesh.get_coordinate()),
            "generated": torch.from_numpy(generated),
            "logits": logits if mesh.get_rank() == 0 else None,
            "logits_sha": hashlib.sha256(logits.numpy().tobytes())
            .hexdigest(), "ms": rec.ms, "staged": rec.staged_steps,
            "collectives": rec.collectives, "gathers": rec.gathers,
            "caches": caches, "layout": layout, "place_s": t_place,
            "decode_s": t_decode, "prefill_s": t_prefill,
            "decode_launches": decode_launches,
            "moe_all_reduces": all_reduces,
            "prefill": prefill if mesh.get_rank() == 0 else None,
            "prefill_launches": prefill_launches, "kernels": kernels,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _one_process_decode(torch, mods, name, dev):
    """The case's model, weights and prompts served in this process:
    generated tokens, each step's logits and ms, the caches, the
    top-1/top-2 gap at each greedy pick; for the MoE and encoder-decoder
    families the prefill of the prompts (and frames) too.  A shard_map
    MoE routes block by block, as on the mesh (:func:`moe_blocks`)."""
    arch, layers, b, slots, plen, gen = DECODE_MESH_CASES[name]
    cfg = _cut(mods, arch, layers)
    prompts = decode_mesh_prompts(torch, cfg, b, plen)
    model = mods.build_model(cfg)
    params = model.init(0, device=dev)
    rec = DecodeRecorder(torch, mods, model)
    prefill = None
    with moe_blocks(torch, mods, cfg, DECODE_MESH_SHAPE[0]):
        generated = mods.DecodeEngine(model, params, mods.ServeConfig(
            max_seq=slots, batch=b), device=dev).generate(prompts, gen)
        if cfg.family in ("moe", "encdec"):
            with torch.no_grad():
                prefill = mods.steps.make_prefill(model)(
                    params, decode_mesh_batch(torch, cfg, prompts, dev))
    picks = torch.stack(rec.logits[plen - 1:plen - 1 + gen])
    top = torch.topk(picks, 2, dim=-1).values
    gaps = (top[..., 0] - top[..., 1]).flatten().tolist()
    del params
    return {"generated": torch.from_numpy(generated),
            "logits": torch.stack(rec.logits),
            "ms": rec.ms, "caches": mods.leaves(rec.caches), "gaps": gaps,
            "scale": float(picks.abs().max()), "prefill": prefill}


def phase_decode_mesh(torch, mods, dev):
    """The decode cell over ranks: DECODE_MESH_CASES on a
    DECODE_MESH_SHAPE (data, model) mesh of spawned ranks on the one card
    (gloo, DTensor's collectives through buffers each group maps on the
    card, ``parallel/peer_staged.py``), each served
    by ``DecodeEngine.generate`` on parameters placed by ``place_cell``
    in ``build_cell``'s serve layout (no weight over "data"), its caches
    by ``cache_shardings``.  Held to the same model, weights and prompts
    served in one process on the card: (1) generated tokens equal, (2)
    every step's logits and (3) every rank's cache blocks within
    DECODE_MESH_TOL of the max |value| (the KV caches, the WKV, SSM,
    conv and token-shift states), (4) the prefill cell of the same prompts
    on the same mesh (the float kernels on each rank's blocks:
    ``flash_attention`` once an attention layer, an encoder layer, and
    twice a decoder layer, ``wkv6`` once an RWKV6 layer, ``ssd`` once a
    Mamba2 layer, counts set to 0 just before) gives the last prompt
    step's logits within MODEL_TOL (the MoE's and the encoder-decoder's:
    the same prefill's in one process, the MoE routed block by block as
    on the mesh), each kernel's launches a rank equal to
    ``expected_launches`` and its first call within FLOAT_TOL of its
    plain version on the rank's block (rank 0 times it there by CUDA
    events); the shard_map MoE all-reduces its partial output once a
    layer a decode step; (5) weight-stationary: no weight split over
    "data", the counted step's all-gathers exactly the activations its
    layers gather by design (``activation_gathers``), and where there are
    none a step's staged all-gathers carry fewer bytes than any
    parameter leaf's block on the rank."""
    import tempfile

    import torch.multiprocessing as mp

    tag = "decode_mesh"
    t_phase = time.perf_counter()
    require_free(torch, tag)
    world = math.prod(DECODE_MESH_SHAPE)
    mesh_shape = mods.MeshShape(("data", "model"), DECODE_MESH_SHAPE)
    for name, (arch, layers, b, slots, plen, gen) in \
            DECODE_MESH_CASES.items():
        cfg = _cut(mods, arch, layers)
        _, _, in_sh, _, _ = mods.steps.build_cell(
            cfg, mods.Shape(tag, slots, b, "decode"), mesh_shape)
        serve = all("data" not in str(sh.spec)
                    for sh in mods.leaves(in_sh[0]))
        k = mods.leaves(in_sh[1])[0]
        log(f"[{tag}] {name}: {arch} at full width (d_model "
            f"{cfg.d_model}, {_mesh_heads(cfg)}, vocab {cfg.vocab}), {layers} of "
            f"{mods.ARCHS[arch].n_layers} layers, {cfg.n_params():,} "
            f"float32 parameters; batch {b}, {slots} cache slots, a "
            f"{plen}-token prompt and {gen} generated; build_cell's layout: "
            f"{'serve (no weight over data)' if serve else 'FSDP'} "
            f"({cfg.n_params() * 2 / DECODE_MESH_SHAPE[1] / 1e9:.2f} GB a "
            f"model rank in bf16 < 10); first cache leaf {k.spec}")
        if not serve:
            raise AssertionError(f"[{tag}] {name}: build_cell kept FSDP")
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="decode_mesh_") as tmp:
        work = pathlib.Path(tmp)
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, world, tmp, "decode_mesh"))
                 for r in range(world)]
        for p in procs:
            p.start()
        _join_ranks(procs, work, DECODE_MESH_LIMIT, tag)
        ranks = [torch.load(work / f"rank{r}.pt") for r in range(world)]
    t_ranks = time.perf_counter() - t0
    out = {"launches": {}, "kernels": {}, "step_ms": {}, "peak_gb": {}}
    for name, (arch, layers, b, slots, plen, gen) in \
            DECODE_MESH_CASES.items():
        torch.cuda.reset_peak_memory_stats()
        one = _one_process_decode(torch, mods, name, dev)
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        cfg = _cut(mods, arch, layers)
        got = [res[name] for res in ranks]
        r0 = got[0]
        what = f"[{tag}] {name}"
        # gate 1: the tokens, with the room the picks had
        for r, res in enumerate(got):
            if not torch.equal(res["generated"], one["generated"]):
                raise AssertionError(f"{what}: rank {r} generated "
                                     f"{res['generated'].tolist()}, one "
                                     f"process {one['generated'].tolist()}")
            if res["logits_sha"] != r0["logits_sha"]:
                raise AssertionError(f"{what}: rank {r}'s logits differ "
                                     f"from rank 0's")
        bound = DECODE_MESH_TOL * one["scale"]
        log(f"{what}: generated tokens equal on every rank to one "
            f"process's; smallest top-1/top-2 gap at a pick "
            f"{min(one['gaps']):.4e}, {sum(g <= bound for g in one['gaps'])}"
            f" of {len(one['gaps'])} picks within the logit bound "
            f"{DECODE_MESH_TOL:g} x {one['scale']:.3f} = {bound:.3e} (there "
            f"the token gate says less than gate 2)")
        # gate 2: every step's logits
        want = one["logits"]
        errs = [float((g.to(dev) - w).abs().max() / w.abs().max())
                for g, w in zip(r0["logits"], want)]
        log(f"{what}: {len(errs)} steps' logits, max |l - l_one| over max "
            f"|l_one|: worst {max(errs):.3e} at step {errs.index(max(errs))}"
            f" (bound {DECODE_MESH_TOL:g})")
        if len(errs) != plen + gen or not max(errs) <= DECODE_MESH_TOL:
            raise AssertionError(f"{what}: the logits differ from one "
                                 f"process's")
        # gate 3: every rank's cache blocks
        worst = 0.0
        for r, res in enumerate(got):
            for (bounds, block, tail, _), w in zip(res["caches"],
                                                   one["caches"]):
                ref = w[tuple(slice(a, a + n) for (a, _), n in
                              zip(bounds, block.shape))]
                scale = max(float(w.abs().max()), 1e-30)
                worst = max(worst, float((block.to(dev) - ref).abs().max())
                            / scale)
                if tail:
                    raise AssertionError(f"{what}: rank {r} holds keys "
                                         f"past the written slots")
        log(f"{what}: every rank's cache blocks, max |c - c_one| over the "
            f"leaf's max |c_one|: {worst:.3e} (bound {DECODE_MESH_TOL:g})")
        if not worst <= DECODE_MESH_TOL:
            raise AssertionError(f"{what}: cache blocks differ")
        # gate 4: the prefill cell on the mesh against the decode, or
        # against the same prefill in one process where the two differ by
        # design: a MoE's capacity depends on its token count, whisper's
        # decode rotates by RoPE and reads zero cross caches
        if one["prefill"] is not None:
            hold_logits(tag, f"{name}: the prefill cell on the mesh vs the "
                        f"same prefill in one process",
                        r0["prefill"].to(dev), one["prefill"])
        else:
            hold_logits(tag, f"{name}: the prefill cell on the mesh vs the "
                        f"teacher-forced decode's step {plen}",
                        r0["prefill"].to(dev), want[plen - 1])
        # the shard_map MoE: one all-reduce of the partial output a layer
        # a decode step, on every rank
        moe = 0
        if cfg.family == "moe" and cfg.moe_impl == "shardmap":
            moe = cfg.n_layers * (plen + gen)
        if [res["moe_all_reduces"] for res in got] != [moe] * world:
            raise AssertionError(f"{what}: the MoE all-reduced "
                                 f"{[res['moe_all_reduces'] for res in got]}"
                                 f" times, want {moe} a rank")
        if moe:
            log(f"{what}: the shard_map MoE all-reduced its partial output "
                f"{moe} times a rank over {plen + gen} decode steps, one a "
                f"layer a step")
        runs = {k: n for k, n in
                expected_launches(mods.build_model(cfg)).items() if n}
        for r, res in enumerate(got):
            line = []
            for kernel, n in runs.items():
                k = res["kernels"].get(kernel)
                rel = k["err"] / max(k["scale"], 1e-30) if k else None
                line.append(f"{kernel} {res['prefill_launches'][kernel]} "
                            f"times (want {n}), its first call on the block "
                            f"{k and k['block']} within {rel:.3e} of the "
                            f"plain version" + (f", {k['ms']:.6f} ms a call "
                                                f"(CUDA events)"
                                                if k and k["ms"] else ""))
                if res["prefill_launches"][kernel] != n or \
                        not rel <= FLOAT_TOL["float32"]:
                    raise AssertionError(f"{what}: rank {r}'s prefill "
                                         f"{kernel}")
            others = {k: v for k, v in res["prefill_launches"].items()
                      if k not in runs and v}
            log(f"{what} rank {r} {res['coord']}: the prefill launched "
                f"{'; '.join(line)} (tolerance {FLOAT_TOL['float32']:g}); "
                f"the decode launched {json.dumps(res['decode_launches'])}")
            if others:
                raise AssertionError(f"{what}: rank {r}'s prefill launched "
                                     f"{others}")
        # gate 5: weight-stationary; the step's all-gathers are the
        # activations its layers gather by design, and where there are
        # none a step stages fewer all-gathered bytes than any parameter
        # block holds
        least = min(n for res in got for _, _, n in res["layout"])
        gathered = max(s.get(ALL_GATHER, (0, 0, 0))[1]
                       for res in got for s in res["staged"])
        if any(not pl.startswith("(Replicate()")
               for res in got for _, pl, _ in res["layout"]):
            raise AssertionError(f"{what}: a rank holds a weight split "
                                 f"over data")
        by_design = activation_gathers(mods, cfg, b)
        for r, res in enumerate(got):
            if res["gathers"] != by_design:
                raise AssertionError(f"{what}: rank {r}'s step "
                                     f"{DECODE_MESH_COUNT_AT + 1} "
                                     f"all-gathered {res['gathers']}, by "
                                     f"design {by_design}")
        if not by_design and not gathered < least:
            raise AssertionError(f"{what}: a step all-gathered {gathered} "
                                 f"B, a parameter block is {least} B")
        log(f"{what}: weight-stationary: step {DECODE_MESH_COUNT_AT + 1}'s "
            f"all-gathers {len(by_design)} activations by design "
            f"{sorted(set(by_design))}; the most a rank's step staged in "
            f"all-gathers {gathered} B, the least parameter block {least} B; "
            f"collectives of step {DECODE_MESH_COUNT_AT + 1} a rank (bytes a "
            f"device): {json.dumps(r0['collectives'])}")
        kinds = sorted({k for s in r0["staged"] for k in s})
        per = {k: [statistics.median(s.get(k, (0, 0, 0))[i]
                                     for s in r0["staged"])
                   for i in range(3)] for k in kinds}
        log(f"{what}: staged through the groups' buffers a step on rank 0 "
            f"(median calls, device bytes, host s): {json.dumps(per)}")
        step_ms = [statistics.median(res["ms"]) for res in got]
        stages = [tuple(round(res[k], 2) for k in ("place_s", "decode_s",
                                                    "prefill_s"))
                  for res in got]
        out["step_ms"][name] = step_ms
        out["peak_gb"][name] = [res["peak_gb"] for res in got]
        out["launches"][name] = [{k: res["prefill_launches"][k]
                                  for k in runs} for res in got]
        out["kernels"][name] = {k: r0["kernels"][k] for k in runs}
        log(f"{what}: ms a decode step a rank (median of {plen + gen}): "
            f"{[round(x, 3) for x in step_ms]}, one process "
            f"{statistics.median(one['ms']):.3f}; seconds a rank to place, "
            f"generate and prefill {stages}; peak GB a rank "
            f"{[round(res['peak_gb'], 2) for res in got]}, one process "
            f"{one_peak:.2f}")
        del one
        release_memory(torch, tag)
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] ranks {t_ranks:.1f} s; phase {seconds:.1f} s")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# the differential schedule replay at the serve cell's width
# ---------------------------------------------------------------------------

def _replay_counted(torch, mods, dev, what, fn, count_key, kernel):
    """Run one replay with both kernels' counts at 0; the kernel it drives
    must have launched once a batch or wave (``stats[count_key]``), the
    other not at all.  Logs the device memory the replay itself took at
    its peak (above what was allocated before it)."""
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    mem = ""
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats = fn()
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    if dev.type == "cuda":
        mem = (f", peak device memory "
               f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f}"
               f" GB above {base / 1e9:.3f} GB")
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    want = {name: (stats[count_key] if name == kernel else 0)
            for name in launches}
    if launches != want:
        raise AssertionError(f"[schedule_replay] {what}: launches "
                             f"{launches}, expected {want}")
    unit = {"batches": "batch", "fused_waves": "fused wave"}[count_key]
    log(f"[schedule_replay] {what}: clean in {secs:.2f} s{mem}, {kernel} "
        f"launched {launches[kernel]} times (one a {unit}); stats "
        f"{json.dumps(stats)}")
    return stats, launches[kernel], secs


class _Mutant:
    """``paxos_apply`` for the replay module that corrupts one output lane
    on call ``wave``: ``hit`` picks the lane from the call's inputs and
    records where it lies; ``flip`` corrupts the outputs there."""

    def __init__(self, fn, wave, hit, flip):
        self.fn, self.wave, self.hit, self.flip = fn, wave, hit, flip
        self.calls = 0
        self.where = None

    def __call__(self, kv, msgreg, out=None):
        res = self.fn(kv, msgreg, out=out)
        if self.calls == self.wave:
            self.where = self.hit(msgreg)
            self.flip(res, self.where)
        self.calls += 1
        return res


def _expect_caught(mods, cl, dev, mutant, want_text, what):
    """The fused replay of ``cl`` with ``mutant`` in place of the replay
    module's ``paxos_apply`` must raise a mismatch whose text holds
    ``want_text(mutant.where)``."""
    rp = mods.replay
    rp.paxos_apply = mutant
    try:
        rp.replay_cluster_fused(cl, n_keys=KEYS, device=dev)
    except rp.ReplayMismatch as exc:
        text = str(exc)
    else:
        raise AssertionError(f"[schedule_replay] {what}: the fused replay "
                             f"did not raise")
    finally:
        rp.paxos_apply = mutant.fn
    want = want_text(mutant.where)
    if want not in text:
        raise AssertionError(f"[schedule_replay] {what}: the mismatch does "
                             f"not name {want!r}: {text[:400]}")
    log(f"[schedule_replay] {what}: caught, {text.splitlines()[0][:200]}")


def phase_schedule_replay(torch, mods, dev, n_ops):
    """The differential replay of faulty full-width schedules on the card:
    the port's scalar cluster (both taps on) at 5 x 800 sessions x 2^20
    keys, seed 0 plain and seed 1 all-aboard with machine 4 crashed and
    restarted, replayed per machine, fused, sharded over 4 shards and on
    the issuer side through the CUDA kernels; seed 0's batched cluster's
    own traces too; and two corrupted kernel outputs that must be
    caught."""
    rp = mods.replay
    totals = {"paxos_apply": 0, "paxos_propose": 0}
    t_phase = time.perf_counter()
    scalar_stats = {}
    clusters = {}
    for seed, aboard, crash in ((0, False, False), (1, True, True)):
        cl, t_run = _serve_cluster(mods, mods.Machine, seed, aboard, crash,
                                   n_ops, trace=True)
        clusters[seed] = cl
        sizes = [(len(m.msg_trace), len(m.issuer_trace))
                 for m in cl.machines]
        log(f"[schedule_replay] seed {seed} "
            f"({'all-aboard + crash/restart m4' if crash else 'plain'}): "
            f"scalar cluster {t_run:.2f} s, {len(cl.history)} ops; "
            f"messages / issuer events a machine {sizes}; num_gsess "
            f"{cl.cfg.num_gsess}")
        runs = (
            ("per machine", lambda: rp.replay_cluster(
                cl, n_keys=KEYS, device=dev), "batches", "paxos_apply"),
            ("fused", lambda: rp.replay_cluster_fused(
                cl, n_keys=KEYS, device=dev), "fused_waves", "paxos_apply"),
            ("sharded x4", lambda: rp.replay_sharded(
                cl, n_keys=KEYS, shards=4, device=dev), "fused_waves",
             "paxos_apply"),
            ("issuer", lambda: rp.replay_issuer_cluster(cl, device=dev),
             "batches", "paxos_propose"))
        for what, fn, key, kernel in runs:
            stats, n, _ = _replay_counted(torch, mods, dev,
                                          f"seed {seed} {what}", fn, key,
                                          kernel)
            totals[kernel] += n
            scalar_stats[(seed, what)] = stats

    # the loop closed on the card: the batched cluster's own traces
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    bcl, t_run = _serve_cluster(mods, batched_cls, 0, False, False, n_ops,
                                trace=True)
    _sync(torch, dev)
    log(f"[schedule_replay] seed 0 batched cluster on the card with both "
        f"taps: {t_run:.2f} s, {len(bcl.history)} ops")
    for what, fn, key, kernel in (
            ("fused", lambda: rp.replay_cluster_fused(
                bcl, n_keys=KEYS, device=dev), "fused_waves", "paxos_apply"),
            ("issuer", lambda: rp.replay_issuer_cluster(bcl, device=dev),
             "batches", "paxos_propose")):
        stats, n, _ = _replay_counted(torch, mods, dev,
                                      f"seed 0 batched {what}", fn, key,
                                      kernel)
        totals[kernel] += n
        if stats != scalar_stats[(0, what)]:
            raise AssertionError(
                f"[schedule_replay] the batched cluster's {what} replay "
                f"stats {stats} differ from the scalar cluster's "
                f"{scalar_stats[(0, what)]}")
    log("[schedule_replay] seed 0: the batched cluster's traces replay "
        "with the scalar cluster's stats")
    del bcl

    # the gate is live: one corrupted reply lane, one corrupted KV lane no
    # message touched, each on one wave of seed 0's fused replay
    cl = clusters[0]
    real = rp.paxos_apply
    noop = mods.noop_kind
    op = rp._REP_INDEX["opcode"]

    def first_staged(msgreg):
        lane = int((msgreg[0] != noop).nonzero()[0, 0])
        return divmod(lane, KEYS)

    def flip_reply(res, where):
        res[1][op, where[0] * KEYS + where[1]] ^= 1

    _expect_caught(mods, cl, dev, _Mutant(real, 5, first_staged, flip_reply),
                   lambda w: f"fused reply diverged at wave 5, machine "
                             f"{w[0]}, key {w[1]}", "a flipped reply lane")

    row = 2
    touched = {m.key for m in cl.machines[row].msg_trace}
    key = next(k for k in range(KEYS - 1, -1, -1) if k not in touched)
    field = rp._KV_FIELDS.index("log_no")

    def flip_kv(res, where):
        res[0][field, where[0] * KEYS + where[1]] ^= 1

    _expect_caught(mods, cl, dev,
                   _Mutant(real, 7, lambda msgreg: (row, key), flip_kv),
                   lambda w: f"fused final KV state diverged at machine "
                             f"{w[0]}, key {w[1]} (field: (scalar, fused)):"
                             f" {{'log_no': (0, 1)}}",
                   "a flipped KV lane no message touched")
    if rp.paxos_apply is not real:
        raise AssertionError("[schedule_replay] paxos_apply not restored")
    secs = time.perf_counter() - t_phase
    log(f"[schedule_replay] replays' launches: {json.dumps(totals)}; "
        f"phase {secs:.1f} s")
    return totals


def _is_device_row(row) -> bool:
    return str(getattr(row, "device_type", "")).endswith("CUDA")


def phase_idle(torch, mods, dev, n_ops, ticks=40):
    """Device busy share of the serve path: the device time the profiler
    sees over ``ticks`` ticks of seed 0, against the wall time of the same
    ticks run unprofiled on an identical cluster."""
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    cl = _make_cluster(mods, batched_cls, 0, False, n_ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cl.step(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    twin = _make_cluster(mods, batched_cls, 0, False, n_ops)
    rows, prof_wall_ms = profile_device(torch, lambda: twin.step(ticks))
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[idle] {ticks} ticks of seed 0: wall {wall_ms:.1f} ms unprofiled "
        f"({prof_wall_ms:.1f} ms profiled), device busy {dev_ms:.2f} ms -> "
        f"busy share {dev_ms / wall_ms:.4f}, idle share "
        f"{1 - dev_ms / wall_ms:.4f}")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:8]:
        log(f"[idle]   {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=dev_ms)


# ---------------------------------------------------------------------------
# the operations layer: open-loop load, the flight recorder, live
# reconfiguration with snapshot catch-up
# ---------------------------------------------------------------------------

KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}
# where a failing run's flight recorder is dumped (gitignored)
DUMP_DIR = ROOT / "build" / "flight_dumps"
# the open-loop cell: Poisson arrivals at 25 ops a tick for 200 ticks
OL_RATE, OL_TICKS = 25.0, 200.0
# the storm's 4000 ops, split 14 : 10 : 8 as scripts/reconfig_smoke.py
# splits its three loads
STORM_OPS = (1750, 1250, 1000)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reconcile_paths(rec, cluster, what):
    """The recorder's per-path counters against the completion history,
    exactly (as scripts/open_loop_smoke.py reconciles them)."""
    kinds = collections.Counter(h["kind"].name for h in cluster.history)
    paths = rec.path_counts()
    for kind, names in KIND_TO_PATHS.items():
        got = sum(paths[p] for p in names)
        if got != kinds.get(kind, 0):
            raise AssertionError(
                f"{what}: {kind} path counters ({got}) do not reconcile "
                f"with {kinds.get(kind, 0)} completions")
    if sum(paths.values()) != len(cluster.history):
        raise AssertionError(
            f"{what}: {sum(paths.values())} path counts for "
            f"{len(cluster.history)} completions")


def _first_diff(got, want):
    if len(got) != len(want):
        return f"{len(got)} vs {len(want)} completions"
    return next(f"{a} vs {b}" for a, b in zip(got, want) if a != b)


def open_loop_spec(mods, seed, sessions=SESSIONS, n_keys=KEYS,
                   rate=OL_RATE, ticks=OL_TICKS):
    lg = mods.loadgen
    return lg.OpenLoopSpec(
        seed=seed, n_machines=M, sessions=sessions, n_keys=n_keys,
        zipf_s=0.99, mix=lg.MIXES["kv_mixed"],
        phases=(lg.ArrivalPhase(rate=rate, ticks=ticks),),
        all_aboard=seed == 1, drop_prob=0.02, dup_prob=0.02)


def open_loop_faults(mods):
    return (mods.loadgen.FaultPlan(settle=30.0)
            .crash_restart(4, at=60.0, down_for=25.0)
            .partition(120.0, 150.0, (0, 1, 2), (3, 4)))


class HookClock:
    """Host seconds spent inside a ``FlightRecorder``'s hooks and its
    registry's updates (the machines, engine schedulers and harness call
    them); a hook that calls another counts once.  The schedulers' gauge
    reads before a publish are outside the clock."""

    HOOKS = ("op_begin", "op_event", "rmw_aboard", "rmw_classic",
             "rmw_retry", "rmw_steal", "rmw_help", "quorum_wait", "rmw_end",
             "abd_end", "machine_crash", "note")
    REGISTRY = ("inc", "set_gauge", "observe")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._inside = False

    def wrap(self, rec):
        for obj, names in ((rec, self.HOOKS), (rec.registry, self.REGISTRY)):
            for name in names:
                setattr(obj, name, self._timed(getattr(obj, name)))
        return rec

    def _timed(self, fn):
        def timed(*args, **kw):
            if self._inside:
                return fn(*args, **kw)
            self._inside = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self._inside = False
        return timed


def run_open_loop(torch, mods, dev, spec, machine_cls, mode, clock=None):
    """One open-loop run with a ``FlightRecorder`` in ``mode`` (None: no
    recorder), its hooks timed by ``clock`` if given; returns (result,
    recorder, wall seconds).  The checkers run apart from the timed run
    (``check_open_loop``)."""
    rec = None if mode is None else mods.FlightRecorder(
        mode=mode, meta={"seed": spec.seed, "spec": "chip_smoke open_loop"})
    if clock is not None:
        clock.wrap(rec)
    harness = mods.loadgen.OpenLoopHarness(
        spec, machine_cls=machine_cls, faults=open_loop_faults(mods), obs=rec)
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = harness.run(check=False)
    _sync(torch, dev)
    return res, rec, time.perf_counter() - t0


# The reference's scalar cluster on the [open_loop] specs, recorded by
# tests/test_torch_open_loop.py (which holds the reference to it on every
# test run): seed -> the spec, the faults, the count and SHA-256 of its
# completion tuples and the checkers' verdict.  Seed 1 meets a fault of the
# reference's protocol (ROADMAP, Queue 3): an all-aboard RMW issued by
# machine 4 at its restart (tick 85) commits at a base older than a write
# that completed at tick 66, and the checkers raise it.
REFERENCE_RECORD = ROOT / "tests" / "data" / "open_loop_reference.json"


def reference_record(spec, faults):
    """The reference's recorded run of ``spec`` under ``faults``."""
    record = json.loads(REFERENCE_RECORD.read_text())[str(spec.seed)]
    if (record["spec"] != repr(spec)
            or record["faults"] != repr((faults.settle, faults.events))):
        raise AssertionError(f"{REFERENCE_RECORD.name} records another run "
                             f"for seed {spec.seed}: {record['spec']}")
    return record


def check_open_loop(mods, res, rec, record, what):
    """The harness's ``check=True``: every safety checker on the final
    cluster, a failure noted in the recorder's ring; then the path counters
    against the history.  The run must complete what the reference's run
    completed, tag for tag (by digest), and the checkers must say what they
    said of it: green, or the same violation word for word."""
    got = mods.completion_tuples(res.cluster)
    digest = mods.completion_digest(got)
    if (len(got), digest) != (record["completions"], record["digest"]):
        raise AssertionError(
            f"{what}: {len(got)} completions, digest {digest}; the "
            f"reference's run has {record['completions']}, digest "
            f"{record['digest']}")
    verdict = "green"
    try:
        mods.checkers.check_all(res.cluster)
    except mods.checkers.SafetyViolation as exc:
        rec.note("checker_failure", res.cluster.network.now, error=str(exc))
        if str(exc) != record["checkers"]:
            raise
        verdict = str(exc)
        log(f"[open_loop] {what}: the checkers raise the violation they "
            f"raise on the reference's run of this spec, whose completions "
            f"this run equals (ROADMAP, Queue 3): {exc}")
    if verdict != record["checkers"]:
        raise AssertionError(f"{what}: checkers green, the reference's run "
                             f"raises {record['checkers']!r}")
    reconcile_paths(rec, res.cluster, what)
    return verdict


def phase_open_loop(torch, mods, dev, apply_ok, propose_ok,
                    sessions=SESSIONS, n_keys=KEYS, rate=OL_RATE,
                    ticks=OL_TICKS, profile=True):
    ce = mods.cluster_engine
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    rec_r = Recorder(torch, ce._fused_receiver_step, (0, 7, 70, 400))
    rec_i = Recorder(torch, ce.paxos_propose_staged, (0, 7, 70, 400),
                     after=(0,))
    specs = [open_loop_spec(mods, seed, sessions, n_keys, rate, ticks)
             for seed in (0, 1)]
    runs, clocks = [], []
    # the main path: counts start at 0 here and are read right after
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        for spec in specs:
            clocks.append(HookClock())
            runs.append((spec,) + run_open_loop(
                torch, mods, dev, spec, batched_cls, "sampled", clocks[-1]))
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[open_loop] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched in [open_loop]")
    issuer_calls = sum(r[1].cluster.engine.stats["fused_issuer_calls"]
                       for r in runs)
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"[open_loop] paxos_propose launched {launches['paxos_propose']}"
            f" times, the staged entry was called {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    out = {"launches": launches, "wall_s": {}, "hook_s": {}}
    for (spec, res, rec, wall), clock in zip(runs, clocks):
        what = f"open_loop seed {spec.seed}"
        with mods.flight_guard(rec, str(DUMP_DIR), label=what,
                               stem=f"open_loop_seed{spec.seed}"):
            record = reference_record(spec, open_loop_faults(mods))
            verdict = check_open_loop(mods, res, rec, record, what)
            scalar, s_rec, s_wall = run_open_loop(torch, mods, dev, spec,
                                                  mods.Machine, "sampled")
            check_open_loop(mods, scalar, s_rec, record, what + " scalar")
            got = mods.completion_tuples(res.cluster)
            want = mods.completion_tuples(scalar.cluster)
            if got != want:
                raise AssertionError(f"{what}: batched completions differ "
                                     f"from scalar: {_first_diff(got, want)}")
            if rec.path_counts() != s_rec.path_counts():
                raise AssertionError(f"{what}: path counts differ from "
                                     f"scalar")
            if res.recorder.report() != scalar.recorder.report():
                raise AssertionError(f"{what}: latency report differs from "
                                     f"scalar")
            eng = res.cluster.engine
            if eng.kv.n_lanes != n_keys or eng.kv.dev.device != dev:
                raise AssertionError(
                    f"{what}: KV stack {tuple(eng.kv.dev.shape)} on "
                    f"{eng.kv.dev.device}, want {n_keys} lanes on {dev}")
        lane = res.lane()
        out["wall_s"][spec.seed] = wall
        out["hook_s"][spec.seed] = clock.seconds
        log(f"[open_loop] seed {spec.seed} "
            f"({'all-aboard' if spec.all_aboard else 'plain'}, crash/restart"
            f" m4 at 60, partition [0,1,2]|[3,4] at 120-150): "
            f"{len(got)} completions identical to scalar and to the "
            f"reference's recorded run, checkers "
            f"{'green' if verdict == 'green' else 'as on the reference'}, "
            f"path counters reconcile on both ({json.dumps(rec.path_counts())}"
            f"); KV stack {tuple(eng.kv.dev.shape)}; batched wall "
            f"{wall:.3f} s, scalar wall {s_wall:.3f} s")
        log(f"[open_loop] seed {spec.seed} lane: offered {lane['offered']}, "
            f"completed {lane['completed']}, lost {lane['lost']}, ticks "
            f"{lane['ticks']}, offered {lane['offered_ops_per_tick']} ops a "
            f"tick, achieved {lane['achieved_ops_per_tick']} ops a tick, by "
            f"class {json.dumps(lane['offered_by_class'])}")
        for window, cells in lane["windows"].items():
            log(f"[open_loop] seed {spec.seed} {window}: "
                + json.dumps(cells, sort_keys=True))
        snap = rec.snapshot()
        c, g = snap["counters"], snap["gauges"]
        engine = {k[len("engine."):]: v for k, v in c.items()
                  if k.startswith("engine.")}
        log(f"[open_loop] seed {spec.seed} engine.* counters: "
            + json.dumps(engine, sort_keys=True))
        log(f"[open_loop] seed {spec.seed}: waves {c['engine.waves']}, "
            f"receiver lanes a call "
            f"{g['engine.receiver_lanes_per_call']:.3f}, issuer lanes a call "
            f"{g['engine.issuer_lanes_per_call']:.3f}, transfer bytes a wave "
            f"{c['engine.transfer_bytes'] / max(1, c['engine.waves']):.1f}, "
            f"ring records {len(rec.ring)}")
        log(f"[open_loop] seed {spec.seed} recorder hooks: {clock.calls} "
            f"calls, {clock.seconds:.4f} s of host time, "
            f"{clock.seconds / wall:.4f} of the run's {wall:.3f} s wall, "
            f"{clock.seconds / max(1, c['engine.waves']) * 1e6:.2f} us a "
            f"wave")
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    # what the ring costs: seed 0 with the recorder in mode off (exact
    # counters, no ring) and in mode sampled, in turns
    turns = {"off": [], "sampled": []}
    for mode in ("off", "sampled", "sampled", "off"):
        _, _, w = run_open_loop(torch, mods, dev, specs[0], batched_cls, mode)
        turns[mode].append(w)
    med = {m: statistics.median(ws) for m, ws in turns.items()}
    log(f"[open_loop] recorder cost, seed 0 batched wall in turns (off, "
        f"sampled, sampled, off): "
        + ", ".join(f"{m} {' / '.join(f'{w:.3f}' for w in ws)} s"
                    for m, ws in turns.items())
        + f"; sampled over off {med['sampled'] / med['off'] - 1:+.4f}")
    out["turns"] = turns
    if profile:
        t0 = time.perf_counter()
        rows, prof_ms = profile_device(torch, lambda: run_open_loop(
            torch, mods, dev, specs[0], batched_cls, "sampled"), cpu=False)
        dev_rows = [r for r in rows if _is_device_row(r)
                    and _device_us(r) > 0]
        dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
        others = [dev_ms / (w * 1e3) for w in turns["sampled"]]
        log(f"[open_loop] seed 0 device busy {dev_ms:.2f} ms over the same "
            f"run's {prof_ms:.1f} ms of wall (the device alone traced; "
            f"{time.perf_counter() - t0:.1f} s with the trace's processing):"
            f" busy share {dev_ms / prof_ms:.4f}, idle share "
            f"{1 - dev_ms / prof_ms:.4f}; the same device time over the "
            f"unprofiled sampled turns' walls gives busy shares "
            f"{min(others):.4f}-{max(others):.4f}")
        for r in sorted(dev_rows, key=_device_us, reverse=True)[:6]:
            log(f"[open_loop]   {_device_us(r) / 1e3:9.3f} ms  "
                f"x{r.count:<5d} {r.key[:90]}")
        out["busy_ms"], out["busy_wall_ms"] = dev_ms, prof_ms
    return out


class GrowthRecorder(Recorder):
    """A Recorder that also keeps the first call at each machine-axis size
    (``axis(args)``): the first waves after a joiner's rows were added."""

    def __init__(self, torch, fn, keep, axis, after=()):
        super().__init__(torch, fn, keep, after)
        self.axis = axis
        self.seen = set()

    def __call__(self, *args, **kw):
        m = self.axis(args)
        if m not in self.seen:
            self.seen.add(m)
            self.keep.add(self.calls)
        return super().__call__(*args, **kw)


def storm(mods, machine_cls, seed=0, sessions=SESSIONS, n_keys=KEYS,
          ops=STORM_OPS):
    """scripts/reconfig_smoke.py's storm from 5 members: 5 -> 6 -> 7 -> 6
    -> 7 -> 6, a partition [2]|[0] across the two joins, machine 2 crashed
    across the first leave, the leaver rejoined, the second joiner retired;
    the load on keys 1 .. n_keys - 1 (key 0 is the config register)."""
    cfg = mods.ProtocolConfig(n_machines=M, sessions_per_machine=sessions,
                              reconfig=True)
    net = mods.NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                         heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = mods.Cluster(cfg, net, machine_cls=machine_cls)
    keys = n_keys - 1
    mods.workload(cl, n_ops=ops[0], keys=keys, seed=seed, rmw_frac=0.5,
                  write_frac=0.3, key_base=1)
    cl.step(150)
    cl.network.partition([2], [0])
    cl.join()                                    # epoch 1: 6 members
    second = cl.join()                           # epoch 2: 7 members
    cl.network.heal()
    mods.workload(cl, n_ops=ops[1], keys=keys, seed=seed + 1, rmw_frac=0.5,
                  write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.crash(2)
    cl.leave(1)                                  # epoch 3: 6 members
    cl.restart(2)
    if cl.join(1) != 1:                          # epoch 4: 7 members
        raise AssertionError("the leaver did not rejoin under its own id")
    mods.workload(cl, n_ops=ops[2], keys=keys, seed=seed + 2, rmw_frac=0.6,
                  write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.leave(second)                             # epoch 5: 6 members
    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"storm seed {seed}: cluster did not quiesce")
    st = cl.stats()
    if st["view_epoch"] != 5 or st["view_members"] != 6:
        raise AssertionError(
            f"storm seed {seed} ended at epoch {st['view_epoch']} with "
            f"{st['view_members']} members (want epoch 5, 6 members)")
    return cl


class CatchupClock:
    """Times every ``take_snapshot`` / ``install_snapshot`` the machines
    make (they import both from ``reconfig.catchup`` at call time)."""

    def __init__(self, catchup):
        self.catchup = catchup
        self.events = []
        self._fns = (catchup.take_snapshot, catchup.install_snapshot)

    def __enter__(self):
        take, install = self._fns

        def timed_take(machine):
            t0 = time.perf_counter()
            snap = take(machine)
            self.events.append(("take", machine.mid,
                                time.perf_counter() - t0,
                                sum(v.nbytes for v in snap.values()),
                                len(snap["keys"])))
            return snap

        def timed_install(machine, snap):
            t0 = time.perf_counter()
            install(machine, snap)
            self.events.append(("install", machine.mid,
                                time.perf_counter() - t0,
                                sum(v.nbytes for v in snap.values()),
                                len(snap["keys"])))

        self.catchup.take_snapshot = timed_take
        self.catchup.install_snapshot = timed_install
        return self

    def __exit__(self, *exc):
        self.catchup.take_snapshot, self.catchup.install_snapshot = self._fns


def phase_reconfig(torch, mods, dev, apply_ok, propose_ok,
                   sessions=SESSIONS, n_keys=KEYS, ops=STORM_OPS):
    ce = mods.cluster_engine
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    rec_r = GrowthRecorder(torch, ce._fused_receiver_step, (0,),
                           lambda a: a[0].shape[1])
    rec_i = GrowthRecorder(torch, ce.paxos_propose_staged, (0,),
                           lambda a: a[2].shape[1], after=(0,))
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        with CatchupClock(mods.catchup) as clock:
            _sync(torch, dev)
            t0 = time.perf_counter()
            batched = storm(mods, batched_cls, sessions=sessions,
                            n_keys=n_keys, ops=ops)
            _sync(torch, dev)
            t_b = time.perf_counter() - t0
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[reconfig] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched in [reconfig]")
    issuer_calls = batched.engine.stats["fused_issuer_calls"]
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"[reconfig] paxos_propose launched {launches['paxos_propose']} "
            f"times, the staged entry {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    t0 = time.perf_counter()
    scalar = storm(mods, mods.Machine, sessions=sessions, n_keys=n_keys,
                   ops=ops)
    t_s = time.perf_counter() - t0
    got = mods.completion_tuples(batched)
    want = mods.completion_tuples(scalar)
    if got != want:
        raise AssertionError(f"[reconfig] batched completions differ from "
                             f"scalar: {_first_diff(got, want)}")
    mods.checkers.check_all(scalar)
    mods.checkers.check_all(batched)
    tel = batched.engine.telemetry()
    if tel["row_reloads"] <= 0:
        raise AssertionError("[reconfig] no plane row was reloaded")
    eng = batched.engine
    if eng.kv.n_lanes != n_keys or eng.kv.dev.device != dev:
        raise AssertionError(f"[reconfig] KV stack {tuple(eng.kv.dev.shape)}"
                             f" on {eng.kv.dev.device}")
    st = batched.stats()
    log(f"[reconfig] storm 5 -> 6 -> 7 -> 6 -> 7 -> 6 over {sum(ops)} ops "
        f"({'/'.join(map(str, ops))}): {len(got)} completions identical to "
        f"scalar, checkers green (view transitions included), epoch "
        f"{st['view_epoch']}, {st['view_members']} members "
        f"{batched.active_view.members}, {st['sync_installed']} snapshots "
        f"installed, {st['net_removed_dst']} fenced sends; KV stack "
        f"{tuple(eng.kv.dev.shape)} ({eng.kv.dev.numel() * 4 / 1e9:.3f} GB "
        f"on {eng.kv.dev.device}); row reloads {tel['row_reloads']}, waves "
        f"{tel['waves']}, transfer bytes {tel['transfer_bytes']}; batched "
        f"wall {t_b:.3f} s, scalar wall {t_s:.3f} s")
    for kind, mid, secs, nbytes, nkeys in clock.events:
        verb = "served by" if kind == "take" else "installed on"
        log(f"[reconfig] {kind}_snapshot {verb} m{mid}: {secs:.4f} s, "
            f"{nbytes} B, {nkeys} keys")
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    # the snapshot sees every landed wave: a member's snapshot is its row
    # on the card, plane for plane
    donor = batched.machines[0]
    donor.kvs.flush()
    eng.kv.push()
    _sync(torch, dev)
    snap = mods.catchup.take_snapshot(donor)
    row = eng.kv.dev[:, donor.mid].cpu().numpy()
    for i, f in enumerate(eng.kv.fields):
        if not mods.np.array_equal(snap[f"kv_{f}"], row[i]):
            raise AssertionError(f"[reconfig] snapshot plane {f} differs "
                                 f"from m{donor.mid}'s row on the card")
    log(f"[reconfig] m{donor.mid}'s snapshot equals its KV row on the card "
        f"({row.shape[1]} lanes x {row.shape[0]} planes)")
    catchup_sampled_keys(torch, mods, dev, batched, donor, snap)
    return {"wall_s": t_b, "scalar_s": t_s, "events": clock.events,
            "launches": launches}


def catchup_sampled_keys(torch, mods, dev, cl, donor, snap, n_sample=4096):
    """Holds the whole-row catch-up to the per-key one (a checkout and a
    merge a key) at full width, on ``n_sample`` lanes: up to half of them
    lanes where ``donor``'s snapshot ``snap`` and another member's differ,
    the rest drawn at random.  The per-key read of each sampled key must
    give the whole-row snapshot's entries, and a joiner that installs the
    two snapshots row by row must hold, on the card, what a joiner that
    installs them key by key holds."""
    np, cu = mods.np, mods.catchup
    other = next(m for m in cl.machines if m.mid != donor.mid
                 and m.mid in cl.active_view.members)
    snap2 = cu.take_snapshot(other)
    fields = cu._KV_FIELDS
    differs = np.zeros(len(snap["keys"]), bool)
    for f in fields:
        differs |= snap[f"kv_{f}"] != snap2[f"kv_{f}"]
    rng = np.random.default_rng(0)
    keys = np.flatnonzero(differs)[:n_sample // 2]
    rest = np.setdiff1d(np.arange(len(snap["keys"])), keys)
    keys = np.sort(np.concatenate([keys, rng.choice(
        rest, n_sample - len(keys), replace=False)]))
    for key in keys.tolist():
        lanes = mods.kv_to_lanes(donor.kvs[key])
        if any(lanes[f] != snap[f"kv_{f}"][key] for f in fields):
            raise AssertionError(f"[reconfig] m{donor.mid}'s key {key} read "
                                 f"per key differs from its snapshot")
    donor.kvs.drop_views()
    rows = []
    for install, pick in ((cu._install_kv, lambda sn: sn),
                          (cu._install_kv_per_key, lambda sn: {
                              "keys": sn["keys"][keys],
                              **{f"kv_{f}": sn[f"kv_{f}"][keys]
                                 for f in fields}})):
        m = mods.BatchedMachine(0, cl.cfg, lambda *a: None, lambda: 0.0,
                                device=dev)
        m.kvs.ensure(len(snap["keys"]) - 1)
        t0 = time.perf_counter()
        for sn in (snap2, snap):
            install(m, pick(sn))
        m.kvs.flush()
        m.kvs._stack.push()
        _sync(torch, dev)
        lanes = torch.as_tensor(keys, device=dev)
        rows.append((m.kvs._stack.dev[:, m._mi, lanes],
                     time.perf_counter() - t0))
    (row, t_row), (per_key, t_key) = rows
    if not torch.equal(row, per_key):
        raise AssertionError("[reconfig] whole-row and per-key installs "
                             "differ on the card")
    log(f"[reconfig] catch-up held to the per-key path on {len(keys)} lanes "
        f"({int(differs.sum())} lanes differ between m{donor.mid}'s and "
        f"m{other.mid}'s snapshots): per-key reads equal the snapshot, and "
        f"two installs give the same lanes on the card (whole rows "
        f"{t_row:.3f} s, {len(keys)} keys one by one {t_key:.3f} s)")


def cuda_ms(torch, fn, reps, inner=1, warmup=3):
    """Median milliseconds per call over ``reps`` event-timed groups of
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_us(row) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, attr):
            return float(getattr(row, attr))
    return 0.0


def profile_device(torch, fn, cpu=True):
    """Run ``fn`` under torch.profiler; returns (key_averages rows, wall
    ms of the window).  Device times come from CUPTI; ``cpu=False`` traces
    the device alone (a long host-bound window records millions of host
    operations otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if cpu:
        return prof.key_averages(), wall_ms
    return _device_rows(prof.profiler.kineto_results.events()), wall_ms


def _device_rows(events):
    """key_averages' device rows (key, count, device_type,
    self_device_time_total in us) summed straight from the raw device
    events: a device-only trace holds no host operation that a device event
    could nest under, so a row's self time is its events' durations, and
    building the profiler's own event tree (tens of seconds for a train
    step's 10^5 launches) is skipped."""
    rows = {}
    for e in events:
        kind = str(e.device_type())
        if not kind.endswith("CUDA"):
            continue
        r = rows.get(e.name())
        if r is None:
            r = rows[e.name()] = types.SimpleNamespace(
                key=e.name(), count=0, device_type=kind,
                self_device_time_total=0.0)
        r.count += 1
        r.self_device_time_total += e.duration_ns() / 1e3
    return list(rows.values())


def kernel_device_ms(torch, fn, calls, kernel_name):
    """Mean device time per launch of ``kernel_name`` over a profiled run
    of ``calls`` calls (None when the profiler saw no such kernel)."""
    fn()
    rows, _ = profile_device(torch, lambda: [fn() for _ in range(calls)])
    hits = [r for r in rows if kernel_name in r.key and _device_us(r) > 0]
    if not hits:
        return None
    return (sum(_device_us(r) for r in hits)
            / sum(r.count for r in hits) / 1e3)


def phase_timings(torch, mods, pv, dev, waves_all):
    out = {}
    n = M * KEYS
    kv, msgreg = apply_inputs(torch, n, 7, dev)
    bufs = (torch.empty_like(kv), torch.empty((11, n), dtype=torch.int32,
                                              device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))
    k_call = lambda: mods.apply_ops.paxos_apply(kv, msgreg, out=bufs)
    out["paxos_apply"] = dict(
        event_ms=cuda_ms(torch, k_call, 30),
        device_ms=kernel_device_ms(torch, k_call, 20, "paxos_apply_kernel"),
        plain_ms=cuda_ms(torch, lambda: mods.apply_ops.paxos_apply_plain(
            kv, msgreg), 5, warmup=1),
        bytes=(18 + 12 + 18 + 11 + 1) * 4 * n,
        ops=APPLY_OPS_PER_LANE * n, lanes=n)
    tab, rep, params = propose_inputs(torch, pv, M, SESSIONS, 8, dev)
    nn = M * SESSIONS
    pbufs = (torch.empty_like(tab), torch.empty((14, nn), dtype=torch.int32,
                                                device=dev))
    p_call = lambda: mods.propose_ops.paxos_propose(tab, rep, params,
                                                    SESSIONS, out=pbufs)
    out["paxos_propose"] = dict(
        event_ms=cuda_ms(torch, p_call, 20, inner=50),
        device_ms=kernel_device_ms(torch, p_call, 200,
                                   "paxos_propose_kernel"),
        plain_ms=cuda_ms(torch, lambda: mods.propose_ops.paxos_propose_plain(
            tab, rep, params, SESSIONS), 10, warmup=2),
        bytes=(65 + 13 + 65 + 14) * 4 * nn + 4 * 4 * M,
        ops=PROPOSE_OPS_PER_LANE * nn, lanes=nn)
    for name, t in out.items():
        # the kernel's own time is the profiler's device time; the event
        # time around back-to-back wrapper calls includes host launch cost
        t["ms"] = t["device_ms"] if t["device_ms"] is not None \
            else t["event_ms"]
        t["ms_source"] = ("profiler" if t["device_ms"] is not None
                          else "cuda events")
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                            t["ops"] / INT32_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / INT32_OPS_PER_S else "operations")
        log(f"[time] {name} at {t['lanes']} lanes: kernel {t['ms']:.6f} ms "
            f"({t['ms_source']}; {t['event_ms']:.6f} ms a wrapper call by "
            f"cuda events), bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
            f"{t['bytes']} B, {t['bytes'] / t['ms'] / 1e6:.1f} GB/s "
            f"achieved), plain {t['plain_ms']:.6f} ms")

    phase_staged_timings(torch, mods, tab, rep, params, dev)

    # what the reference's whole-stack transfers would cost a wave at this
    # width: KV pull + re-upload, message staging up, replies + mask down
    host_kv = torch.empty((18, M, KEYS), dtype=torch.int32, pin_memory=True)
    host_st = torch.empty((12, M, KEYS), dtype=torch.int32, pin_memory=True)
    dev_kv = torch.empty((18, M, KEYS), dtype=torch.int32, device=dev)
    dev_st = torch.empty((12, M, KEYS), dtype=torch.int32, device=dev)

    def whole_stack_wave():
        host_kv.copy_(dev_kv)
        dev_kv.copy_(host_kv)
        dev_st.copy_(host_st)
        host_st.copy_(dev_st)

    w_ms = cuda_ms(torch, whole_stack_wave, 5, warmup=1)
    w_bytes = (18 * 2 + 12 * 2) * 4 * M * KEYS
    log(f"[time] whole-stack transfers (not used by the port): "
        f"{w_bytes} B in {w_ms:.3f} ms per wave "
        f"({w_bytes / w_ms / 1e6:.1f} GB/s); x {waves_all} waves of the "
        f"serve phase = {w_ms * waves_all / 1e3:.1f} s")
    return out


def phase_staged_timings(torch, mods, tab, rep, params, dev):
    """The staged entry's device and wrapper time at 19 lanes (a serve
    wave's) and at all 4000 lanes of the 5 x 800 stack, staged in random
    order (each lane's table column is then its own gather) and in lane
    order, against its bytes bound: 8 B of coordinates and 52 B of
    replies, the 62 table planes the network reads, the 44 changed planes
    written back and the 58 output planes, a lane, plus the parameter
    columns of the rows staged."""
    ops = mods.propose_ops
    for n_staged, order in ((19, "random"), (M * SESSIONS, "random"),
                            (M * SESSIONS, "lane")):
        idx, staged, coords = staged_inputs(torch, rep, M, SESSIONS,
                                            n_staged, 9, dev)
        if order == "lane":
            staged = staged[:, idx.argsort()].contiguous()
            coords = staged[:2].cpu().numpy()
        tab_s = tab.clone()
        out = torch.empty((ops.N_OUT, n_staged), dtype=torch.int32,
                          device=dev)
        call = lambda: ops.paxos_propose_staged(tab_s, staged, params,
                                                SESSIONS, out=out,
                                                coords=coords)
        event_ms = cuda_ms(torch, call, 20, inner=50)
        device_ms = kernel_device_ms(torch, call, 200,
                                     "paxos_propose_staged_kernel")
        rows = len(set(coords[0].tolist()))
        n_bytes = (n_staged * (8 + 52 + 4 * PROPOSE_TAB_READ
                               + 4 * ops.N_CHG + 4 * ops.N_OUT)
                   + 4 * 4 * rows)
        ops_t = PROPOSE_OPS_PER_LANE * n_staged / INT32_OPS_PER_S
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, ops_t) * 1e3
        ms = device_ms if device_ms is not None else event_ms
        log(f"[time] paxos_propose_staged at {n_staged} of {M}x{SESSIONS} "
            f"lanes in {order} order: kernel {ms:.6f} ms "
            f"({'profiler' if device_ms is not None else 'cuda events'}; "
            f"{event_ms:.6f} ms a wrapper call by cuda events), bound "
            f"{bound_ms:.6f} ms (bytes, {n_bytes} B), "
            f"{ms / bound_ms:.1f}x the bound")
    phase_issuer_waves(torch, mods, rep, dev)


def phase_issuer_waves(torch, mods, rep, dev, n_staged=19, waves=200):
    """The whole-stack issuer wave against the staged wave, in turns (old,
    new, new, old) on one card, each at ``n_staged`` lanes of a 5 x 800
    stack, as host-clock microseconds a wave (each ends in its download);
    then one profiled pass of 50 staged waves, which must show exactly one
    upload, one staged kernel and one download a wave."""
    import numpy as np

    ce, pv = mods.cluster_engine, mods.pv
    idx, staged, coords = staged_inputs(torch, rep, M, SESSIONS, n_staged,
                                        11, dev)
    s_mi, s_lane = coords[0].tolist(), coords[1].tolist()
    replies = staged[2:].cpu().numpy()
    eng = ce.ClusterEngine(mods.ProtocolConfig(
        n_machines=M, sessions_per_machine=SESSIONS), M, device=dev)
    params = eng._params()
    # the whole-stack wave as the engine ran it before the staged entry,
    # then its later pull of the staged lanes into the host mirror
    all_rows, mi_np, lane_np = np.arange(65), np.asarray(s_mi), \
        np.asarray(s_lane)
    stack = ce.PlaneStack(pv.ProposerTable._fields, pv.TABLE_DEFAULTS, M,
                          SESSIONS, device=dev)
    stage = torch.zeros((13, M, SESSIONS), dtype=torch.int32, device=dev)
    stage[0] = -1
    idle_col = stage[:, 0, :1].clone()
    act_host = np.empty((14, M, SESSIONS), np.int32)

    def old_wave():
        tab_dev = stack.push()
        mi_t, lane_t, vals_t = ce._coords(s_mi, s_lane, replies, dev)
        stage[:, mi_t, lane_t] = vals_t
        out_tab, out_act = ce._fused_issuer_step(
            tab_dev, stage, params, out=stack.out_buffer())
        stage[:, mi_t, lane_t] = idle_col
        act_host[:, s_mi, s_lane] = out_act[:, mi_t, lane_t].cpu().numpy()
        stack.absorb(out_tab)
        stack.absorb_in_place(all_rows, mi_np, lane_np,
                              out_tab[:, mi_t, lane_t].cpu().numpy())

    def new_wave():
        eng.issuer_wave(s_mi, s_lane, replies)

    def turn(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(waves):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e6)
        return out

    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        times[name] += turn(old_wave if name == "old" else new_wave)
    old_us, new_us = (statistics.median(times[k]) for k in ("old", "new"))
    log(f"[time] issuer wave at {n_staged} of {M}x{SESSIONS} lanes, host "
        f"clock, turns old/new/new/old x {waves} waves: whole-stack wave "
        f"(coords, scatter, whole-stack step, reset, gather, pull) "
        f"{old_us:.1f} us, staged wave {new_us:.1f} us (medians; "
        f"{old_us - new_us:.1f} us less a wave)")

    rows, _ = profile_device(torch, lambda: [new_wave() for _ in range(50)])
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    for r in dev_rows:
        log(f"[time]   staged waves x50: {r.count:4d} x {r.key[:80]} "
            f"({_device_us(r) / r.count:.3f} us each)")
    counts = {"HtoD": 0, "kernel": 0, "DtoH": 0}
    for r in dev_rows:
        kind = ("HtoD" if "HtoD" in r.key else "DtoH" if "DtoH" in r.key
                else "kernel" if "paxos_propose_staged_kernel" in r.key
                else r.key)
        counts[kind] = counts.get(kind, 0) + r.count
    if counts != {"HtoD": 50, "kernel": 50, "DtoH": 50}:
        raise AssertionError(f"50 staged issuer waves ran device operations "
                             f"{counts}, not one upload, one kernel and one "
                             f"download a wave")
    log("[time] staged issuer wave: 1 HtoD copy, 1 "
        "paxos_propose_staged_kernel, 1 DtoH copy a wave")


# ---------------------------------------------------------------------------
# the model-serving path: flash attention, Mamba2 SSD and RWKV6 WKV
# ---------------------------------------------------------------------------

# H100 SXM peaks used for the float kernels' bounds (NVIDIA data sheet):
# dense bf16 tensor-core rate, the float32 rate of the CUDA cores, and the
# HBM3 rate above; a float32 product taken as three TF32 tensor-core
# products (3xTF32: lo * hi, hi * lo, hi * hi, flash_attention's and
# mamba2_ssd's float32 paths) at a third of the dense TF32 rate of 495
# TFLOP/s.
BF16_FLOPS_PER_S = 989e12
F32_CUDA_CORE_FLOPS_PER_S = 67e12
F32_3XTF32_FLOPS_PER_S = 495e12 / 3

# kernel vs plain tolerance over unit-normal inputs.  Attention: every
# element within atol + rtol * |plain| with atol = rtol = the figure, as
# tests/test_kernels_attention.py:35 holds bf16 (both round the
# probabilities to bf16 before the value product, the kernel against its
# running maximum and the plain version against the row's: one bf16 ulp of
# an output above 4 is 0.031).  The SSD, the WKV, and the recorded calls of
# the models, against max |plain output|.
FLOAT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (label, B, Hq, Hkv, Sq, Sk, D, causal, window)
FA_CASES = [
    ("zamba2 shared attention", 1, 32, 32, 4096, 4096, 112, True, None),
    ("gemma3-12b local", 1, 16, 8, 2048, 2048, 256, True, 1024),
    ("qwen1.5-4b ragged", 2, 20, 20, 1000, 1000, 128, True, None),
    ("one query, Sk 777", 1, 8, 8, 1, 777, 128, True, None),
    ("Sq < Sk", 1, 8, 8, 300, 1000, 128, True, None),
    ("non-causal", 1, 20, 20, 1500, 1500, 64, False, None),
    ("MQA", 1, 8, 1, 512, 512, 128, True, None),
    ("window straddles key tiles", 1, 8, 8, 129, 129, 112, True, 70),
    ("mixtral window past its edge", 1, 32, 8, 4608, 4608, 128, True, 4096),
    ("qwen2-vl GQA 64/8", 1, 64, 8, 768, 768, 128, True, None),
    ("whisper cross-attention", 2, 20, 20, 64, 1500, 64, False, None),
    ("whisper cross-attention, decode", 2, 20, 20, 1, 1500, 64, False,
     None),
    ("gemma3-12b global", 1, 16, 8, 4096, 4096, 256, True, None),
    ("phi3-mini head dim 96", 1, 32, 32, 4096, 4096, 96, True, None),
    ("qwen2.5-32b GQA 40/8", 1, 40, 8, 4096, 4096, 128, True, None),
    ("kimi-k2 GQA 64/8, head dim 112", 1, 64, 8, 4096, 4096, 112, True,
     None),
]
# (label, B, T, H, P, G, N)
SSD_CASES = [
    ("zamba2 Mamba2 layer", 1, 4096, 112, 64, 1, 64),
    ("T=1", 1, 1, 112, 64, 1, 64),
    ("T=127", 1, 127, 112, 64, 1, 64),
    ("T=1000", 1, 1000, 112, 64, 1, 64),
    ("G=2", 1, 512, 16, 64, 2, 64),
    ("T=65, ragged by one chunk step", 1, 65, 112, 64, 1, 64),
    ("T=4097, ragged by one chunk step", 1, 4097, 112, 64, 1, 64),
    ("N=128, the largest state", 1, 1000, 16, 64, 2, 128),
    ("zamba2-7b train, B=2", 2, 1024, 112, 64, 1, 64),
    ("zamba2-7b train, a rank's head block", 1, 1024, 56, 64, 1, 64),
]
# (label, B, H, T, K, V, decays): see wkv_inputs
WKV_CASES = [
    ("rwkv6-7b prefill", 1, 64, 4096, 64, 64, "moderate"),
    ("smoke config", 2, 4, 37, 32, 32, "moderate"),
    ("T=1", 1, 64, 1, 64, 64, "moderate"),
    ("T=127", 1, 64, 127, 64, 64, "moderate"),
    ("T=1000", 1, 64, 1000, 64, 64, "moderate"),
    ("ragged V", 1, 64, 300, 64, 48, "moderate"),
    ("B=2", 2, 64, 256, 64, 64, "moderate"),
    ("T=65, ragged by one chunk step", 1, 64, 65, 64, 64, "moderate"),
    ("T=4097, ragged by one chunk step", 1, 64, 4097, 64, 64, "moderate"),
    ("K=40", 1, 64, 1000, 40, 64, "moderate"),
    ("strong decays, exact zeros", 1, 64, 1000, 64, 64, "strong"),
    ("w=1 over 4096 steps", 1, 64, 4096, 64, 64, "one"),
]
ZAMBA = "zamba2-7b"
RWKV = "rwkv6-7b"
PROMPT_LEN, PROMPT_BATCH = 128, 2
GEN_SESSIONS, GEN_STEPS = 4, 32
PREFILL_SEQ = 4096
# the float kernels: the ops module's attribute in ``mods``, the name under
# which both the ops module and models/blocks.py hold the wrapper, and the
# plain version's name in the ops module
FLOAT_KERNELS = {
    "flash_attention": ("fa_ops", "flash_attention", "attention_plain"),
    "mamba2_ssd": ("ssd_ops", "ssd", "ssd_plain"),
    "rwkv6_wkv": ("wkv_ops", "wkv6", "wkv6_plain")}


class FloatAgreement:
    """Accumulated kernel-vs-plain comparison of one float kernel."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.max_rel_err = 0.0
        self.compared = 0

    def add(self, got, want, tol, what, relative=False, tag="kernels"):
        got, want = got.float(), want.float()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{what}: the kernel wrote non-finite values")
        abs_err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 1.0
        rel_err = abs_err / max(scale, 1e-30)
        self.max_abs_err = max(self.max_abs_err, abs_err)
        self.max_rel_err = max(self.max_rel_err, rel_err)
        self.compared += got.numel()
        if relative:
            err = rel_err
        else:             # allclose: max(|got - want| - tol |want|) <= tol
            err = float(((got - want).abs() - tol * want.abs()).max()) \
                if got.numel() else 0.0
        log(f"[{tag}] {what}: max abs err {abs_err:.3e}, relative to "
            f"max|plain| {rel_err:.3e} (tolerance {tol:g}"
            f"{' relative to max|plain|' if relative else ' + ' + format(tol, 'g') + ' |plain|'})")
        if not err <= tol:
            raise AssertionError(f"{what}: error {err:.3e} above {tol:g}")
        return rel_err


def _dtype(torch, name):
    return getattr(torch, name)


def fa_inputs(torch, case, dtype, seed, dev):
    _, b, hq, hkv, sq, sk, d, causal, window = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    return (q, k, v), dict(causal=causal, window=window)


def ssd_inputs(torch, case, dtype, seed, dev):
    _, b, t, h, p, g_, n = case
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=g, device=dev)).to(dtype)
    A = -torch.exp(torch.randn((h,), generator=g, device=dev))
    Bm = torch.randn((b, t, g_, n), generator=g, device=dev).to(dtype)
    Cm = torch.randn((b, t, g_, n), generator=g, device=dev).to(dtype)
    return x, dt, A, Bm, Cm


def wkv_inputs(torch, case, dtype, seed, dev):
    """Unit-normal r, k, v, u; decays exp(-exp(x)) as the model makes them,
    by the case's regime: x uniform on [-6, 1] ("moderate", 0.066 ..
    0.9975: near 1 the state carries farthest), on [-1, 5] ("strong":
    about 6 % underflow to exactly 0), or w = 1 exactly ("one": the state
    never decays and grows largest)."""
    _, b, h, t, k, v, regime = case
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn((b, h, t, k), generator=g, device=dev).to(dtype)
    kk = torch.randn((b, h, t, k), generator=g, device=dev).to(dtype)
    vv = torch.randn((b, h, t, v), generator=g, device=dev).to(dtype)
    if regime == "one":
        w = torch.ones((b, h, t, k), device=dev, dtype=dtype)
    else:
        lo, hi = {"moderate": (-6.0, 1.0), "strong": (-1.0, 5.0)}[regime]
        x = torch.rand((b, h, t, k), generator=g, device=dev) * (hi - lo) + lo
        w = torch.exp(-torch.exp(x)).to(dtype)
    u = torch.randn((h, k), generator=g, device=dev)
    return r, kk, vv, w, u


def phase_model_kernels(torch, mods, dev):
    """Each float kernel against its plain version at its cases in
    float32 and bf16; ``agree[name].float32_worst`` is the worst float32
    reading of a kernel's cases, relative to max |plain|."""
    agree = {name: FloatAgreement() for name in FLOAT_KERNELS}
    f32_worst = 0.0
    for i, case in enumerate(FA_CASES):
        for dname in ("float32", "bfloat16"):
            args, kw = fa_inputs(torch, case, _dtype(torch, dname), 300 + i,
                                 dev)
            got = mods.fa_ops.flash_attention(*args, **kw)
            want = mods.fa_ops.attention_plain(*args, **kw)
            torch.cuda.synchronize()
            rel = agree["flash_attention"].add(
                got, want, FLOAT_TOL[dname],
                f"flash_attention {case[0]} {tuple(case[1:7])} "
                f"causal={case[7]} window={case[8]} {dname}")
            if dname == "float32":
                f32_worst = max(f32_worst, rel)
            del args, got, want
    agree["flash_attention"].float32_worst = f32_worst
    log(f"[kernels] flash_attention float32 (3xTF32): worst reading "
        f"{f32_worst:.3e} of max|plain| over the {len(FA_CASES)} cases")
    f32_worst = 0.0
    for i, case in enumerate(SSD_CASES):
        for dname in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, _dtype(torch, dname), 400 + i, dev)
            got = mods.ssd_ops.ssd(*args)
            want = mods.ssd_ops.ssd_plain(*args)
            torch.cuda.synchronize()
            rel = agree["mamba2_ssd"].add(
                got, want, FLOAT_TOL[dname],
                f"mamba2_ssd {case[0]} {tuple(case[1:])} {dname}",
                relative=True)
            if dname == "float32":
                f32_worst = max(f32_worst, rel)
            del args, got, want
    agree["mamba2_ssd"].float32_worst = f32_worst
    log(f"[kernels] mamba2_ssd float32 (3xTF32): worst reading "
        f"{f32_worst:.3e} of max|plain| over the {len(SSD_CASES)} cases")
    f32_worst = 0.0
    for i, case in enumerate(WKV_CASES):
        for dname in ("float32", "bfloat16"):
            args = wkv_inputs(torch, case, _dtype(torch, dname), 500 + i, dev)
            got = mods.wkv_ops.wkv6(*args)
            want = mods.wkv_ops.wkv6_plain(*args)
            torch.cuda.synchronize()
            rel = agree["rwkv6_wkv"].add(
                got, want, FLOAT_TOL[dname],
                f"rwkv6_wkv {case[0]} (B, H, T, K, V) = {tuple(case[1:6])} "
                f"{case[6]} decays {dname}", relative=True)
            if dname == "float32":
                f32_worst = max(f32_worst, rel)
            del args, got, want
    agree["rwkv6_wkv"].float32_worst = f32_worst
    log(f"[kernels] rwkv6_wkv float32 (3xTF32): worst reading "
        f"{f32_worst:.3e} of max|plain| over the {len(WKV_CASES)} cases")
    torch.cuda.empty_cache()
    return agree


def _describe(model) -> str:
    """``81 layers (13 x 6 mamba + shared attention + 3 tail)``."""
    cfg = model.cfg
    if cfg.family == "encdec":
        return (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder "
                f"layers")
    unit = "+".join(sorted(set(model.unit)))
    shared = " + shared attention" if cfg.family == "hybrid" else ""
    return (f"{cfg.n_layers} layers ({model.repeats} x {len(model.unit)} "
            f"{unit}{shared} + {len(model.tail)} tail)")


def _model_params(torch, model, dtype, dev, seed, tag, mods=None):
    """``model.init`` from a seeded generator on the card, or, given
    ``mods``, :func:`_init_sliced` (a slice at a time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = (model.init(gen, dtype, dev) if mods is None else
              _init_sliced(torch, mods, model, gen, dtype, dev))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {model.cfg.name}: {_describe(model)}, d_model "
        f"{model.cfg.d_model}, {n} parameters, "
        f"{n * params['embed'].element_size() / 1e9:.2f} GB {dtype} on "
        f"{params['embed'].device}, drawn in "
        f"{time.perf_counter() - t0:.2f} s"
        f"{' a slice at a time' if mods is not None else ''}")
    return params


SLICE_BYTES = 1 << 30     # float32 scratch of one sliced draw


def _init_sliced(torch, mods, model, gen, dtype, dev):
    """``model.init``'s tree with every normal leaf drawn in float32 a
    block of rows (its last axis) at a time, SLICE_BYTES at most, then
    cast, so the float32 scratch stays under a gigabyte:
    ``Init.normal`` draws qwen2.5-32b's ``w_gate`` [64, 5120, 27648] whole,
    36.2 GB in float32, and one layer of kimi-k2's [384, 7168, 2048] is
    22.5 GB.  Ones and zeros as ``Init`` makes them."""

    class SlicedInit(mods.Init):
        def normal(self, shape, *, std=0.02):
            out = torch.empty(tuple(shape), dtype=self.dtype,
                              device=self.device)
            rows = out.view(-1, out.shape[-1])
            step = max(1, SLICE_BYTES // (4 * max(1, rows.shape[1])))
            for i in range(0, len(rows), step):
                blk = rows[i:i + step]
                blk.copy_(torch.randn(blk.shape, generator=self.generator,
                                      device=self.device).mul_(std))
            return out

    plain = mods.lm.Init
    mods.lm.Init = SlicedInit
    try:
        return model.init(gen, dtype, dev)
    finally:
        mods.lm.Init = plain


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _wrapper(mods, name):
    ops, attr, _ = FLOAT_KERNELS[name]
    return getattr(getattr(mods, ops), attr)


def _plain(mods, name):
    ops, _, attr = FLOAT_KERNELS[name]
    return getattr(getattr(mods, ops), attr)


def _kernel_counts(mods):
    return {k: _wrapper(mods, k).launches for k in FLOAT_KERNELS}


def _zero_kernel_counts(mods):
    for k in FLOAT_KERNELS:
        _wrapper(mods, k).launches = 0


def expected_launches(model):
    """Float-kernel launches of one prefill: one flash attention per
    attention layer and shared-block call, one SSD per Mamba2 layer, one
    WKV per RWKV6 layer; an encoder-decoder's flash attention once an
    encoder layer and twice a decoder layer (self and cross)."""
    cfg = model.cfg
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                "mamba2_ssd": 0, "rwkv6_wkv": 0}
    kinds = list(model.unit) * model.repeats + list(model.tail)
    shared = model.repeats if model.cfg.family == "hybrid" else 0
    return {"flash_attention": shared + sum(k not in ("mamba", "rwkv")
                                            for k in kinds),
            "mamba2_ssd": kinds.count("mamba"),
            "rwkv6_wkv": kinds.count("rwkv")}


def _prefill_counted(torch, mods, model, params, args, recorders=None):
    """One prefill, ``model.prefill(params, *args)``, with every float
    kernel's count set to 0 just before it and read just after; optionally
    through call recorders."""
    recorders = recorders or {}
    _zero_kernel_counts(mods)
    for name, rec in recorders.items():
        setattr(mods.blocks, FLOAT_KERNELS[name][1], rec)
    try:
        logits = model.prefill(params, *args)
        torch.cuda.synchronize()
    finally:
        for name in recorders:
            setattr(mods.blocks, FLOAT_KERNELS[name][1],
                    _wrapper(mods, name))
    launches = _kernel_counts(mods)
    want = expected_launches(model)
    if launches != want:
        raise AssertionError(f"prefill launched {launches}, expected {want} "
                             f"(one flash attention an attention call, one "
                             f"SSD a Mamba2 layer, one WKV an RWKV6 layer)")
    return logits, launches


def replay_recorded(mods, recs, keep, agree, tag="kernels"):
    """Each call that ``recs[kernel]`` kept, replayed through the kernel's
    plain version on the same inputs (float32 tolerance, relative)."""
    for k, rec in recs.items():
        for i, ins, kw, outs in rec.samples:
            extra = f" window={kw['window']}" if "window" in kw else ""
            agree[k].add(outs[0], _plain(mods, k)(*ins, **kw),
                         FLOAT_TOL["float32"],
                         f"recorded prefill {k} call {i} "
                         f"{tuple(ins[0].shape)}{extra}", relative=True,
                         tag=tag)
        if len(rec.samples) != len(keep[k]):
            raise AssertionError(f"{k}: recorded {len(rec.samples)} calls, "
                                 f"expected {len(keep[k])}")


def phase_model(torch, mods, dev, name, keep, agree, cfg=None):
    """Full-width ``name`` in float32 (``cfg``, a depth cut, if given):
    prefill (the float kernels' main path, through recorders keeping the
    calls ``keep[kernel]``) against its teacher-forced decode, then the
    Paxos-routed engine -> (the prefill's launches, the engine's select
    network launches)."""
    tag = name.split("-")[0]
    cfg = cfg or mods.ARCHS[name]
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, (PROMPT_BATCH, PROMPT_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    recs = {k: Recorder(torch, _wrapper(mods, k), calls)
            for k, calls in keep.items()}
    t0 = time.perf_counter()
    logits, launches = _prefill_counted(torch, mods, model, params,
                                        (tokens,), recs)
    t_prefill = time.perf_counter() - t0
    log(f"[{tag}] main-path launches of one prefill "
        f"({PROMPT_BATCH} x {PROMPT_LEN} tokens, float32): "
        f"{json.dumps(launches)}; {t_prefill:.3f} s with recording")
    if tuple(logits.shape) != (PROMPT_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite [{PROMPT_BATCH}, {cfg.vocab}]")

    # recorded prefill calls replayed through the plain versions
    replay_recorded(mods, recs, keep, agree)
    del recs

    # teacher-forced decode over the same tokens: kernel-free, plain torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = model.init_cache(PROMPT_BATCH, PROMPT_LEN, dtype=torch.float32,
                              device=dev)
    for t in range(PROMPT_LEN):
        dec, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_caches = model.init_cache(PROMPT_BATCH, PROMPT_LEN,
                                   dtype=torch.float32, device=dev)
    rows, step_ms = profile_device(torch, lambda: model.decode_step(
        params, step_caches, tokens[:, :1]))
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    step_dev = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[{tag}] one float32 decode step profiled: wall {step_ms:.2f} ms, "
        f"device busy {step_dev:.2f} ms over "
        f"{sum(r.count for r in dev_rows)} device ops")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:6]:
        log(f"[{tag}]   {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:90]}")
    del step_caches
    scale = float(logits.abs().max())
    err = float((dec - logits).abs().max())
    top_p, top_d = logits.argmax(-1), dec.argmax(-1)
    log(f"[{tag}] prefill vs teacher-forced decode ({PROMPT_LEN} steps, "
        f"{t_decode:.2f} s): max abs logit err {err:.3e}, relative "
        f"{err / scale:.3e} (tolerance 1e-3), top-1 "
        f"{top_p.tolist()} vs {top_d.tolist()}")
    if not (err / scale <= 1e-3 and torch.equal(top_p, top_d)):
        raise AssertionError("prefill and teacher-forced decode disagree")
    del caches, dec

    paxos = phase_engine(torch, mods, dev, tag, model, params, GEN_STEPS)
    del params
    torch.cuda.empty_cache()
    return launches, paxos


def phase_engine(torch, mods, dev, tag, model, params, steps):
    """``DecodeEngine`` routes GEN_SESSIONS sessions through
    ``PaxosRegistry`` over ``BatchedMachine`` (sticky across two engines),
    then generates ``steps`` tokens for each -> the routes' select network
    launches (both must launch)."""
    cfg = model.cfg
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    t0 = time.perf_counter()
    registry = mods.PaxosRegistry(
        n_machines=5, all_aboard=True,
        machine_cls=functools.partial(mods.BatchedMachine, device=dev))
    engines = [mods.DecodeEngine(model, params,
                                 mods.ServeConfig(max_seq=64),
                                 registry, replica_id=r, device=dev)
               for r in range(2)]
    sessions = list(range(101, 101 + GEN_SESSIONS))
    routes = {s: engines[s % 2].route(s) for s in sessions}
    for s in sessions:
        if not engines[0].route(s) == engines[1].route(s) == routes[s]:
            raise AssertionError(f"session {s}: routes are not sticky")
    t_route = time.perf_counter() - t0
    paxos = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
             "paxos_propose": mods.propose_ops.paxos_propose.launches}
    rng = mods.np.random.default_rng(2)
    prompts = [[int(v) for v in rng.integers(1, cfg.vocab,
                                             int(rng.integers(5, 21)))]
               for _ in sessions]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engines[0].generate(prompts, steps=steps)
    t_gen = time.perf_counter() - t0
    if out.shape != (GEN_SESSIONS, steps) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"generate returned {out.shape} tokens outside "
                             f"[0, {cfg.vocab})")
    log(f"[{tag}] routes {routes} sticky across 2 engines "
        f"({t_route:.2f} s, Paxos kernel launches {json.dumps(paxos)}); "
        f"generate {GEN_SESSIONS} sessions (prompts "
        f"{[len(p) for p in prompts]} tokens) x {steps} steps in "
        f"{t_gen:.2f} s; first row {out[0].tolist()}")
    if not all(paxos.values()):
        raise AssertionError(f"{tag}: the engine's routes launched "
                             f"{paxos}; both select networks must launch")
    return paxos


def _kernel_group(key: str) -> str:
    """A profiler row's group: every CUDA kernel of a float kernel's wrapper
    carries ``<name>_kernel`` in its name (``flash_attention_kernel_mma``,
    ``flash_attention_kernel_tf32``, ...), whatever else a design
    launches."""
    for name in FLOAT_KERNELS:
        if f"{name}_kernel" in key:
            return f"{name}_kernel"
    if any(w in key.lower() for w in ("gemm", "xmma", "cutlass", "sm90",
                                      "nvjet")):
        return "matmul (cuBLAS)"
    return "other torch kernels"


def _range_device_ms(rows, label):
    """Device time of the kernels launched inside a ``record_function``
    range: its CPU row's total over its children's kernels, or None.  (The
    range's own device-side row spans its kernels' gaps too.)"""
    hits = [r for r in rows if r.key == label and not _is_device_row(r)]
    if not hits:
        return None
    total = 0.0
    for r in hits:
        for attr in ("device_time_total", "cuda_time_total"):
            if hasattr(r, attr):
                total += float(getattr(r, attr))
                break
    return total / 1e3


def phase_prefill_bf16(torch, mods, dev, name, cfg=None, make_args=None,
                       ranges=(), sliced=False):
    """bfloat16 prefill of ``name`` (``cfg``, a depth cut, if given) at
    1 x PREFILL_SEQ tokens, or on ``make_args(cfg, generator) -> (args,
    description)``: wall time, peak memory, one profiled pass, its float
    kernels' device time per launch, and the device time inside each of
    the model's profiler ``ranges``.  ``sliced`` draws the weights a
    slice at a time (:func:`_init_sliced`)."""
    cfg = cfg or mods.ARCHS[name]
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.bfloat16, dev, 0, "prefill",
                           mods if sliced else None)
    gen = torch.Generator(device=dev).manual_seed(3)
    if make_args is None:
        args = (torch.randint(1, cfg.vocab, (1, PREFILL_SEQ), generator=gen,
                              device=dev, dtype=torch.int32),)
        what = f"1 x {PREFILL_SEQ} tokens"
    else:
        args, what = make_args(cfg, gen)
    torch.cuda.reset_peak_memory_stats()
    logits, launches = _prefill_counted(torch, mods, model, params, args)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} bf16 prefill logits are not finite")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, *args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _zero_kernel_counts(mods)
    rows, prof_ms = profile_device(torch, lambda: model.prefill(params,
                                                                *args))
    # wrapper calls over the profiled pass: a design may launch several
    # CUDA kernels a call, so a call's time is its group's time over these
    prof_calls = _kernel_counts(mods)
    # kernels only: a range's device-side annotation row is not a kernel
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0
                and r.key not in ranges]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[prefill] {name} bf16 {what}: "
        f"{json.dumps(launches)} launches; wall {wall_ms:.2f} ms (median of "
        f"3: {', '.join(f'{w:.2f}' for w in walls)}), profiled wall "
        f"{prof_ms:.2f} ms, device busy {dev_ms:.2f} ms (busy share "
        f"{dev_ms / prof_ms:.4f}), peak memory {peak_gb:.2f} GB")
    groups = {}
    for r in dev_rows:
        g = _kernel_group(r.key)
        t_ms, cnt = groups.get(g, (0.0, 0))
        groups[g] = (t_ms + _device_us(r) / 1e3, cnt + r.count)
    for g, (t_ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[prefill]   {t_ms:10.3f} ms  x{cnt:<6d} {g} "
            f"({t_ms / dev_ms:.3f} of device time)")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:10]:
        log(f"[prefill]     {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:100]}")
    per_launch = {}
    for k in FLOAT_KERNELS:
        t_ms, cnt = groups.get(f"{k}_kernel", (0.0, 0))
        if cnt and cnt < prof_calls[k]:
            # every call launches at least one CUDA kernel: rows were lost
            log(f"[prefill]   {k}: {prof_calls[k]} wrapper calls, the "
                f"profiler saw {cnt} CUDA kernels ({t_ms:.6f} ms): a call's "
                f"time not measured")
        elif cnt and prof_calls[k]:
            per_launch[k] = t_ms / prof_calls[k]
            log(f"[prefill]   {k}: {prof_calls[k]} wrapper calls, {cnt} CUDA "
                f"kernels, {per_launch[k]:.6f} ms a call")
    in_ranges = {}
    for label in ranges:
        in_ranges[label] = _range_device_ms(rows, label)
        shown = ("not measured (no row)" if in_ranges[label] is None else
                 f"{in_ranges[label]:.3f} ms "
                 f"({in_ranges[label] / dev_ms:.3f} of device time)")
        log(f"[prefill]   range {label}: {shown}")
    if ranges and None not in in_ranges.values():
        rest = dev_ms - sum(in_ranges.values()) - sum(
            groups.get(f"{k}_kernel", (0.0, 0))[0] for k in FLOAT_KERNELS)
        if rest < 0:     # the ranges hold more than the kernels outside them
            log(f"[prefill]   the ranges' device time exceeds the rest's by "
                f"{-rest:.3f} ms: the profiler lost or misattributed kernel "
                f"records in this pass, so the split is not measured")
        else:
            log(f"[prefill]   outside the ranges and the float kernels "
                f"(projections, norms, elementwise passes): {rest:.3f} ms "
                f"({rest / dev_ms:.3f} of device time)")
    del params, logits
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=dev_ms, launches=launches,
                per_launch_ms=per_launch, ranges_ms=in_ranges, what=what,
                peak_gb=peak_gb)


# ---------------------------------------------------------------------------
# [mixtral], [qwen2_vl], [whisper]: the rest of the model zoo at full width
# ---------------------------------------------------------------------------

MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 4        # of 32: 6,067,228,672 float32 parameters, 24.3 GB
MIXTRAL_SEQ = 4608        # 512 tokens past the 4096-token window
MIXTRAL_GATE2_TOKENS = 256
MIXTRAL_ROOMY = 8.0       # a capacity factor at which nothing drops
QWEN2_VL = "qwen2-vl-72b"
QWEN2_VL_LAYERS = 2       # of 80: 4,246,794,240 float32 parameters, 17.0 GB
VLM_GRID = 16             # the image's 256 tokens as a 16 x 16 grid
VLM_TEXT = 512
WHISPER = "whisper-large-v3"   # full depth: 32 + 32 layers, 6.3 GB
WHISPER_BATCH, WHISPER_TOKENS = 2, 64
ZOO_GEN_STEPS = 16
MODEL_TOL = 1e-3          # max logit error over max |logit|
MOE_RANGES = ("moe.dispatch", "moe.experts", "moe.combine")


def _cut(mods, name, n_layers):
    return dataclasses.replace(mods.ARCHS[name], n_layers=n_layers)


def _slice(tree, i):
    """Layer ``i`` of a parameter tree stacked over layers."""
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


@contextlib.contextmanager
def plain_kernels(mods, names):
    """Each float kernel in ``names`` through its plain version on the
    card, wherever ``models/blocks.py`` calls it (the reference's
    ``impl="xla"``)."""
    for name in names:
        setattr(mods.blocks, FLOAT_KERNELS[name][1], _plain(mods, name))
    try:
        yield
    finally:
        for name in names:
            setattr(mods.blocks, FLOAT_KERNELS[name][1], _wrapper(mods, name))


class RouteRecorder:
    """Wraps ``blocks.moe_route``: keeps each MoE call's expert ids and
    its dropped-assignment count."""

    def __init__(self, fn):
        self.fn, self.idx, self.dropped = fn, [], []

    def __call__(self, cfg, router, h, *keep):
        r = self.fn(cfg, router, h, *keep)
        self.idx.append(r.idx.clone())
        self.dropped.append(r.dropped())
        return r


@contextlib.contextmanager
def recorded_routes(mods):
    rec = RouteRecorder(mods.blocks.moe_route)
    mods.blocks.moe_route = rec
    try:
        yield rec
    finally:
        mods.blocks.moe_route = rec.fn


def hold_logits(tag, what, got, want, tol=MODEL_TOL):
    """Same top-1 and max |got - want| <= tol max |want|, or raise."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    top_g, top_w = got.argmax(-1), want.argmax(-1)
    log(f"[{tag}] {what}: max abs logit err {err:.3e}, relative "
        f"{err / scale:.3e} (tolerance {tol:g}), top-1 {top_g.tolist()} vs "
        f"{top_w.tolist()}")
    if not (bool(got.isfinite().all()) and err / scale <= tol
            and bool((top_g == top_w).all())):
        raise AssertionError(f"{tag}: {what} disagree")
    return err / scale


def kernel_vs_plain_prefill(torch, mods, tag, model, params, args, what,
                            recorders=None):
    """The prefill through the kernels (the main path: counts from 0,
    through ``recorders`` if given) held to the same prefill with
    ``attention_plain`` on the card."""
    t0 = time.perf_counter()
    logits, launches = _prefill_counted(torch, mods, model, params, args,
                                        recorders)
    t_kernel = time.perf_counter() - t0
    mods.fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    with plain_kernels(mods, ["flash_attention"]):
        plain = model.prefill(params, *args)
        torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if mods.fa_ops.flash_attention.launches:
        raise AssertionError(f"{tag}: the plain prefill launched the kernel")
    log(f"[{tag}] main-path launches of one prefill ({what}, float32): "
        f"{json.dumps(launches)}; {t_kernel:.3f} s through the kernels, "
        f"{t_plain:.3f} s plain")
    hold_logits(tag, "prefill through the kernels vs attention_plain",
                logits, plain)
    return logits, launches


def prefill_vs_decode(torch, tag, model, params, tokens, want, dev,
                      gate=True):
    """The teacher-forced ``decode_step`` loop over ``tokens`` against the
    prefill's last logits ``want`` -> (the decode's logits, relative
    error); a gate unless ``gate`` is False."""
    b, s = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = model.init_cache(b, s, dtype=torch.float32, device=dev)
    for t in range(s):
        dec, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    what = (f"prefill vs teacher-forced decode ({b} x {s}, {secs:.2f} s, "
            f"{secs / s * 1e3:.1f} ms a step)")
    if gate:
        return dec, hold_logits(tag, what, dec, want)
    rel = float((dec - want).abs().max() / want.abs().max())
    log(f"[{tag}] {what}: relative {rel:.3e} (not a gate)")
    return dec, rel


def phase_mixtral(torch, mods, dev):
    """mixtral-8x7b at full width cut to MIXTRAL_LAYERS layers, float32."""
    tag = "mixtral"
    cfg = _cut(mods, MIXTRAL, MIXTRAL_LAYERS)
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(1, cfg.vocab, (1, MIXTRAL_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    # gate 1: past the window's edge, through the kernels vs plain
    with recorded_routes(mods) as kr:
        logits, launches = kernel_vs_plain_prefill(
            torch, mods, tag, model, params, (tokens,),
            f"1 x {MIXTRAL_SEQ} tokens, window {cfg.window}")
    pr = kr.idx[len(kr.idx) // 2:]
    kr_idx = kr.idx[:len(kr.idx) // 2]
    if len(kr_idx) != MIXTRAL_LAYERS or len(pr) != MIXTRAL_LAYERS:
        raise AssertionError(f"{tag}: {len(kr.idx)} routed MoE calls, "
                             f"expected 2 x {MIXTRAL_LAYERS}")
    differ = sum(int((a != b).sum()) for a, b in zip(kr_idx, pr))
    log(f"[{tag}] top-{cfg.top_k} expert choices that differ between the "
        f"kernel and the plain prefill: {differ} of "
        f"{sum(a.numel() for a in kr_idx)}; dropped assignments a layer "
        f"(capacity factor {cfg.capacity_factor}): "
        f"{kr.dropped[:MIXTRAL_LAYERS]}")
    del logits
    # gate 2: at a capacity where nothing drops, prefill == decode
    roomy = mods.build_model(dataclasses.replace(
        cfg, capacity_factor=MIXTRAL_ROOMY))
    short = tokens[:, :MIXTRAL_GATE2_TOKENS]
    with recorded_routes(mods) as r8:
        want, _ = _prefill_counted(torch, mods, roomy, params, (short,))
    with recorded_routes(mods) as r_pub:
        published = model.prefill(params, short)
    if sum(r8.dropped):
        raise AssertionError(f"{tag}: capacity factor {MIXTRAL_ROOMY} "
                             f"dropped {r8.dropped}")
    dec, _ = prefill_vs_decode(torch, tag, roomy, params, short, want, dev)
    rel = float((dec - published).abs().max() / published.abs().max())
    log(f"[{tag}] capacity factor {MIXTRAL_ROOMY}: 0 dropped; the published "
        f"{cfg.capacity_factor} drops {sum(r_pub.dropped)} assignments "
        f"({r_pub.dropped} a layer) over 1 x {MIXTRAL_GATE2_TOKENS} tokens, "
        f"its prefill {rel:.3e} from the decode (not a gate: the capacity "
        f"depends on the token count)")
    del want, published, dec
    phase_engine(torch, mods, dev, tag, model, params, ZOO_GEN_STEPS)
    del params
    torch.cuda.empty_cache()
    return launches


def qwen2_vl_positions(torch, b, n_text, dev, grid=VLM_GRID):
    """Qwen2-VL's M-RoPE streams [3, b, grid^2 + n_text] for one image in
    front of the text: the image's tokens as a grid (temporal 0, height the
    row, width the column), then the text from ``grid`` on, all three
    streams equal."""
    cell = torch.arange(grid * grid, device=dev)
    vis = torch.stack([torch.zeros_like(cell), cell // grid, cell % grid])
    text = (grid + torch.arange(n_text, device=dev)).expand(3, n_text)
    pos = torch.cat([vis, text], dim=1).to(torch.int32)
    return pos[:, None].expand(3, b, pos.shape[1]).contiguous()


def vlm_inputs(torch, mods, cfg, b, n_text, dtype, gen, dev):
    """(tokens, vision_embeds, mrope_positions) as ``input_specs`` shapes
    them; vision embeddings at the token embeddings' scale (std 0.02)."""
    spec = mods.input_specs(cfg, mods.Shape("vlm", n_text, b, "prefill"),
                            dtype)
    tokens = torch.randint(1, cfg.vocab, spec["tokens"][0], generator=gen,
                           device=dev, dtype=spec["tokens"][1])
    vshape, vdtype = spec["vision_embeds"]
    vis = (0.02 * torch.randn(vshape, generator=gen, device=dev)).to(vdtype)
    grid = int(round(vshape[1] ** 0.5))
    pos = qwen2_vl_positions(torch, b, n_text, dev, grid)
    if tuple(pos.shape) != spec["mrope_positions"][0] or \
            torch.equal(pos[0], pos[1]) or torch.equal(pos[1], pos[2]):
        raise AssertionError(f"M-RoPE streams {tuple(pos.shape)} do not "
                             f"differ or do not match input_specs")
    return tokens, vis, pos


def phase_qwen2_vl(torch, mods, dev):
    """qwen2-vl-72b at full width cut to QWEN2_VL_LAYERS layers, float32."""
    tag = "qwen2_vl"
    cfg = _cut(mods, QWEN2_VL, QWEN2_VL_LAYERS)
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(12)
    tokens, vis, pos = vlm_inputs(torch, mods, cfg, 1, VLM_TEXT,
                                  torch.float32, gen, dev)
    _, launches = kernel_vs_plain_prefill(
        torch, mods, tag, model, params, (tokens, vis, pos),
        f"{vis.shape[1]} vision embeddings + {VLM_TEXT} tokens, M-RoPE "
        f"{cfg.mrope_sections}")
    text = torch.randint(1, cfg.vocab, (PROMPT_BATCH, PROMPT_LEN),
                         generator=gen, device=dev, dtype=torch.int32)
    want = model.prefill(params, text)
    prefill_vs_decode(torch, tag, model, params, text, want, dev)
    del params, want
    torch.cuda.empty_cache()
    return launches


def whisper_inputs(torch, mods, cfg, dtype, gen, dev):
    spec = mods.input_specs(cfg, mods.Shape("whisper", WHISPER_TOKENS,
                                            WHISPER_BATCH, "prefill"), dtype)
    frames = torch.randn(spec["frames"][0], generator=gen,
                         device=dev).to(spec["frames"][1])
    tokens = torch.randint(1, cfg.vocab, spec["tokens"][0], generator=gen,
                           device=dev, dtype=spec["tokens"][1])
    return frames, tokens


def phase_whisper(torch, mods, dev):
    """whisper-large-v3 at full width and depth, float32."""
    tag = "whisper"
    cfg = mods.ARCHS[WHISPER]
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(13)
    frames, tokens = whisper_inputs(torch, mods, cfg, torch.float32, gen, dev)
    logits, launches = kernel_vs_plain_prefill(
        torch, mods, tag, model, params, (frames, tokens),
        f"{WHISPER_BATCH} x {cfg.enc_seq} frames, {WHISPER_BATCH} x "
        f"{WHISPER_TOKENS} tokens")
    # gate 2: one decode step, cross caches from _enc_kv, after the
    # teacher-forced decode of the first S - 1 tokens
    enc = model.encode(params, frames)
    caches = model.init_cache(WHISPER_BATCH, WHISPER_TOKENS,
                              dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        k, v = model._enc_kv(cfg, _slice(params["dec"], i), enc)
        caches["cross"]["k"][i] = k
        caches["cross"]["v"][i] = v
    del enc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(WHISPER_TOKENS - 1):
        _, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0

    def step():
        c = {"self": {k: v.clone() for k, v in caches["self"].items()},
             "cross": caches["cross"]}
        out, _ = model.decode_step(params, c, tokens[:, -1:])
        torch.cuda.synchronize()
        return out

    mods.fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    dec = step()
    t_step = time.perf_counter() - t0
    step_launches = mods.fa_ops.flash_attention.launches
    mods.fa_ops.flash_attention.launches = 0
    with plain_kernels(mods, ["flash_attention"]):
        dec_plain = step()
    if mods.fa_ops.flash_attention.launches:
        raise AssertionError(f"{tag}: the plain decode step launched the "
                             f"kernel")
    log(f"[{tag}] decode step {WHISPER_TOKENS} (after {WHISPER_TOKENS - 1} "
        f"teacher-forced steps, {t_dec / (WHISPER_TOKENS - 1) * 1e3:.1f} ms "
        f"a step): flash_attention launches {step_launches} (one a "
        f"cross-attention), {t_step * 1e3:.1f} ms")
    if step_launches != cfg.n_layers:
        raise AssertionError(f"{tag}: a decode step launched "
                             f"{step_launches}, expected {cfg.n_layers}")
    hold_logits(tag, "decode step through the kernels vs attention_plain",
                dec, dec_plain)
    rel = float((dec - logits).abs().max() / logits.abs().max())
    log(f"[{tag}] prefill vs teacher-forced decode: relative {rel:.3e}, "
        f"top-1 {logits.argmax(-1).tolist()} vs {dec.argmax(-1).tolist()} "
        f"(not a gate: the reference's decode rotates q and k by RoPE and "
        f"its prefill does not, ROADMAP Queue 3)")
    del caches, dec, dec_plain, logits
    phase_engine(torch, mods, dev, tag, model, params, ZOO_GEN_STEPS)
    del params
    torch.cuda.empty_cache()
    return launches, step_launches


def phase_zoo(torch, mods, dev):
    """[mixtral], [qwen2_vl] and [whisper], each with its bf16 prefill;
    one full-width model resident at a time."""
    out = {}
    t0 = time.perf_counter()
    out["mixtral"] = phase_mixtral(torch, mods, dev)
    out["mixtral_prefill"] = phase_prefill_bf16(
        torch, mods, dev, MIXTRAL, cfg=_cut(mods, MIXTRAL, MIXTRAL_LAYERS),
        make_args=lambda cfg, gen: ((torch.randint(
            1, cfg.vocab, (1, MIXTRAL_SEQ), generator=gen, device=dev,
            dtype=torch.int32),), f"1 x {MIXTRAL_SEQ} tokens, "
            f"{MIXTRAL_LAYERS} layers"),
        ranges=MOE_RANGES)
    log(f"[mixtral] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["qwen2_vl"] = phase_qwen2_vl(torch, mods, dev)

    def vlm_args(cfg, gen):
        args = vlm_inputs(torch, mods, cfg, 1, VLM_TEXT, torch.bfloat16,
                          gen, dev)
        return args, (f"{args[1].shape[1]} vision embeddings + {VLM_TEXT} "
                      f"tokens, {QWEN2_VL_LAYERS} layers")

    out["qwen2_vl_prefill"] = phase_prefill_bf16(
        torch, mods, dev, QWEN2_VL, cfg=_cut(mods, QWEN2_VL, QWEN2_VL_LAYERS),
        make_args=vlm_args)
    log(f"[qwen2_vl] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["whisper"], out["whisper_decode"] = phase_whisper(torch, mods, dev)

    def whisper_args(cfg, gen):
        args = whisper_inputs(torch, mods, cfg, torch.bfloat16, gen, dev)
        return args, (f"{WHISPER_BATCH} x {cfg.enc_seq} frames + "
                      f"{WHISPER_BATCH} x {WHISPER_TOKENS} tokens")

    out["whisper_prefill"] = phase_prefill_bf16(
        torch, mods, dev, WHISPER, make_args=whisper_args)
    log(f"[whisper] phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [dense]: the dense family whole on the card
# ---------------------------------------------------------------------------

GEMMA3 = "gemma3-12b"     # 48 layers = 8 x (5 local + 1 global), 51.1 GB
GEMMA3_SEQ = 2048         # gate 1: two 1024-token windows
GEMMA3_RING_SEQ = 1152    # gate 2: each 1024-slot ring wraps 128 times
PHI3 = "phi3-mini-3.8b"   # head dim 96
QWEN15 = "qwen1.5-4b"     # MHA 20/20 with qkv bias
QWEN25 = "qwen2.5-32b"    # GQA 40/8
QWEN25_F32_LAYERS = 16    # of 64: 9,358,824,448 float32 parameters, 37.4 GB
# room a bf16 prefill of 1 x PREFILL_SEQ needs beside its weights (qwen2.5:
# three [4096, 27648] MLP activations are 0.68 GB)
BF16_HEADROOM = 4e9


class CallTally:
    """Wraps ``flash_attention``: counts its calls by (q shape, k shape,
    window)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, collections.Counter()

    def __call__(self, q, k, v, **kw):
        self.calls[(tuple(q.shape), tuple(k.shape), kw.get("window"))] += 1
        return self.fn(q, k, v, **kw)


@contextlib.contextmanager
def mlp_range(mods):
    """Each layer's MLP block (its norm, three products and gated
    activation) inside the profiler range "mlp"."""
    from torch.profiler import record_function

    inner = mods.lm.apply_mlp

    def ranged(*args, **kw):
        with record_function("mlp"):
            return inner(*args, **kw)

    mods.lm.apply_mlp = ranged
    try:
        yield
    finally:
        mods.lm.apply_mlp = inner


def _head(tree, n):
    """The first ``n`` layers of a parameter tree stacked over layers, as
    views."""
    if isinstance(tree, dict):
        return {k: _head(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_gemma3(torch, mods, dev, agree):
    """gemma3-12b at full width and depth, float32: gate 1 (kernels against
    plain past two windows), gate 2 (one unit's rings wrapped, prefill
    against the teacher-forced decode), the engine -> (launches of each
    prefill, the engine's select network launches)."""
    tag = "gemma3"
    cfg = mods.ARCHS[GEMMA3]
    model = mods.build_model(cfg)
    n_unit = len(model.unit)
    if model.unit != ["local"] * cfg.local_ratio + ["global"] or model.tail:
        raise AssertionError(f"{tag}: layers {model.unit} x {model.repeats} "
                             f"+ {model.tail}")
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(14)
    tokens = torch.randint(1, cfg.vocab, (1, GEMMA3_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    # gate 1: the first unit's local and global calls and the last unit's
    keep = {"flash_attention": (0, n_unit - 1, cfg.n_layers - n_unit,
                                cfg.n_layers - 1)}
    tally = CallTally(mods.fa_ops.flash_attention)
    recs = {"flash_attention": Recorder(torch, tally,
                                        keep["flash_attention"])}
    logits, launches = kernel_vs_plain_prefill(
        torch, mods, tag, model, params, (tokens,),
        f"1 x {GEMMA3_SEQ} tokens, window {cfg.window}", recorders=recs)
    q = (1, cfg.n_heads, GEMMA3_SEQ, cfg.hd)
    kv = (1, cfg.n_kv_heads, GEMMA3_SEQ, cfg.hd)
    n_local = model.repeats * cfg.local_ratio
    want = {(q, kv, cfg.window): n_local, (q, kv, None): model.repeats}
    log(f"[{tag}] flash_attention calls by (q, k, window): "
        f"{[(k, n) for k, n in tally.calls.items()]}")
    if dict(tally.calls) != want:
        raise AssertionError(f"{tag}: calls {dict(tally.calls)}, expected "
                             f"{want}")
    replay_recorded(mods, recs, keep, agree, tag=tag)
    del recs, tally, logits

    # gate 2: one unit of the same weights, rings wrapped
    unit_model = mods.build_model(_cut(mods, GEMMA3, n_unit))
    unit_params = dict(params, units=tuple(_head(u, 1)
                                           for u in params["units"]))
    specs = unit_model.cache_specs(1, GEMMA3_RING_SEQ, torch.float32)
    smax = [u["k"][0][3] for u in specs["units"]]
    if smax != [cfg.window] * cfg.local_ratio + [GEMMA3_RING_SEQ]:
        raise AssertionError(f"{tag}: cache slots {smax}")
    short = tokens[:, :GEMMA3_RING_SEQ]
    t0 = time.perf_counter()
    unit_logits, unit_launches = _prefill_counted(torch, mods, unit_model,
                                                  unit_params, (short,))
    log(f"[{tag}] one unit ({n_unit} layers, "
        f"{sum(t.numel() for t in _leaves(unit_params))} parameters, the "
        f"first repeat's weights): prefill of 1 x {GEMMA3_RING_SEQ} tokens "
        f"{json.dumps(unit_launches)} in {time.perf_counter() - t0:.3f} s; "
        f"cache slots {smax}: each local ring wraps "
        f"{GEMMA3_RING_SEQ - cfg.window} tokens past its window")
    prefill_vs_decode(torch, tag, unit_model, unit_params, short,
                      unit_logits, dev)
    del unit_params, unit_logits

    paxos = phase_engine(torch, mods, dev, tag, model, params, GEN_STEPS)
    del params
    torch.cuda.empty_cache()
    return ({"gemma3_prefill": launches["flash_attention"],
             "gemma3_unit_prefill": unit_launches["flash_attention"]},
            paxos)


def _fits_bf16(torch, mods, name, tag):
    """``name``'s config at full depth, or cut to the layers whose bf16
    weights fit the card's free memory with BF16_HEADROOM beside them
    (the cut and the bytes that forced it printed)."""
    cfg = mods.ARCHS[name]
    shapes = mods.build_model(cfg).param_shapes(torch.bfloat16)
    total = sum(t.numel() * 2 for t in _leaves(shapes))
    layer = sum(t[0].numel() * 2 for u in shapes["units"]
                for t in _leaves(u))
    free = torch.cuda.mem_get_info()[0]
    if total + BF16_HEADROOM <= free:
        log(f"[{tag}] {name} bf16 at full depth: {total / 1e9:.2f} GB of "
            f"weights, {free / 1e9:.2f} GB free")
        return cfg
    n = int((free - BF16_HEADROOM - (total - cfg.n_layers * layer)) // layer)
    if n < 1:
        raise AssertionError(f"{tag}: not one layer of {name} fits "
                             f"{free / 1e9:.2f} GB free")
    log(f"[{tag}] {name} bf16 cut to {n} of {cfg.n_layers} layers: "
        f"{total / 1e9:.2f} GB of weights at full depth, "
        f"{free / 1e9:.2f} GB free, {BF16_HEADROOM / 1e9:.1f} GB kept for "
        f"the prefill")
    return dataclasses.replace(cfg, n_layers=n)


def band_mask(torch, sq, sk, causal, window, dev):
    """The visible (query, key) pairs as a boolean [sq, sk] mask (True =
    attend), queries aligned to the end of the keys, as the kernel
    aligns them."""
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=dev)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def fa_times(torch, mods, dev, cases, tag, seed, dtype=None):
    """``flash_attention`` in ``dtype`` (bf16 unless given) at each of
    ``cases`` (FA_CASES rows; CUDA events, median of 10) beside its bound
    (``fa_visible_pairs`` at 989 TFLOP/s in bf16 on the tensor cores, at
    495/3 TFLOP/s in float32 as 3xTF32 on the tensor cores, against the
    bytes of q, k, v and the output at 3.35 TB/s; in float32 also the
    operations at the CUDA cores' 67 TFLOP/s, ``bound_cuda_core_ms``) and
    one ``scaled_dot_product_attention`` call on the same inputs (in
    float32 with TF32 off, as ``main`` sets it): with ``is_causal`` where a
    causal mask without a window aligns the same, else with the boolean
    band mask (``band_mask``), held to the kernel's output within the
    dtype's tolerance so that it computes the same function."""
    F = torch.nn.functional
    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    f32 = dtype == torch.float32
    flops_per_s = F32_3XTF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
    if f32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 attention timed with TF32 on")
    out = {}
    for i, case in enumerate(cases):
        label, b, hq, hkv, sq, sk, d, causal, window = case
        (q, k, v), kw = fa_inputs(torch, case, dtype, seed + i, dev)
        ms = cuda_ms(torch, lambda: mods.fa_ops.flash_attention(q, k, v,
                                                                **kw), 10)
        if causal and window is None and sq == sk:
            lib_kw, how = dict(is_causal=True), "is_causal"
        elif causal or window is not None:
            lib_kw = dict(attn_mask=band_mask(torch, sq, sk, causal, window,
                                              dev))
            how = "a boolean band mask"
        else:
            lib_kw, how = {}, "no mask"
        lib = lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=hq != hkv, **lib_kw)
        FloatAgreement().add(lib(), mods.fa_ops.flash_attention(q, k, v,
                                                                **kw),
                             FLOAT_TOL[dname],
                             f"scaled_dot_product_attention ({how}) "
                             f"against the kernel, {label} {dname}", tag=tag)
        lib_ms = cuda_ms(torch, lib, 10)
        flops = 4 * d * fa_visible_pairs(sq, sk, causal, window) * b * hq
        nbytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * q.element_size()
        t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        out[label] = dict(ms=ms, bound_ms=bound, library_ms=lib_ms,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        extra = ""
        if f32:
            cc = max(flops / F32_CUDA_CORE_FLOPS_PER_S, t_bytes) * 1e3
            out[label]["bound_cuda_core_ms"] = cc
            extra = (f"; at the CUDA cores' 67 TFLOP/s {cc:.6f} ms "
                     f"({ms / cc:.2f}x)")
        log(f"[{tag}] flash_attention {dname} {label} ({b}, {hq}/{hkv}, "
            f"Sq {sq}, Sk {sk}, {d}) causal={causal} window {window}: "
            f"{ms:.6f} ms a call (cuda events), bound {bound:.6f} ms "
            f"({out[label]['bound_by']}{' at 3xTF32' if f32 else ''}: "
            f"{flops} flop, {nbytes} B), {ms / bound:.2f}x the bound"
            f"{extra}; SDPA ({how}) {lib_ms:.6f} ms, the kernel "
            f"{ms / lib_ms:.2f}x SDPA")
        del q, k, v, lib_kw
    torch.cuda.empty_cache()
    return out


def dense_kernel_times(torch, mods, dev):
    """``flash_attention`` in bf16 at the dense models' 1 x PREFILL_SEQ
    prefill shapes: gemma3's local and global layers apart, which its
    prefill's profile cannot tell apart."""
    s = PREFILL_SEQ
    cases = [("gemma3-12b local", 16, 8, 256, 1024),
             ("gemma3-12b global", 16, 8, 256, None),
             ("phi3-mini-3.8b", 32, 32, 96, None),
             ("qwen1.5-4b", 20, 20, 128, None),
             ("qwen2.5-32b", 40, 8, 128, None)]
    return fa_times(torch, mods, dev, [
        (label, 1, hq, hkv, s, s, d, True, window)
        for label, hq, hkv, d, window in cases], "dense", 70)


# the zoo's attention shapes, bf16: (label, B, Hq, Hkv, Sq, Sk, D, causal,
# window) as FA_CASES
ZOO_FA_SHAPES = [
    ("qwen2-vl-72b", 1, 64, 8, 768, 768, 128, True, None),
    ("whisper encoder", 2, 20, 20, 1500, 1500, 64, False, None),
    ("whisper decoder self", 2, 20, 20, 64, 64, 64, True, None),
    ("whisper cross", 2, 20, 20, 64, 1500, 64, False, None),
    ("whisper cross, decode", 2, 20, 20, 1, 1500, 64, False, None),
    ("mixtral-8x7b window 4096", 1, 32, 8, 4608, 4608, 128, True, 4096),
    ("kimi-k2-1t-a32b", 1, 64, 8, 4096, 4096, 112, True, None),
]


def phase_dense(torch, mods, dev, agree):
    """[dense]: gemma3-12b, phi3-mini-3.8b, qwen1.5-4b and qwen2.5-32b at
    full width, each through the zoo's gates in float32, then its bf16
    prefill at 1 x PREFILL_SEQ; one model resident at a time."""
    t_phase = time.perf_counter()
    launches, engines, bf16 = {}, {}, {}

    def prefill_bf16(name, cfg=None, sliced=False):
        with mlp_range(mods):
            r = phase_prefill_bf16(torch, mods, dev, name, cfg=cfg,
                                   ranges=("mlp",), sliced=sliced)
        if r["device_ms"] <= 0:
            raise AssertionError(f"{name}: no device time in its prefill")
        bf16[name] = r

    t0 = time.perf_counter()
    gemma, engines[GEMMA3] = phase_gemma3(torch, mods, dev, agree)
    launches.update(gemma)
    prefill_bf16(GEMMA3)
    log(f"[gemma3] phase {time.perf_counter() - t0:.1f} s")
    for name, cfg in ((PHI3, None), (QWEN15, None),
                      (QWEN25, _cut(mods, QWEN25, QWEN25_F32_LAYERS))):
        tag = name.split("-")[0]
        t0 = time.perf_counter()
        n = (cfg or mods.ARCHS[name]).n_layers
        got, engines[name] = phase_model(
            torch, mods, dev, name, {"flash_attention": (0, n // 2, n - 1)},
            agree, cfg=cfg)
        launches[f"{tag}_prefill"] = got["flash_attention"]
        if name == QWEN25:   # 65.5 GB of bf16 weights at full depth
            prefill_bf16(name, cfg=_fits_bf16(torch, mods, name, tag),
                         sliced=True)
        else:
            prefill_bf16(name)
        log(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    times = dense_kernel_times(torch, mods, dev)
    log(f"[dense] flash_attention launches {json.dumps(launches)}; engines' "
        f"select network launches {json.dumps(engines)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, engines=engines, bf16=bf16, times=times)


# ---------------------------------------------------------------------------
# [parallel]: the parallel layer over a one-rank NCCL group
# ---------------------------------------------------------------------------

PARALLEL_SEQ = 1024       # mixtral's f32 prefill, shard_map against spmd
KIMI = "kimi-k2-1t-a32b"  # one MoE block at full width, bf16 (33.8 GB)
KIMI_TOKENS = 512
PARALLEL_TOL = 1e-5       # mixtral: max logit error over max |logit|


def _moe_block_bf16(torch, cfg, gen, dev):
    """One MoE block's parameters in bf16 on the card, drawn an expert at a
    time (normal std 0.02 in float32, then cast), so the peak stays the
    block's own bytes: a whole [E, d, f] draw in float32 would be 22.5 GB
    at kimi-k2's width."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)

    p = {"router": normal(d, e),
         "norm": {"scale": torch.ones(d, dtype=torch.bfloat16, device=dev)}}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        w = torch.empty((e,) + shape, dtype=torch.bfloat16, device=dev)
        for i in range(e):
            w[i] = normal(*shape)
        p[name] = w
    return p


def phase_parallel(torch, mods, dev):
    """[parallel]: the one-card dry run's roofline table; then, in a
    one-rank NCCL group, mixtral-8x7b's f32 prefill through the shard_map
    MoE (TP) against spmd, and kimi-k2's bf16 MoE block (EP, 384 experts)
    both ways.  Returns the mixtral shard_map prefill's launch counts."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tag = "parallel"
    t0 = time.perf_counter()
    recs = [r for r in mods.dryrun.run_all("1xH100") if "skipped" not in r]
    rows = [mods.roofline.terms(r, mods.ARCHS[r["arch"]]) for r in recs]
    if len(rows) != 34:
        raise AssertionError(f"{tag}: {len(rows)} dry-run cells, not 34")
    log(f"[{tag}] one-card dry run of the {len(rows)} ARCHS x SHAPES cells "
        f"({time.perf_counter() - t0:.2f} s; terms at the H100 datasheet's "
        f"989 TFLOP/s bf16 and 3.35 TB/s, no collectives on one card):")
    for line in mods.roofline.fmt_table(rows).splitlines():
        log(f"[{tag}] {line}")
    blocks = mods.blocks
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            log(f"[{tag}] NCCL group of 1, mesh {mesh}")
            launches = _parallel_mixtral(torch, mods, dev, mesh, tag)
            _parallel_kimi(torch, mods, dev, mesh, tag)
        finally:
            dist.destroy_process_group()
    log(f"[{tag}] moe.all_reduce {blocks.apply_moe_shardmap.all_reduces} "
        f"in all; phase {time.perf_counter() - t0:.1f} s")
    return launches


def _parallel_mixtral(torch, mods, dev, mesh, tag):
    cfg = _cut(mods, MIXTRAL, MIXTRAL_LAYERS)
    if (cfg.moe_impl, cfg.moe_strategy) != ("shardmap", "tp"):
        raise AssertionError(f"{tag}: {MIXTRAL} publishes "
                             f"{cfg.moe_impl}/{cfg.moe_strategy}")
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(1, cfg.vocab, (1, PARALLEL_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    fa = mods.fa_ops.flash_attention
    blocks = mods.blocks
    # the main path: every count set to 0 just before, read just after
    fa.launches = 0
    blocks.apply_moe_shardmap.all_reduces = 0
    with recorded_routes(mods) as r_sm, mods.use_mesh(mesh):
        t1 = time.perf_counter()
        sm = model.prefill(params, tokens)
        torch.cuda.synchronize()
        t_sm = time.perf_counter() - t1
    launches = {"flash_attention": fa.launches,
                "moe.all_reduce": blocks.apply_moe_shardmap.all_reduces}
    fa.launches = 0
    with recorded_routes(mods) as r_spmd:
        t1 = time.perf_counter()
        spmd = model.prefill(params, tokens)
        torch.cuda.synchronize()
        t_spmd = time.perf_counter() - t1
    spmd_launches = {"flash_attention": fa.launches,
                     "moe.all_reduce": blocks.apply_moe_shardmap.all_reduces
                     - launches["moe.all_reduce"]}
    with mods.use_mesh(mesh):
        t1 = time.perf_counter()
        model.prefill(params, tokens)
        torch.cuda.synchronize()
        t_sm2 = time.perf_counter() - t1
    log(f"[{tag}] {MIXTRAL} (tp, capacity factor {cfg.capacity_factor}), "
        f"1 x {PARALLEL_SEQ} tokens, float32: shard_map {t_sm:.3f} s (its "
        f"first all-reduce sets up the NCCL communicator; {t_sm2:.3f} s "
        f"again) {json.dumps(launches)}; spmd {t_spmd:.3f} s "
        f"{json.dumps(spmd_launches)}")
    want = {"flash_attention": MIXTRAL_LAYERS,
            "moe.all_reduce": MIXTRAL_LAYERS}
    if launches != want or spmd_launches != dict(want, **{
            "moe.all_reduce": 0}):
        raise AssertionError(f"{tag}: launches {launches} / "
                             f"{spmd_launches}, expected {want} / no "
                             f"all-reduce")
    _same_routes(tag, MIXTRAL, r_sm, r_spmd, MIXTRAL_LAYERS)
    hold_logits(tag, "shard_map prefill vs spmd", sm, spmd,
                tol=PARALLEL_TOL)
    del params, sm, spmd
    torch.cuda.empty_cache()
    return launches


def _same_routes(tag, name, a, b, calls):
    if len(a.idx) != calls or len(b.idx) != calls:
        raise AssertionError(f"{tag}: {len(a.idx)} / {len(b.idx)} routed "
                             f"MoE calls, expected {calls}")
    differ = sum(int((x != y).sum()) for x, y in zip(a.idx, b.idx))
    log(f"[{tag}] {name}: expert choices that differ between shard_map and "
        f"spmd: {differ} of {sum(x.numel() for x in a.idx)}; dropped "
        f"assignments a call {a.dropped} / {b.dropped}")
    if differ or a.dropped != b.dropped:
        raise AssertionError(f"{tag}: {name}'s routes differ")


def _parallel_kimi(torch, mods, dev, mesh, tag):
    cfg = mods.ARCHS[KIMI]
    if (cfg.moe_impl, cfg.moe_strategy) != ("shardmap", "ep"):
        raise AssertionError(f"{tag}: {KIMI} publishes "
                             f"{cfg.moe_impl}/{cfg.moe_strategy}")
    blocks = mods.blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(17)
    p = _moe_block_bf16(torch, cfg, gen, dev)
    x = torch.randn((1, KIMI_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(p))
    log(f"[{tag}] {KIMI} MoE block: d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} x {cfg.expert_d_ff}, {n} "
        f"parameters, {n * 2 / 1e9:.2f} GB bf16, drawn in "
        f"{time.perf_counter() - t1:.2f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    before = blocks.apply_moe_shardmap.all_reduces
    # the combine adds a token's 8 terms in a fixed order
    # (blocks.combine_in_order), so both paths, and one path run twice,
    # give the same bits in PyTorch's default (non-deterministic) mode
    with recorded_routes(mods) as r_sm, mods.use_mesh(mesh):
        y_sm, aux_sm = blocks.apply_moe(cfg, p, x)
    with recorded_routes(mods) as r_spmd:
        y_spmd, aux_spmd = blocks.apply_moe_spmd(cfg, p, x)
    y_again, _ = blocks.apply_moe_spmd(cfg, p, x)
    torch.cuda.synchronize()
    if blocks.apply_moe_shardmap.all_reduces - before != 1:
        raise AssertionError(f"{tag}: {KIMI}'s block ran no all-reduce")
    _same_routes(tag, KIMI, r_sm, r_spmd, 1)
    scale = float(y_spmd.float().abs().max())
    err = float((y_sm.float() - y_spmd.float()).abs().max())
    again = float((y_again.float() - y_spmd.float()).abs().max())
    log(f"[{tag}] {KIMI} 1 x {KIMI_TOKENS} tokens, bf16, deterministic "
        f"mode {torch.are_deterministic_algorithms_enabled()}: shard_map "
        f"against spmd max |dy| {err:.3e}, relative {err / scale:.3e}; spmd "
        f"against itself run again {again:.3e} (both must be 0); aux "
        f"{float(aux_sm):.6f} / {float(aux_spmd):.6f}")
    if not (bool(y_sm.isfinite().all()) and err == 0 and again == 0):
        raise AssertionError(f"{tag}: {KIMI}'s block does not give equal "
                             f"bits")

    def sm():
        with mods.use_mesh(mesh):
            blocks.apply_moe(cfg, p, x)

    ms_sm = cuda_ms(torch, sm, reps=5)
    ms_spmd = cuda_ms(torch, lambda: blocks.apply_moe_spmd(cfg, p, x),
                      reps=5)
    ms_sm2 = cuda_ms(torch, sm, reps=5)
    log(f"[{tag}] {KIMI} block device ms (CUDA events, median of 5, in "
        f"turns): shard_map {ms_sm:.3f} / {ms_sm2:.3f}, spmd "
        f"{ms_spmd:.3f}; weights {n * 2 / 1e9:.2f} GB at 3.35 TB/s = "
        f"{n * 2 / 3.35e12 * 1e3:.3f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rows, _ = profile_device(torch,
                             lambda: blocks.apply_moe_spmd(cfg, p, x))
    split = ", ".join(
        f"{r} " + ("not measured" if v is None else f"{v:.3f}")
        for r, v in ((r, _range_device_ms(rows, r)) for r in MOE_RANGES))
    log(f"[{tag}] {KIMI} spmd block, device ms by profiler range: {split}")
    del p, x, y_sm, y_spmd, y_again
    torch.cuda.empty_cache()


def fa_visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves visible, per (batch, head)."""
    import numpy as np
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def ssd_work(case, elem):
    """(flop, bytes) of one SSD call at SSD_CASES row ``case`` with
    ``elem``-byte x, dt, B, C and output (A in float32)."""
    _, b, t, h, p, g, n = case
    # per (b, t, h): decay * S + B (dt x) and C^T S over N x P, dt x
    return ((5 * n * p + p) * b * t * h,
            (2 * b * t * h * p + b * t * h + 2 * b * t * g * n) * elem
            + 4 * h)


def wkv_work(case, elem):
    """(flop, bytes) of one WKV call at WKV_CASES row ``case`` with
    ``elem``-byte r, k, v, w and output (u in float32)."""
    _, b, h, t, dk, dv, _ = case
    # per (b, h, t): k v^T, u (k v^T), S + that, times r, the sum over K,
    # then w S + k v^T: 7 K V
    return (7 * dk * dv * b * h * t,
            (3 * b * h * t * dk + 2 * b * h * t * dv) * elem + 4 * h * dk)


def phase_model_timings(torch, mods, dev, prefill_per_launch):
    """Each float kernel at its model's prefill shape in bf16 (CUDA
    events, median after warm-up), its bound, its plain version and the
    library call.  The kernel's time is the profiler's device time per
    launch in the bf16 prefill (``prefill_per_launch``, same shapes, the
    model's own inputs) where the profiler saw it, else the event time."""
    F = torch.nn.functional
    out = {}
    case = FA_CASES[0]
    (q, k, v), kw = fa_inputs(torch, case, torch.bfloat16, 7, dev)
    _, b, hq, hkv, sq, sk, d, causal, window = case
    call = lambda: mods.fa_ops.flash_attention(q, k, v, **kw)
    pairs = fa_visible_pairs(sq, sk, causal, window)
    out["flash_attention"] = dict(
        shape=f"(B, Hq, S, D) = ({b}, {hq}, {sq}, {d}) causal bf16",
        event_ms=cuda_ms(torch, call, 10),
        device_ms=prefill_per_launch.get("flash_attention"),
        plain_ms=cuda_ms(torch, lambda: mods.fa_ops.attention_plain(
            q, k, v, **kw), 3, warmup=1),
        # a yardstick only: the port never calls it
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10),
        flops=4 * d * pairs * b * hq,
        bytes=(2 * b * hq * sq + 2 * b * hkv * sk) * d * 2)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(torch, lambda: mods.fa_ops.flash_attention(
        qf, kf, vf, **kw), 5)
    log(f"[time] flash_attention float32 at the same shape: {f32_ms:.4f} ms "
        f"a wrapper call (cuda events)")
    del q, k, v, qf, kf, vf

    case = SSD_CASES[0]
    x, dt, A, Bm, Cm = ssd_inputs(torch, case, torch.bfloat16, 8, dev)
    call = lambda: mods.ssd_ops.ssd(x, dt, A, Bm, Cm)
    flops, nbytes = ssd_work(case, 2)
    out["mamba2_ssd"] = dict(
        shape=f"(B, T, H, P, G, N) = {tuple(case[1:])} bf16",
        event_ms=cuda_ms(torch, call, 20),
        device_ms=prefill_per_launch.get("mamba2_ssd"),
        plain_ms=cuda_ms(torch, lambda: mods.ssd_ops.ssd_plain(
            x, dt, A, Bm, Cm), 2, warmup=1),
        library_ms=None, flops=flops, bytes=nbytes)
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, Bm, Cm))
    f32_ms = cuda_ms(torch, lambda: mods.ssd_ops.ssd(xf, dtf, A, Bf, Cf), 10)
    log(f"[time] mamba2_ssd float32 at the same shape: {f32_ms:.4f} ms a "
        f"wrapper call (cuda events)")
    del x, dt, A, Bm, Cm, xf, dtf, Bf, Cf

    case = WKV_CASES[0]
    r, kk, vv, w, u = wkv_inputs(torch, case, torch.bfloat16, 9, dev)
    call = lambda: mods.wkv_ops.wkv6(r, kk, vv, w, u)
    flops, nbytes = wkv_work(case, 2)
    out["rwkv6_wkv"] = dict(
        shape=f"(B, H, T, K, V) = {tuple(case[1:6])} bf16",
        event_ms=cuda_ms(torch, call, 20),
        device_ms=prefill_per_launch.get("rwkv6_wkv"),
        plain_ms=cuda_ms(torch, lambda: mods.wkv_ops.wkv6_plain(
            r, kk, vv, w, u), 2, warmup=1),
        # no single PyTorch call computes the recurrence
        library_ms=None, flops=flops, bytes=nbytes)
    f32 = [a.float() for a in (r, kk, vv, w)]
    f32_ms = cuda_ms(torch, lambda: mods.wkv_ops.wkv6(*f32, u), 10)
    f32_flops, f32_bytes = wkv_work(case, 4)
    log(f"[time] rwkv6_wkv float32 (3xTF32) at the same shape: "
        f"{f32_ms:.4f} ms a wrapper call (cuda events); bound: operations "
        f"at 3xTF32's 495/3 TFLOP/s "
        f"{f32_flops / F32_3XTF32_FLOPS_PER_S * 1e3:.4f} ms, bytes "
        f"{f32_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del r, kk, vv, w, u, f32

    for name, r in out.items():
        r["ms"] = r["device_ms"] if r["device_ms"] is not None \
            else r["event_ms"]
        r["ms_source"] = ("profiler, bf16 prefill"
                          if r["device_ms"] is not None else "cuda events")
        t_ops = r["flops"] / BF16_FLOPS_PER_S
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.6f} ms")
        log(f"[time] {name} {r['shape']}: kernel {r['ms']:.6f} ms "
            f"({r['ms_source']}; {r['event_ms']:.6f} ms a wrapper call by "
            f"cuda events), bound {r['bound_ms']:.6f} ms ({r['bound_by']}: "
            f"{r['flops']} flop, {r['bytes']} B; "
            f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
            f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s achieved, "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound), plain "
            f"{r['plain_ms']:.6f} ms, library {lib}")
    return out

# float32, the type of training and of every mesh phase (every float
# kernel's 3xTF32 path on the tensor cores), at the shapes those paths
# give the kernels: attention (label, B, Hq, Hkv, Sq, Sk, D, causal,
# window) as FA_CASES, the SSD as SSD_CASES (zamba2-7b's train step, its
# float32 prefill in [zamba2], and a rank's head block in [train_mesh]'s
# and [decode_mesh]'s "hybrid" cases), the WKV as WKV_CASES (rwkv6-7b's
# train step, its float32 prefill in [rwkv6], and a rank's block in
# [train_mesh]'s and [decode_mesh]'s "ssm" cases)
F32_FA_SHAPES = [
    ("zamba2-7b train", 2, 32, 32, 1024, 1024, 112, True, None),
    ("qwen1.5-4b train", 2, 20, 20, 1024, 1024, 128, True, None),
    ("whisper encoder", 2, 20, 20, 1500, 1500, 64, False, None),
    ("whisper cross, decode", 2, 20, 20, 1, 1500, 64, False, None),
]
F32_SSD_SHAPES = [
    ("zamba2-7b train", 2, 1024, 112, 64, 1, 64),
    ("zamba2-7b prefill", PROMPT_BATCH, PROMPT_LEN, 112, 64, 1, 64),
    ("train_mesh hybrid rank", 1, 1024, 56, 64, 1, 64),
    ("decode_mesh hybrid rank", 1, 40, 56, 64, 1, 64),
]
F32_WKV_SHAPES = [
    ("rwkv6-7b train", 2, 64, 1024, 64, 64, "moderate"),
    ("rwkv6-7b prefill", PROMPT_BATCH, 64, PROMPT_LEN, 64, 64, "moderate"),
    ("train_mesh ssm rank", 1, 32, 1024, 64, 64, "moderate"),
    ("decode_mesh ssm rank", 2, 32, 16, 64, 64, "moderate"),
]


def phase_float32_times(torch, mods, dev):
    """The float kernels in float32 in one process (CUDA events): each
    F32_FA_SHAPES row by ``fa_times`` beside its two bounds (3xTF32 and
    the CUDA cores) and SDPA; each F32_SSD_SHAPES row beside its bound
    (bytes at 3.35 TB/s against operations at 3xTF32's 495/3 TFLOP/s), the
    CUDA cores' bound (67 TFLOP/s) and its plain version; each
    F32_WKV_SHAPES row likewise."""
    tag = "time_f32"
    out = {"flash_attention": fa_times(torch, mods, dev, F32_FA_SHAPES, tag,
                                       95, dtype=torch.float32)}
    rows = [("mamba2_ssd", case, ssd_inputs, ssd_work, 96 + i)
            for i, case in enumerate(F32_SSD_SHAPES)]
    rows += [("rwkv6_wkv", case, wkv_inputs, wkv_work, 196 + i)
             for i, case in enumerate(F32_WKV_SHAPES)]
    flops_per_s = F32_3XTF32_FLOPS_PER_S
    for name, case, make, work, seed in rows:
        args = make(torch, case, torch.float32, seed, dev)
        kernel, plain = _wrapper(mods, name), _plain(mods, name)
        FloatAgreement().add(kernel(*args), plain(*args), FLOAT_TOL["float32"],
                             f"{name} {case[0]} {tuple(case[1:])} float32",
                             relative=True, tag=tag)
        ms = cuda_ms(torch, lambda: kernel(*args), 20)
        # the same calls 10 back to back: the host's launch work overlaps
        # the card's, and the time is the kernel's where it is the longer
        ms_10 = cuda_ms(torch, lambda: kernel(*args), 10, inner=10)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 2, warmup=1)
        flops, nbytes = work(case, 4)
        t_ops = flops / flops_per_s
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        cc = max(flops / F32_CUDA_CORE_FLOPS_PER_S, t_bytes) * 1e3
        row = dict(ms=ms, ms_back_to_back=ms_10, bound_ms=bound,
                   bound_cuda_core_ms=cc, plain_ms=plain_ms, library_ms=None,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        out.setdefault(name, {})[case[0]] = row
        log(f"[{tag}] {name} float32 {case[0]} {tuple(case[1:])}: {ms:.6f} "
            f"ms a call (cuda events; {ms_10:.6f} in runs of 10 back to "
            f"back), bound {bound:.6f} ms "
            f"({row['bound_by']}: {flops} flop at 3xTF32's 495/3 TFLOP/s "
            f"{t_ops * 1e3:.6f} ms, {nbytes} B {t_bytes * 1e3:.6f} ms), "
            f"{ms / bound:.2f}x the bound; at the CUDA cores' 67 TFLOP/s "
            f"{cc:.6f} ms ({ms / cc:.2f}x); plain {plain_ms:.3f} ms")
        del args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [train], [train_rwkv6]: an ARCH at full width cut in depth, trained under
# the Paxos-leased loop; [train_zoo]: the MoE and encoder-decoder steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One training phase: ``arch`` at full width cut to ``layers``, its
    data, and its gradient gate: ``"rows"`` (each float kernel's Function
    alone, ``GRAD_CASES``) or ``"model"`` (every parameter leaf of the
    whole model against the plain kernels)."""
    tag: str
    arch: str
    layers: int
    data: dict
    grad_gate: str

    @property
    def run(self) -> str:
        return f"{self.arch.split('-')[0]}-train"


TRAIN_DATA = dict(seq_len=1024, batch=2, batches_per_shard=2)
# zamba2: one unit, six Mamba2 layers + the shared block (902,732,256
# float32 parameters); a checkpoint is 10.8 GB
TRAIN = TrainSpec("train", ZAMBA, 6, dict(TRAIN_DATA, vocab=32000), "rows")
# rwkv6-7b at 1 of 32 layers (755,290,112 float32 parameters, 12.1 GB with
# gradients and both moments, 27.5 GB at the restore's peak, which holds
# three copies of the state): the script's time limit sets the cut (at 2
# layers, 973,705,216 float32 parameters, 15.6 GB with gradients and both
# moments, 2.1 s a step and 17-19 s a checkpoint, 91.5 s a phase on a slow
# host; at 4 layers 22.6 GB, 51.1 GB at the restore's peak, which holds
# three copies of the state, 3.4-3.9 s a step and 26 s a checkpoint, 96-152
# s a phase; H100 at 700 W)
TRAIN_RWKV6 = TrainSpec("train_rwkv6", RWKV, 1, dict(TRAIN_DATA, vocab=65536),
                        "model")
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
# gate 3: run 1 trains steps 1-4 and run 2 resumes there for 5-8; a
# checkpoint ends each run, and a membership change comes mid-run 2
TRAIN_CKPT_EVERY = 4
TRAIN_JOIN_AT = 6
TRAIN_GATE_TOKENS = 256
GRAD_TOL = 1e-5           # each input's gradient, relative to its max
LEAF_TOL = 1e-4           # each parameter leaf's gradient, of its max |g|
LOSS_TOL = 1e-5           # a whole model's loss, relative
# the gradient wiring of each Function at this slice's widths:
# (kernel, label, shape) with the inputs of fa_inputs / ssd_inputs /
# wkv_inputs; the first case of each is the training path's own shape
GRAD_CASES = [
    ("flash_attention", "zamba2 shared attention, train shape",
     ("", 2, 32, 32, 1024, 1024, 112, True, None)),
    ("flash_attention", "GQA + window",
     ("", 2, 32, 8, 1024, 1024, 112, True, 256)),
    ("flash_attention", "whisper encoder self-attention",
     ("", 2, 20, 20, 1500, 1500, 64, False, None)),
    ("flash_attention", "whisper cross-attention",
     ("", 2, 20, 20, 64, 1500, 64, False, None)),
    ("flash_attention", "mixtral GQA 32/8, window 4096",
     ("", 2, 32, 8, 1024, 1024, 128, True, 4096)),
    ("mamba2_ssd", "zamba2 Mamba2 layer, train shape",
     ("", 2, 1024, 112, 64, 1, 64)),
    ("rwkv6_wkv", "rwkv6-7b layer",
     ("", 2, 64, 1024, 64, 64, "moderate")),
]
GRAD_INPUTS = {"flash_attention": fa_inputs, "mamba2_ssd": ssd_inputs,
               "rwkv6_wkv": wkv_inputs}


def _device_ms_of(torch, fn):
    """(device busy ms, wall ms) of one call of ``fn`` traced on the device
    alone."""
    rows, wall = profile_device(torch, fn, cpu=False)
    return sum(_device_us(r) for r in rows if _is_device_row(r)) / 1e3, wall


def train_gate_grads(torch, mods, dev, tag="train"):
    """Gate 2 (rows): each Function's forward (the kernel) and gradients
    (the plain recompute) against autograd through the plain version on
    the card, with the same upstream gradient.  Returns, per kernel, the
    device ms of one forward launch and of one backward recompute at the
    first case's shape."""
    split = {}
    for i, (name, label, case) in enumerate(GRAD_CASES):
        made = GRAD_INPUTS[name](torch, case, torch.float32, 700 + i, dev)
        inputs, kw = made if name == "flash_attention" else (made, {})
        wrapper, plain = _wrapper(mods, name), _plain(mods, name)
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        ref = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = wrapper.launches
        out = wrapper(*ins, **kw)
        launched = wrapper.launches - before
        want = plain(*ref, **kw)
        g = torch.Generator(device=dev).manual_seed(800 + i)
        g_out = torch.randn(want.shape, generator=g, device=dev)
        got_g = torch.autograd.grad(out, ins, g_out)
        want_g = torch.autograd.grad(want, ref, g_out)
        torch.cuda.synchronize()
        if launched != 1:
            raise AssertionError(f"[{tag}] {name} {label}: the forward "
                                 f"launched the kernel {launched} times")
        FloatAgreement().add(out.detach(), want.detach(),
                             FLOAT_TOL["float32"],
                             f"{name} {label} forward {tuple(case[1:])}",
                             relative=name != "flash_attention", tag=tag)
        for j, (a, b) in enumerate(zip(got_g, want_g)):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"[{tag}] {name} {label} input {j}: "
                                     f"gradient {tuple(a.shape)} {a.dtype}, "
                                     f"plain {tuple(b.shape)} {b.dtype}")
            FloatAgreement().add(a, b, GRAD_TOL,
                                 f"{name} {label} d/d(input {j}) "
                                 f"{tuple(a.shape)}", relative=True, tag=tag)
        del out, want, got_g, want_g, ref
        if name not in split:
            # cuda events: the profiler can miss a lone ctypes launch
            fwd_ms = cuda_ms(torch, lambda: wrapper(*inputs, **kw), 5)
            out = wrapper(*ins, **kw)
            bwd_ms, bwd_wall = _device_ms_of(
                torch, lambda: torch.autograd.grad(out, ins, g_out))
            split[name] = dict(shape=tuple(case[1:]), forward_ms=fwd_ms,
                               recompute_ms=bwd_ms,
                               recompute_wall_ms=bwd_wall)
            log(f"[{tag}] {name} at {tuple(case[1:])} float32: forward "
                f"{fwd_ms:.3f} ms a wrapper call (cuda events); backward "
                f"(plain recompute and its gradient) {bwd_ms:.3f} ms of "
                f"device time in {bwd_wall:.1f} ms of wall (traced)")
            del out
        del ins, inputs, g_out
        torch.cuda.empty_cache()
    return split


def train_gate_forward(torch, mods, model, params, data_cfg, dev, tag):
    """Gate 1: train_loss through the kernels (one launch of each kernel
    a layer that holds it, as a prefill: ``expected_launches``) against
    the mean next-token NLL of the teacher-forced decode (plain PyTorch)
    on the same tokens."""
    toks = torch.from_numpy(mods.synth_batch(data_cfg, 0, 0)[
        :, :TRAIN_GATE_TOKENS]).to(dev)
    b, s = toks.shape
    _zero_kernel_counts(mods)
    with torch.no_grad():
        loss = float(model.train_loss(params, {"tokens": toks},
                                      remat=False))
        launched = _kernel_counts(mods)
        caches = model.init_cache(b, s, dtype=torch.float32, device=dev)
        nll = torch.zeros((), dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        for t in range(s - 1):
            logits, caches = model.decode_step(params, caches,
                                               toks[:, t:t + 1])
            lp = torch.log_softmax(logits, dim=-1)
            nll -= lp.gather(-1, toks[:, t + 1:t + 2].long()).double().sum()
        want = float(nll) / (b * (s - 1))
        t_dec = time.perf_counter() - t0
    rel = abs(loss - want) / abs(want)
    expected = expected_launches(model)
    log(f"[{tag}] gate 1: train_loss {loss:.7f} (kernel launches "
        f"{json.dumps(launched)}, expected {json.dumps(expected)}) vs "
        f"teacher-forced decode NLL {want:.7f} ({s - 1} steps, "
        f"{t_dec:.2f} s) over {b} x {s} tokens: relative {rel:.3e} "
        f"(tolerance 1e-4)")
    if launched != expected or not rel <= 1e-4:
        raise AssertionError(f"[{tag}] gate 1: the kernel forward and the "
                             f"plain decode disagree, or the launches do "
                             f"not")
    del caches


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf: dict keys sorted, items by index."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [nl for i, v in enumerate(tree)
                for nl in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _loss_and_grads(torch, mods, model, params, batch):
    """``train_loss`` (remat on, as the train step) and the gradient of
    every named leaf -> (loss, [(name, grad)], the kernel launches of the
    forward alone, wall s)."""
    named = _named_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss = model.train_loss(params, batch, remat=True)
        fwd = _kernel_counts(mods)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    materialize_grads=True)
        torch.cuda.synchronize()
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return (loss.detach(), list(zip([n for n, _ in named], grads)), fwd,
            time.perf_counter() - t0)


def grads_vs_plain(torch, mods, tag, model, params, batch):
    """The loss and every parameter leaf's gradient of ``train_loss``
    through the kernels (the main path: counts from 0; the forward
    launches as a prefill, the backward's remat recompute as many again)
    against the same with the model's kernels' plain versions swapped in:
    the loss within LOSS_TOL relative, each leaf within LEAF_TOL of its
    max |g|; an MoE's expert choices and drops equal.  Returns the
    launches of the kernel run."""
    expected = expected_launches(model)
    kernels = [k for k, n in expected.items() if n]
    _zero_kernel_counts(mods)
    with recorded_routes(mods) as rk:
        loss, grads, fwd, t_k = _loss_and_grads(torch, mods, model, params,
                                                batch)
    launches = _kernel_counts(mods)
    _zero_kernel_counts(mods)
    with recorded_routes(mods) as rp, plain_kernels(mods, kernels):
        loss_p, grads_p, _, t_p = _loss_and_grads(torch, mods, model,
                                                  params, batch)
    plain_launches = _kernel_counts(mods)
    twice = {k: 2 * n for k, n in expected.items()}
    log(f"[{tag}] value and gradient of train_loss (remat on) over "
        f"{' + '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())}"
        f": {t_k:.2f} s through the kernels (launches: forward "
        f"{json.dumps(fwd)}, with the backward's remat recompute "
        f"{json.dumps(launches)}), {t_p:.2f} s with {kernels} plain")
    if fwd != expected or launches != twice or any(plain_launches.values()):
        raise AssertionError(f"[{tag}] launches {fwd} / {launches} / plain "
                             f"{plain_launches}, expected {expected} / "
                             f"{twice} / none")
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    log(f"[{tag}] loss {float(loss):.7f} through the kernels, "
        f"{float(loss_p):.7f} plain: relative {rel:.3e} (tolerance "
        f"{LOSS_TOL:g})")
    worst = []
    for (name, g), (_, gp) in zip(grads, grads_p):
        scale = float(gp.abs().max())
        err = float((g - gp).abs().max())
        worst.append((err / max(scale, 1e-30), name, scale))
        if not bool(g.isfinite().all()):
            raise AssertionError(f"[{tag}] d/d({name}) is not finite")
    worst.sort(reverse=True)
    log(f"[{tag}] {len(worst)} gradient leaves, max |g - g_plain| over max "
        f"|g_plain|, worst three: "
        f"{', '.join(f'{n} {e:.3e} (max |g| {s:.3e})' for e, n, s in worst[:3])}"
        f" (tolerance {LEAF_TOL:g})")
    if not rel <= LOSS_TOL or not worst[0][0] <= LEAF_TOL:
        raise AssertionError(f"[{tag}] the kernels' loss or gradients "
                             f"differ from the plain path's")
    if rk.idx or rp.idx:
        differ = sum(int((a != b).sum()) for a, b in zip(rk.idx, rp.idx))
        log(f"[{tag}] routed MoE calls {len(rk.idx)} / {len(rp.idx)} "
            f"(forward + remat recompute); expert choices that differ: "
            f"{differ} of {sum(a.numel() for a in rk.idx)}; dropped "
            f"assignments a call {rk.dropped} / {rp.dropped}")
        if len(rk.idx) != len(rp.idx) or differ or rk.dropped != rp.dropped:
            raise AssertionError(f"[{tag}] the routes differ")
    del grads, grads_p
    torch.cuda.empty_cache()
    return launches


def phase_train(torch, mods, dev, spec, split=None):
    """Training of ``spec.arch`` at full width cut to ``spec.layers``:
    gate 1 (forward), gate 2 (``spec.grad_gate``), gate 3 (fault-tolerant
    runs through the Paxos-leased stream and CAS-committed checkpoints).
    ``split`` (a "rows" gate's output) gives the float kernels' forward
    and recompute times for the step's breakdown."""
    tag, run = spec.tag, spec.run
    t_phase = time.perf_counter()
    require_free(torch, tag)
    cfg = dataclasses.replace(mods.ARCHS[spec.arch], n_layers=spec.layers)
    model = mods.build_model(cfg)
    data_cfg = mods.DataConfig(**spec.data)
    opt_cfg = mods.AdamWConfig(**TRAIN_OPT)
    expected = expected_launches(model)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    log(f"[{tag}] {cfg.name} cut to {_describe(model)}, d_model "
        f"{cfg.d_model}, data {spec.data}, AdamW {TRAIN_OPT}; "
        f"{free_gb:.1f} GB free for checkpoints")

    params = model.init(0, device=dev)          # what train() draws first
    n = sum(t.numel() for t in mods.leaves(params))
    log(f"[{tag}] {n} float32 parameters ({n * 4 / 1e9:.2f} GB; with "
        f"gradients and both moments {n * 16 / 1e9:.2f} GB)")
    train_gate_forward(torch, mods, model, params, data_cfg, dev, tag)
    t0 = time.perf_counter()
    if spec.grad_gate == "rows":
        del params
        torch.cuda.empty_cache()
        split = train_gate_grads(torch, mods, dev, tag)
    else:
        toks = torch.from_numpy(mods.synth_batch(data_cfg, 0, 0)).to(dev)
        grads_vs_plain(torch, mods, tag, model, params, {"tokens": toks})
        del params, toks
        torch.cuda.empty_cache()
    log(f"[{tag}] gate 2 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # gate 3: two runs over one registry, a replica crashed between them
    registry = mods.PaxosRegistry(
        n_machines=5, all_aboard=True,
        machine_cls=functools.partial(mods.BatchedMachine, device=dev))
    paxos = (mods.apply_ops.paxos_apply, mods.propose_ops.paxos_propose)
    _zero_kernel_counts(mods)
    for k in paxos:
        k.launches = 0
    last = dict(t=time.perf_counter(), counts=_kernel_counts(mods))
    records, ckpts, epochs, restored, held = [], [], [], [], {}

    def on_log(rec):
        now, counts = time.perf_counter(), _kernel_counts(mods)
        records.append(dict(rec, wall_s=now - last["t"], launches={
            k: counts[k] - last["counts"][k] for k in counts}))
        if rec["step"] == TRAIN_JOIN_AT:        # steps 7-8 run after it
            registry.join_membership(run, 1)
        last.update(t=time.perf_counter(), counts=counts)

    def on_ckpt(step, won):
        now = time.perf_counter()
        ckpts.append(dict(step=step, won=won, seconds=now - last["t"]))
        # keep the newest committed checkpoint only
        for old in (ckpt_dir / run).glob("step_*"):
            if old.name != f"step_{step:08d}":
                shutil.rmtree(old)
        last["t"] = time.perf_counter()

    real_restore = mods.store.restore

    def checked_restore(directory, run, like, registry=None, step=None):
        out, got = real_restore(directory, run, like, registry, step)
        saved = held.pop("state")
        same = [torch.equal(a, b) for a, b in zip(mods.leaves(out),
                                                  mods.leaves(saved))]
        restored.append(dict(step=got, leaves=len(same), equal=sum(same),
                             count_ok=len(mods.leaves(out))
                             == len(mods.leaves(saved))))
        del saved
        last["t"] = time.perf_counter()
        return out, got

    hooks = {"on_log": on_log, "on_ckpt": on_ckpt,
             "on_membership": epochs.append}
    tcfg = mods.TrainConfig(run=run, steps=4, ckpt_every=TRAIN_CKPT_EVERY,
                            ckpt_dir=str(ckpt_dir), log_every=1)
    torch.cuda.reset_peak_memory_stats()
    out1 = mods.train(model, data_cfg, tcfg, opt_cfg, registry, hooks,
                      device=dev)
    held["state"] = (out1["params"], out1["opt_state"])
    del out1
    registry.crash(4)
    mods.store.restore = checked_restore
    try:
        out2 = mods.train(model, data_cfg,
                          dataclasses.replace(tcfg, steps=8), opt_cfg,
                          registry, hooks, device=dev)
    finally:
        mods.store.restore = real_restore
    torch.cuda.synchronize()
    t_runs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(_kernel_counts(mods), paxos_apply=paxos[0].launches,
                    paxos_propose=paxos[1].launches)
    committed = registry.latest_checkpoint(run)
    cursor = registry.fetch(f"data/{run}/cursor")
    for r in records:
        log(f"[{tag}] step {r['step']}: loss {r['loss']:.6f}, grad norm "
            f"{r['grad_norm']:.6f}, {r['wall_s'] * 1e3:.1f} ms since the "
            f"previous step (checkpoint excluded), launches: "
            f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
    for c in ckpts:
        log(f"[{tag}] checkpoint step {c['step']}: committed={c['won']}, "
            f"saved in {c['seconds']:.2f} s")
    log(f"[{tag}] run 2 restored {restored}; start_step "
        f"{out2['start_step']}, latest checkpoint {committed}, shard cursor "
        f"{cursor}, membership epochs seen {epochs}; main-path launches "
        f"of both runs {json.dumps(launches)}; peak memory {peak_gb:.2f} "
        f"GB; both runs {t_runs:.1f} s")

    # gates
    losses = [r["loss"] for r in records]
    norms = [r["grad_norm"] for r in records]
    problems = []
    if [r["step"] for r in records] != list(range(1, 9)):
        problems.append(f"logged steps {[r['step'] for r in records]}")
    if out2["start_step"] != 4:
        problems.append(f"start_step {out2['start_step']} != 4")
    if committed != 8:
        problems.append(f"latest checkpoint {committed} != 8")
    if [c["step"] for c in ckpts] != list(range(TRAIN_CKPT_EVERY, 9,
                                                TRAIN_CKPT_EVERY)) or \
            not all(c["won"] for c in ckpts):
        problems.append(f"checkpoints {ckpts}")
    if len(restored) != 1 or restored[0]["step"] != 4 or \
            not restored[0]["count_ok"] or \
            restored[0]["equal"] != restored[0]["leaves"]:
        problems.append(f"restore {restored} is not the step-4 state bit "
                        f"for bit")
    shards = 8 // spec.data["batches_per_shard"]
    if cursor != shards:
        problems.append(f"shard cursor {cursor} != {shards} shards consumed")
    if not all(mods.np.isfinite(losses)) or not all(mods.np.isfinite(norms)):
        problems.append("non-finite loss or grad norm")
    if not (losses[6] + losses[7]) / 2 < (losses[0] + losses[1]) / 2:
        problems.append("the loss of steps 7-8 is not below that of 1-2")
    per_step = {k: 2 * v for k, v in expected.items()}
    bad = [r["step"] for r in records if r["launches"] != per_step]
    if bad:
        problems.append(f"steps {bad} did not launch {per_step} (forward "
                        f"+ remat recompute)")
    if not launches["paxos_apply"] or not launches["paxos_propose"]:
        problems.append("the Paxos kernels did not launch")
    if epochs != [2]:
        problems.append(f"membership epochs seen {epochs} != [2]")
    if problems:
        raise AssertionError(f"[{tag}] gate 3: " + "; ".join(problems))

    # the step's time, memory, the forward/recompute split, busy share
    step_ms = statistics.median(r["wall_s"] * 1e3 for r in records[1:])
    step_fn = mods.make_train_step(model, opt_cfg)
    tokens = torch.from_numpy(mods.synth_batch(data_cfg, 99, 0)).to(dev)
    params, opt_state = out2["params"], out2["opt_state"]
    del out2
    t0 = time.perf_counter()
    rows, prof_ms = profile_device(
        torch, lambda: step_fn(params, opt_state, {"tokens": tokens}),
        cpu=False)
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    groups = {}
    for r in dev_rows:
        g = _kernel_group(r.key)
        t_ms, cnt = groups.get(g, (0.0, 0))
        groups[g] = (t_ms + _device_us(r) / 1e3, cnt + r.count)
    log(f"[{tag}] one profiled step: wall {prof_ms:.1f} ms, device busy "
        f"{dev_ms:.1f} ms (busy share {dev_ms / prof_ms:.4f}); the profile "
        f"took {time.perf_counter() - t0:.1f} s with its trace's processing")
    for g, (t_ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag}]   {t_ms:10.3f} ms  x{cnt:<7d} {g} "
            f"({t_ms / dev_ms:.3f} of device time)")
    for name, sp in (split or {}).items():
        n_fwd = per_step[name]
        if not n_fwd:
            continue
        log(f"[{tag}] {name} a step: forward launches x ms = {n_fwd} x "
            f"{sp['forward_ms']:.3f} = {n_fwd * sp['forward_ms']:.2f} ms "
            f"(cuda events, at {sp['shape']}); backward recomputes x ms = "
            f"{n_fwd // 2} x {sp['recompute_ms']:.3f} = "
            f"{n_fwd // 2 * sp['recompute_ms']:.2f} ms of device time "
            f"({n_fwd // 2} x {sp['recompute_wall_ms']:.0f} = "
            f"{n_fwd // 2 * sp['recompute_wall_ms']:.0f} ms of wall, "
            f"traced)")
    log(f"[{tag}] ms a step (median of steps 2-8, checkpoints excluded): "
        f"{step_ms:.1f}; peak memory {peak_gb:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params, opt_state, registry
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, peak_gb=peak_gb,
                busy_share=dev_ms / prof_ms, split=split)


MIXTRAL_TRAIN_LAYERS = 2  # of 32: 3,164,688,384 float32 parameters
ZOO_TRAIN_TOKENS = 1024   # mixtral: 2 x 1024 tokens a step
ZOO_TRAIN_STEPS = 3


def train_steps(torch, mods, tag, model, params, batch):
    """ZOO_TRAIN_STEPS ``make_train_step`` steps with AdamW on one fixed
    batch (counts from 0 before each step): every loss finite, the last
    below the first, each step's launches the forward's and the remat
    recompute's -> (launches of the steps, ms a step, peak GB)."""
    opt_cfg = mods.AdamWConfig(**TRAIN_OPT)
    opt_state = mods.adamw.init(opt_cfg, params)
    step_fn = mods.make_train_step(model, opt_cfg)
    per_step = {k: 2 * v for k, v in expected_launches(model).items()}
    torch.cuda.reset_peak_memory_stats()
    losses, walls, total = [], [], collections.Counter()
    for i in range(ZOO_TRAIN_STEPS):
        _zero_kernel_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        got = _kernel_counts(mods)
        total.update(got)
        log(f"[{tag}] step {i + 1}: loss {losses[-1]:.6f}, grad norm "
            f"{float(m['grad_norm']):.6f}, {walls[-1]:.1f} ms, launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
        if got != per_step:
            raise AssertionError(f"[{tag}] step {i + 1} launched {got}, "
                                 f"expected {per_step}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] {ZOO_TRAIN_STEPS} steps: losses {losses}, ms a step "
        f"{walls}, peak memory {peak_gb:.2f} GB")
    if not all(mods.np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    del opt_state
    return dict(total), statistics.median(walls[1:]), peak_gb


def phase_train_zoo(torch, mods, dev):
    """[train_zoo]: mixtral-8x7b at MIXTRAL_TRAIN_LAYERS layers (2 x 1024
    tokens) and whisper-large-v3 whole (2 x 1500 frames, 2 x 64 tokens),
    float32: gradients through the kernels against the plain path, then
    ZOO_TRAIN_STEPS AdamW steps; one model resident at a time."""
    out = {}
    for tag, cfg in (("train_mixtral", _cut(mods, MIXTRAL,
                                            MIXTRAL_TRAIN_LAYERS)),
                     ("train_whisper", mods.ARCHS[WHISPER])):
        t0 = time.perf_counter()
        require_free(torch, tag)
        model = mods.build_model(cfg)
        params = _model_params(torch, model, torch.float32, dev, 0, tag)
        n = sum(t.numel() for t in _leaves(params))
        log(f"[{tag}] parameters {n * 4 / 1e9:.2f} GB, with two gradient "
            f"sets {n * 12 / 1e9:.2f} GB, with gradients and moments "
            f"{n * 16 / 1e9:.2f} GB")
        gen = torch.Generator(device=dev).manual_seed(21)
        if cfg.family == "encdec":
            frames, tokens = whisper_inputs(torch, mods, cfg, torch.float32,
                                            gen, dev)
            batch = {"frames": frames, "tokens": tokens}
        else:
            batch = {"tokens": torch.randint(
                1, cfg.vocab, (2, ZOO_TRAIN_TOKENS), generator=gen,
                device=dev, dtype=torch.int32)}
        grad_launches = grads_vs_plain(torch, mods, tag, model, params,
                                       batch)
        steps, step_ms, peak_gb = train_steps(torch, mods, tag, model,
                                              params, batch)
        out[tag.split("_")[1]] = dict(grad_launches=grad_launches,
                                      step_launches=steps, step_ms=step_ms,
                                      peak_gb=peak_gb)
        del params, batch
        torch.cuda.empty_cache()
        log(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [kimi]: kimi-k2-1t-a32b whole at its one-card cut
# ---------------------------------------------------------------------------

KIMI_F32_LAYERS = 1       # of 61: 19,378,623,488 float32 parameters, 77.51 GB
KIMI_BF16_LAYERS = 2      # of 61: 36,408,429,568 bf16 parameters, 72.82 GB
KIMI_GATE1_TOKENS = 1024
KIMI_GATE2_TOKENS = 256
KIMI_ROOMY = 8.0          # 41 slots an expert over 256 tokens: none drops
ENGINE_LAUNCHES = {"paxos_apply": 31, "paxos_propose": 65}


def release_memory(torch, tag):
    """Collects garbage and returns the caching allocator's free blocks to
    the card; prints what is still allocated and what the card has free,
    and the largest tensors still alive on it."""
    import gc
    import warnings

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    with warnings.catch_warnings():     # isinstance on deprecated objects
        warnings.simplefilter("ignore")
        alive = sorted(
            (o.numel() * o.element_size(), tuple(o.shape), o.dtype)
            for o in gc.get_objects()
            if isinstance(o, torch.Tensor) and o.is_cuda)[::-1]
    log(f"[{tag}] torch.cuda.mem_get_info(): {free / 1e9:.2f} GB free of "
        f"{total / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB; {len(alive)} "
        f"tensors alive on the card, the largest "
        f"{[(f'{n / 1e6:.1f} MB', sh, str(dt)) for n, sh, dt in alive[:4]]}")
    return free


# the peak memory allocated of each large phase, measured on an H100 80GB
# HBM3 at 700 W (PERF.md section 5) and rounded up: a card with less free
# than that fails the phase up front and says so ("train_mesh" and
# "decode_mesh": the most of a case's four ranks' peaks together, their
# collective buffers included, and its one-process run's)
PEAK_GB = {"train": 32.8, "train_rwkv6": 27.6, "train_mixtral": 77.1,
           "train_whisper": 31.3, "kimi": 79.3, "train_mesh": 57.4,
           "decode_mesh": 43.0}


def require_free(torch, tag):
    """release_memory, then an error unless the card has PEAK_GB[tag]
    free."""
    free = release_memory(torch, tag) / 1e9
    log(f"[{tag}] needs {PEAK_GB[tag]} GB at its peak: margin "
        f"{free - PEAK_GB[tag]:.2f} GB")
    if free < PEAK_GB[tag]:
        raise RuntimeError(f"[{tag}] the card has {free:.2f} GB free, the "
                           f"phase peaks at {PEAK_GB[tag]} GB")


def phase_kimi(torch, mods, dev):
    """kimi-k2-1t-a32b at full width: in float32 cut to KIMI_F32_LAYERS
    (drawn a slice at a time) the zoo's gates and the engine; then its
    bf16 prefill cut to KIMI_BF16_LAYERS at the published capacity
    factor.  Returns the launches of each path."""
    tag = "kimi"
    t_phase = time.perf_counter()
    require_free(torch, tag)
    cfg = _cut(mods, KIMI, KIMI_F32_LAYERS)
    model = mods.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = _model_params(torch, model, torch.float32, dev, 0, tag, mods)
    log(f"[{tag}] after the draw: {torch.cuda.mem_get_info()[0] / 1e9:.2f} "
        f"GB free, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator(device=dev).manual_seed(19)
    tokens = torch.randint(1, cfg.vocab, (1, KIMI_GATE1_TOKENS),
                           generator=gen, device=dev, dtype=torch.int32)
    # gate 1: through the kernels vs plain, at the published capacity
    with recorded_routes(mods) as kr:
        logits, launches = kernel_vs_plain_prefill(
            torch, mods, tag, model, params, (tokens,),
            f"1 x {KIMI_GATE1_TOKENS} tokens, capacity factor "
            f"{cfg.capacity_factor}")
    half = len(kr.idx) // 2
    if half != cfg.n_layers or len(kr.idx) != 2 * half:
        raise AssertionError(f"{tag}: {len(kr.idx)} routed MoE calls, "
                             f"expected 2 x {cfg.n_layers}")
    differ = sum(int((a != b).sum())
                 for a, b in zip(kr.idx[:half], kr.idx[half:]))
    log(f"[{tag}] top-{cfg.top_k} expert choices that differ between the "
        f"kernel and the plain prefill: {differ} of "
        f"{sum(a.numel() for a in kr.idx[:half])}; dropped assignments "
        f"{kr.dropped[:half]} / {kr.dropped[half:]}")
    if differ or kr.dropped[:half] != kr.dropped[half:]:
        raise AssertionError(f"{tag}: the routes differ")
    del logits
    # gate 2: at a capacity where nothing drops, prefill == decode
    roomy = mods.build_model(dataclasses.replace(
        cfg, capacity_factor=KIMI_ROOMY))
    short = tokens[:, :KIMI_GATE2_TOKENS]
    with recorded_routes(mods) as r8:
        want, _ = _prefill_counted(torch, mods, roomy, params, (short,))
    with recorded_routes(mods) as r_pub:
        model.prefill(params, short)
    log(f"[{tag}] 1 x {KIMI_GATE2_TOKENS} tokens at capacity factor "
        f"{KIMI_ROOMY} ({int(KIMI_GATE2_TOKENS * cfg.top_k // cfg.n_experts * KIMI_ROOMY) + 1} "
        f"slots an expert): {sum(r8.dropped)} assignments dropped (must be "
        f"0); the published {cfg.capacity_factor} drops "
        f"{sum(r_pub.dropped)}")
    if sum(r8.dropped):
        raise AssertionError(f"{tag}: capacity factor {KIMI_ROOMY} dropped "
                             f"{r8.dropped}")
    prefill_vs_decode(torch, tag, roomy, params, short, want, dev)
    del want
    paxos = phase_engine(torch, mods, dev, tag, model, params, ZOO_GEN_STEPS)
    if paxos != ENGINE_LAUNCHES:
        raise AssertionError(f"{tag}: the engine's routes launched {paxos}, "
                             f"expected {ENGINE_LAUNCHES}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    release_memory(torch, tag)
    log(f"[{tag}] float32 gates {time.perf_counter() - t_phase:.1f} s, "
        f"peak {peak_gb:.2f} GB")
    bf16 = phase_prefill_bf16(torch, mods, dev, KIMI,
                              cfg=_cut(mods, KIMI, KIMI_BF16_LAYERS),
                              ranges=MOE_RANGES, sliced=True)
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(prefill=launches["flash_attention"], engine=paxos,
                f32_peak_gb=peak_gb, bf16=bf16)


# ---------------------------------------------------------------------------
# the system's drivers: the three fault smokes and the three examples
# ---------------------------------------------------------------------------

DRIVERS = {"batched_smoke": "scripts/torch_batched_smoke.py",
           "reconfig_smoke": "scripts/torch_reconfig_smoke.py",
           "open_loop_smoke": "scripts/torch_open_loop_smoke.py",
           "trace_report": "scripts/torch_trace_report.py",
           "quickstart": "examples/torch_quickstart.py",
           "serve_kvstore": "examples/torch_serve_kvstore.py",
           "train_fault_tolerant": "examples/torch_train_fault_tolerant.py"}
def load_drivers():
    """The port's drivers, loaded by path (they are scripts, not modules
    of the package)."""
    import importlib.util

    out = {}
    for name, rel in DRIVERS.items():
        spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                      ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        out[name] = mod
    return argparse.Namespace(**out)


def _zero_select_counts(mods):
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0


def _select_recorders(torch, ce):
    """Recorders of the two fused entries keeping the first call at each
    new shape: the receiver's (18, M, K) stack; the issuer's staged lanes,
    table lanes and machines."""
    rec_r = GrowthRecorder(torch, ce._fused_receiver_step, (),
                           lambda a: tuple(a[0].shape))
    rec_i = GrowthRecorder(torch, ce.paxos_propose_staged, (),
                           lambda a: (a[1].shape[1], a[0].shape[1],
                                      a[2].shape[1]), after=(0,))
    return rec_r, rec_i


def phase_smokes(torch, mods, dev, apply_ok, propose_ok):
    """The three 20-seed fault smokes of ``scripts/torch_*_smoke.py`` on
    the card, each driven with the select networks' counts set to 0 just
    before it and read just after; every seed must launch both kernels
    (the drivers raise otherwise).  The first fused call at each new
    shape (grown stacks, 1-lane waves, 3 -> 5 machines) is recorded and
    replayed through the plain versions.  Then one injected corruption
    must be caught by the checkers and leave a dump."""
    d = mods.drivers
    bs, ol = d.batched_smoke, d.open_loop_smoke
    ce = mods.cluster_engine
    t_phase = time.perf_counter()
    rec_r, rec_i = _select_recorders(torch, ce)

    def reconfig():
        if d.reconfig_smoke.main([], device=dev) != 0:
            raise AssertionError("[smokes] the reconfig smoke failed")

    runs = (("batched", lambda: [bs.check_seed(seed, dev, 1, DUMP_DIR)
                                 for seed in bs.SEEDS]),
            ("batched_shards4", lambda: [bs.check_seed(seed, dev, 4, DUMP_DIR)
                                         for seed in sorted(bs.KERNEL_SEEDS)]),
            ("reconfig", reconfig),
            # every spec batched, not only the script's BATCHED_SEEDS
            ("open_loop", lambda: [ol.check_seed(seed, dev, True, DUMP_DIR)
                                   for seed in ol.SEEDS]))
    smoke_launches = {k: {} for k in ce.SELECT_NETWORKS}
    seconds = {}
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        for name, drive in runs:
            log(f"[smokes] {name}")
            _sync(torch, dev)
            _zero_select_counts(mods)
            t0 = time.perf_counter()
            drive()
            _sync(torch, dev)
            seconds[name] = time.perf_counter() - t0
            counts = mods.select_launches()
            mods.require_launches(counts, dev)
            for k in ce.SELECT_NETWORKS:
                smoke_launches[k][name] = counts[k]
            log(f"[smokes] {name}: {seconds[name]:.1f} s, launches "
                f"{json.dumps(dict(counts))}")
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    log(f"[smokes] replaying the first fused call at each of "
        f"{len(rec_r.samples)} receiver and {len(rec_i.samples)} issuer "
        f"shapes through the plain versions")
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)

    # the postmortem path: a corrupted commit record is caught and dumped
    stem = DUMP_DIR / "batched_seed000"
    for suffix in (".jsonl", ".trace.json"):
        stem.with_suffix(suffix).unlink(missing_ok=True)
    t0 = time.perf_counter()
    try:
        bs.check_seed(0, dev, 1, DUMP_DIR, inject_failure=True)
    except mods.checkers.SafetyViolation as exc:
        log(f"[smokes] the injected corruption caught by the checkers: "
            f"{exc}")
    else:
        raise AssertionError("[smokes] the injected corruption was not "
                             "caught")
    jsonl = stem.with_suffix(".jsonl")
    if not jsonl.is_file() or not stem.with_suffix(".trace.json").is_file():
        raise AssertionError(f"[smokes] no flight dump at {jsonl}")
    if d.trace_report.main([str(jsonl)]) != 0:
        raise AssertionError("[smokes] torch_trace_report failed")
    seconds["inject_failure"] = time.perf_counter() - t0
    log(f"[smokes] seconds {json.dumps(seconds)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": smoke_launches, "seconds": seconds}


def phase_examples(torch, mods, dev, apply_ok, propose_ok, float_ok):
    """The three examples of ``examples/torch_*.py`` on the card: the
    quickstart registry, serve_kvstore (its prefill through the
    flash-attention kernel) and train_fault_tolerant at ``--full`` (300
    steps, the resume at 150, a descending loss), each with its counts set
    to 0 just before it and read just after.  In each, the first call of
    every kernel at each shape it meets (the registries' fused waves, the
    prefill's and the train step's attention) is recorded and replayed
    through the plain version after the example."""
    d = mods.drivers
    ce, blocks = mods.cluster_engine, mods.blocks
    fa = mods.fa_ops.flash_attention
    t_phase = time.perf_counter()
    launches = {k: {} for k in ce.SELECT_NETWORKS + ("flash_attention",)}
    seconds = {}
    rec_r, rec_i = _select_recorders(torch, ce)
    rec_fa = GrowthRecorder(torch, fa, (), lambda a: tuple(
        (tuple(t.shape), t.dtype) for t in a[:3]))

    def replay(name):
        """The example's recorded calls against the plain versions."""
        phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
        if launches["flash_attention"][name] and not rec_fa.samples:
            raise AssertionError(f"[examples] {name}: no flash_attention "
                                 f"call recorded")
        with torch.no_grad():
            for i, ins, kw, outs in rec_fa.samples:
                dname = str(ins[0].dtype).removeprefix("torch.")
                float_ok["flash_attention"].add(
                    outs[0], mods.fa_ops.attention_plain(*ins, **kw),
                    FLOAT_TOL[dname],
                    f"{name}: recorded flash_attention call {i} "
                    f"{tuple(ins[0].shape)}/{tuple(ins[1].shape)} {kw}",
                    relative=True, tag="examples")
        for rec in (rec_r, rec_i, rec_fa):
            rec.samples.clear()
            rec.seen.clear()

    def counted(name, fn):
        _sync(torch, dev)
        _zero_select_counts(mods)
        fa.launches = 0
        ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
        blocks.flash_attention = rec_fa
        t0 = time.perf_counter()
        try:
            out = fn()
            _sync(torch, dev)
        finally:
            ce._fused_receiver_step = rec_r.fn
            ce.paxos_propose_staged = rec_i.fn
            blocks.flash_attention = rec_fa.fn
        seconds[name] = time.perf_counter() - t0
        got = {**mods.select_launches(), "flash_attention": fa.launches}
        for k, n in got.items():
            launches[k][name] = n
        mods.require_launches(got, dev)
        log(f"[examples] {name}: {seconds[name]:.1f} s, launches "
            f"{json.dumps(got)}")
        replay(name)
        return out

    if counted("quickstart", lambda: d.quickstart.main([], device=dev)):
        raise AssertionError("[examples] quickstart failed")
    sk = d.serve_kvstore
    model = mods.build_model(sk.CFG)
    params = sk.init_params(model, dev)
    served = counted("serve_kvstore",
                     lambda: sk.serve(model, params, dev))
    n_layers = sk.CFG.n_layers
    if launches["flash_attention"]["serve_kvstore"] != n_layers:
        raise AssertionError(
            f"[examples] serve_kvstore's prefill launched flash_attention "
            f"{launches['flash_attention']['serve_kvstore']} times, not once "
            f"a layer ({n_layers})")
    log(f"[examples] serve_kvstore: routes {served['routes']}, prefill "
        f"max logit error {served['prefill_err']:.3g} of max |logit|")
    del model, params, served

    tf = d.train_fault_tolerant
    ckpt = ROOT / "build" / "torch_ckpt_example"
    from repro_torch.train import loop as train_loop

    # each step between two synchronisations, each checkpoint save
    real_make, real_save = train_loop.make_train_step, mods.store.save
    step_walls, save_walls = [], []

    def timed_make(*args, **kw):
        step_fn = real_make(*args, **kw)
        step_walls.append([])

        def step(*a, **k):
            _sync(torch, dev)
            t0 = time.perf_counter()
            out = step_fn(*a, **k)
            _sync(torch, dev)
            step_walls[-1].append(time.perf_counter() - t0)
            return out
        return step

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        won = real_save(*args, **kw)
        save_walls.append(time.perf_counter() - t0)
        return won

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    train_loop.make_train_step, mods.store.save = timed_make, timed_save
    try:
        trained = counted("train_fault_tolerant",
                          lambda: tf.run(True, str(ckpt), dev))
    finally:
        train_loop.make_train_step, mods.store.save = real_make, real_save
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # each run's first step warms up
    step_ms = statistics.median(w * 1e3 for run in step_walls
                                for w in run[1:])
    _, total, _ = tf.settings(True)
    layers = trained["model"].cfg.n_layers
    # one launch a layer in the forward and one in its remat recompute;
    # the backward recomputes the plain version
    want_fa = 2 * layers * total
    got_fa = launches["flash_attention"]["train_fault_tolerant"]
    if got_fa != want_fa:
        raise AssertionError(
            f"[examples] the train steps launched flash_attention {got_fa} "
            f"times, not {want_fa} (2 a layer a step)")
    wall = trained["out1"]["wall_s"] + trained["out2"]["wall_s"]
    losses = trained["losses"]
    log(f"[examples] train_fault_tolerant --full: resumed at "
        f"{trained['out2']['start_step']} of {total}, committed "
        f"{[s for s, _ in trained['committed']]}, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; flash_attention launches "
        f"in the train steps {got_fa} ({got_fa // total} a step); ms a step "
        f"{step_ms:.3f} (median, each run's first step excluded; "
        f"{wall / total * 1e3:.3f} as the two runs' wall over {total} "
        f"steps, with {len(save_walls)} checkpoint saves of "
        f"{statistics.median(save_walls):.3f} s median and the registry's "
        f"ops); peak memory {peak_gb:.2f} GB")
    # one more step at the final state, profiled: the device's busy share
    step_fn = mods.make_train_step(trained["model"], trained["opt"])
    tokens = torch.from_numpy(
        mods.synth_batch(trained["data"], 99, 0)).to(dev)
    state = [trained["out2"]["params"], trained["out2"]["opt_state"]]
    del trained

    def one_step():
        state[0], state[1], _ = step_fn(state[0], state[1],
                                        {"tokens": tokens})

    one_step()
    rows, prof_ms = profile_device(torch, one_step, cpu=False)
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    groups = collections.Counter()
    for r in dev_rows:
        groups[_kernel_group(r.key)] += _device_us(r) / 1e3
    log(f"[examples] one profiled train step: wall {prof_ms:.1f} ms, device "
        f"busy {dev_ms:.1f} ms (busy share {dev_ms / prof_ms:.4f}); "
        + ", ".join(f"{g} {t:.3f} ms" for g, t in groups.most_common()))
    del state, step_fn
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[examples] seconds {json.dumps(seconds)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "seconds": seconds, "step_ms": step_ms,
            "wall_ms_a_step": wall / total * 1e3, "peak_gb": peak_gb,
            "busy_share": dev_ms / prof_ms}


def load_modules():
    """The port's modules the phases use, as one namespace (a driver that
    runs a few phases alone imports this script and calls it)."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.shapes import Shape
    from repro_torch.coord.registry import PaxosRegistry
    from repro_torch.core import checkers
    from repro_torch.core import proposer_vector as pv
    from repro_torch.core import replay
    from repro_torch.core.lanes import kv_to_lanes
    from repro_torch.core.node import Machine, ProtocolConfig
    from repro_torch.core.sim import Cluster, NetConfig, completion_digest, \
        completion_tuples, workload
    from repro_torch.core.vector import NOOP
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.paxos_apply import ops as apply_ops
    from repro_torch.kernels.paxos_propose import ops as propose_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import steps
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.steps import make_train_step, place_cell
    from repro_torch.models import blocks
    from repro_torch.models import lm
    from repro_torch.models.common import Init
    from repro_torch.models.registry import build_model, input_specs
    from repro_torch.obs import FlightRecorder, flight_guard
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.peer_staged import PeerStaged
    from repro_torch.parallel.sharding import MeshShape, use_mesh
    from repro_torch.reconfig import catchup
    from repro_torch.serve import loadgen
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    from repro_torch.serve.paxos import BatchedMachine, cluster_engine, \
        require_launches, select_launches
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.tree import leaves

    return argparse.Namespace(
        checkers=checkers, Machine=Machine, ProtocolConfig=ProtocolConfig,
        Cluster=Cluster, NetConfig=NetConfig,
        completion_tuples=completion_tuples,
        completion_digest=completion_digest, workload=workload,
        kv_to_lanes=kv_to_lanes, replay=replay, noop_kind=NOOP,
        apply_ops=apply_ops, propose_ops=propose_ops,
        BatchedMachine=BatchedMachine, cluster_engine=cluster_engine,
        select_launches=select_launches, require_launches=require_launches,
        np=np, pv=pv, ARCHS=ARCHS, PaxosRegistry=PaxosRegistry,
        blocks=blocks, lm=lm, Init=Init,
        build_model=build_model, input_specs=input_specs, Shape=Shape,
        fa_ops=fa_ops, ssd_ops=ssd_ops,
        wkv_ops=wkv_ops, DecodeEngine=DecodeEngine, ServeConfig=ServeConfig,
        loadgen=loadgen, FlightRecorder=FlightRecorder,
        flight_guard=flight_guard, catchup=catchup, store=store,
        leaves=leaves, DataConfig=DataConfig, synth_batch=synth_batch,
        AdamWConfig=AdamWConfig, adamw=adamw,
        make_train_step=make_train_step,
        TrainConfig=TrainConfig, train=train, build=_build,
        dryrun=dryrun, roofline=roofline, use_mesh=use_mesh,
        steps=steps, place_cell=place_cell, make_device_mesh=make_device_mesh,
        PeerStaged=PeerStaged, CollectiveCounter=CollectiveCounter,
        MeshShape=MeshShape, drivers=load_drivers())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-ops", type=int, default=N_OPS,
                    help="client ops per serve seed (default %(default)s)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script measures the port on a CUDA card", file=sys.stderr)
        return 1

    mods = load_modules()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (the model checks' tolerances
    # assume it; these are PyTorch's defaults for matmul, not for cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {card}")

    phase_build(mods.build)
    apply_ok, propose_ok = phase_kernels(torch, mods.apply_ops,
                                         mods.propose_ops, mods.pv, dev)
    if args.n_ops < N_OPS:
        log(f"[serve] n_ops cut from {N_OPS} to {args.n_ops}")
    runs, rec_r, rec_i, launches, waves_all = phase_serve(
        torch, mods, dev, args.n_ops)
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    serve_want = serve_fingerprints(mods, runs)
    # the serve clusters' stacks and the recorded calls' planes (about 8.6
    # GB on the card) are not needed past this point
    del runs, rec_r, rec_i
    serve_mesh = phase_serve_mesh(torch, mods, args.n_ops, serve_want)
    train_mesh = phase_train_mesh(torch, mods, dev)
    decode_mesh = phase_decode_mesh(torch, mods, dev)
    phase_schedule_replay(torch, mods, dev, args.n_ops)
    times = phase_timings(torch, mods, mods.pv, dev, waves_all)
    phase_idle(torch, mods, dev, args.n_ops)
    phase_open_loop(torch, mods, dev, apply_ok, propose_ok)
    phase_reconfig(torch, mods, dev, apply_ok, propose_ok)
    smokes = phase_smokes(torch, mods, dev, apply_ok, propose_ok)
    float_ok = phase_model_kernels(torch, mods, dev)
    # one full-width model resident at a time: each phase frees its own
    zamba_launches, _ = phase_model(
        torch, mods, dev, ZAMBA,
        {"flash_attention": (0, 6, 12), "mamba2_ssd": (0, 40, 80)}, float_ok)
    prefill = phase_prefill_bf16(torch, mods, dev, ZAMBA)
    rwkv_launches, _ = phase_model(torch, mods, dev, RWKV,
                                   {"rwkv6_wkv": (0, 15, 31)}, float_ok)
    rwkv_prefill = phase_prefill_bf16(torch, mods, dev, RWKV)
    zoo = phase_zoo(torch, mods, dev)
    dense = phase_dense(torch, mods, dev, float_ok)
    parallel = phase_parallel(torch, mods, dev)
    times.update(phase_model_timings(
        torch, mods, dev,
        {**prefill["per_launch_ms"], **rwkv_prefill["per_launch_ms"]}))
    zoo_times = fa_times(torch, mods, dev, ZOO_FA_SHAPES, "time", 90)
    f32_times = phase_float32_times(torch, mods, dev)
    trained = phase_train(torch, mods, dev, TRAIN)
    trained_rwkv6 = phase_train(torch, mods, dev, TRAIN_RWKV6,
                                split=trained["split"])
    trained_zoo = phase_train_zoo(torch, mods, dev)
    kimi = phase_kimi(torch, mods, dev)
    examples = phase_examples(torch, mods, dev, apply_ok, propose_ok,
                              float_ok)
    torch.cuda.synchronize()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    sources = {"paxos_apply": ("src/repro_torch/csrc/paxos_apply.cu",
                               "src/repro/kernels/paxos_apply/kernel.py:38",
                               "_paxos_apply_kernel", apply_ok),
               "paxos_propose": ("src/repro_torch/csrc/paxos_propose.cu",
                                 "src/repro/kernels/paxos_propose/kernel.py:45",
                                 "_paxos_propose_kernel", propose_ok)}
    kernels = []
    for name, (src, replaces, fn, agree) in sources.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "replaces_function": fn,
            "launches": launches[name], "mismatches": agree.mismatches,
            "max_abs_err": agree.max_abs_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "train_launches": trained["launches"][name],
            "train_rwkv6_launches": trained_rwkv6["launches"][name],
            "kimi_engine_launches": kimi["engine"][name],
            "smoke_launches": smokes["launches"][name],
            "serve_mesh_launches": serve_mesh["launches"][name],
            "examples_launches": examples["launches"][name],
            "dense_engine_launches": {
                m: dense["engines"][m][name] for m in dense["engines"]}})
    # each float kernel's launches: its model's main path (the f32 prefill)
    model_launches = {"flash_attention": zamba_launches["flash_attention"],
                      "mamba2_ssd": zamba_launches["mamba2_ssd"],
                      "rwkv6_wkv": rwkv_launches["rwkv6_wkv"]}
    model_sources = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:34",
                            "_fa_kernel"),
        "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd/kernel.py:36",
                       "_ssd_kernel"),
        "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                      "src/repro/kernels/rwkv6_wkv/kernel.py:31",
                      "_wkv6_kernel")}
    for name, (src, replaces, fn) in model_sources.items():
        t, agree = times[name], float_ok[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "replaces_function": fn,
            "launches": model_launches[name],
            "max_abs_err": agree.max_abs_err,
            "max_rel_err": agree.max_rel_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if trained["launches"][name]:
            kernels[-1]["train_launches"] = trained["launches"][name]
        if trained_rwkv6["launches"][name]:
            kernels[-1]["train_rwkv6_launches"] = \
                trained_rwkv6["launches"][name]
    # the zoo's paths: each f32 prefill (and whisper's decode step) run
    # from 0, and the kernel's device time a call in each bf16 prefill
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    fa["zoo_launches"] = {
        "mixtral_prefill": zoo["mixtral"]["flash_attention"],
        "qwen2_vl_prefill": zoo["qwen2_vl"]["flash_attention"],
        "whisper_prefill": zoo["whisper"]["flash_attention"],
        "whisper_decode_step": zoo["whisper_decode"],
        "mixtral_shardmap_prefill": parallel["flash_attention"]}
    # [train_mesh]'s steps and [decode_mesh]'s prefill cells on the mesh,
    # on each rank's block: each float kernel's launches a rank by case,
    # and its first call (its block, its error against the plain version;
    # [decode_mesh]'s rank 0 also ms a call)
    for k in kernels:
        cases = {c: [r[k["name"]] for r in res["launches"]]
                 for c, res in train_mesh["cases"].items()
                 if k["name"] in res["launches"][0]}
        if cases:
            k["train_mesh_launches"] = cases
            k["train_mesh_first_call"] = {
                c: train_mesh["cases"][c]["kernels"][k["name"]]
                for c in cases}
        cases = {c: [r[k["name"]] for r in per]
                 for c, per in decode_mesh["launches"].items()
                 if k["name"] in per[0]}
        if cases:
            k["decode_mesh_launches"] = cases
            k["decode_mesh_rank0"] = {c: decode_mesh["kernels"][c][k["name"]]
                                      for c in cases}
    fa["examples_launches"] = {
        "serve_kvstore_prefill":
            examples["launches"]["flash_attention"]["serve_kvstore"],
        "train_fault_tolerant":
            examples["launches"]["flash_attention"]["train_fault_tolerant"]}
    fa["zoo_bf16_ms"] = {
        k: zoo[f"{k}_prefill"]["per_launch_ms"].get("flash_attention")
        for k in ("mixtral", "qwen2_vl", "whisper")}
    # the dense family's paths: each f32 prefill run from 0 (gemma3's and
    # its one-unit cut's, phi3's, qwen1.5's, qwen2.5's at its cut), and the
    # kernel's device time a call in each bf16 prefill
    fa["dense_launches"] = dense["launches"]
    fa["dense_bf16_ms"] = {
        m: r["per_launch_ms"].get("flash_attention")
        for m, r in dense["bf16"].items()}
    # the zoo's train steps (the gradient gate's run, forward + remat
    # recompute, and the AdamW steps), kimi-k2's f32 and bf16 prefills, and
    # each shape's bf16 time beside its bound and SDPA
    fa["train_zoo_launches"] = {
        m: {"gradient_gate": r["grad_launches"]["flash_attention"],
            "steps": r["step_launches"]["flash_attention"]}
        for m, r in trained_zoo.items()}
    fa["kimi_launches"] = {
        "f32_prefill": kimi["prefill"],
        "bf16_prefill": kimi["bf16"]["launches"]["flash_attention"]}
    fa["kimi_bf16_ms"] = kimi["bf16"]["per_launch_ms"].get("flash_attention")
    fa["bf16_shape_ms"] = {**dense["times"], **zoo_times}
    fa["float32_max_rel_err"] = float_ok["flash_attention"].float32_worst
    for name in ("mamba2_ssd", "rwkv6_wkv"):
        next(k for k in kernels if k["name"] == name)[
            "float32_max_rel_err"] = float_ok[name].float32_worst
    # float32, the train and mesh paths' type, at their shapes in one
    # process: each beside its bound (and SDPA for attention)
    for k in kernels:
        if k["name"] in f32_times:
            k["f32_shape_ms"] = f32_times[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
